from repro_torch.sharding.rules import ShardingPolicy  # noqa: F401
