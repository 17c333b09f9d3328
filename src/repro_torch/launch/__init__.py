"""The port's command line: ``python -m repro_torch.launch.fedzoo`` and the
flag surface it shares (``common``), ports of ``repro.launch``."""

__all__ = ["common", "fedzoo"]
