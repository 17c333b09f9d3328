"""minitron-8b [dense] -- pruned nemotron [arXiv:2407.14679].

32L d_model=4096 32H (GQA kv=8) d_ff=16384 vocab=256000.
Full attention -> long_500k skipped.
"""

import dataclasses

from repro_torch.models.config import ModelConfig

FULL = ModelConfig(
    name="minitron-8b",
    arch_type="dense",
    n_layers=32,
    d_model=4096,
    n_heads=32,
    n_kv_heads=8,
    head_dim=128,
    d_ff=16384,
    vocab_size=256000,
    source="arXiv:2407.14679",
)

SMOKE = dataclasses.replace(
    FULL,
    name="minitron-smoke",
    n_layers=2,
    d_model=128,
    n_heads=4,
    n_kv_heads=2,
    head_dim=32,
    d_ff=256,
    vocab_size=512,
)
