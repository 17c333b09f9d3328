"""yi-34b [dense] -- llama-arch GQA [arXiv:2403.04652].

60L d_model=7168 56H (GQA kv=8) d_ff=20480 vocab=64000.
Full attention -> long_500k skipped.  56 heads do not divide the 16-way
model axis; projections are sharded on the flat H*hd dim (7168 % 16 == 0),
see DESIGN.md Sec. 6.
"""

import dataclasses

from repro_torch.models.config import ModelConfig

FULL = ModelConfig(
    name="yi-34b",
    arch_type="dense",
    n_layers=60,
    d_model=7168,
    n_heads=56,
    n_kv_heads=8,
    head_dim=128,
    d_ff=20480,
    vocab_size=64000,
    rope_theta=5_000_000.0,
    source="arXiv:2403.04652",
)

SMOKE = dataclasses.replace(
    FULL,
    name="yi-smoke",
    n_layers=2,
    d_model=128,
    n_heads=4,
    n_kv_heads=2,
    head_dim=32,
    d_ff=256,
    vocab_size=512,
)
