"""gemma-7b [dense] -- GeGLU, head_dim=256 [arXiv:2403.08295].

28L d_model=3072 16H (kv=16, i.e. MHA at 7B; MQA is the 2B variant)
d_ff=24576 vocab=256000.  Pure full attention -> long_500k skipped
(DESIGN.md Arch-applicability).
"""

import dataclasses

from repro_torch.models.config import ModelConfig

FULL = ModelConfig(
    name="gemma-7b",
    arch_type="dense",
    n_layers=28,
    d_model=3072,
    n_heads=16,
    n_kv_heads=16,
    head_dim=256,
    d_ff=24576,
    vocab_size=256000,
    mlp_act="geglu",
    tie_embeddings=True,
    source="arXiv:2403.08295",
)

SMOKE = dataclasses.replace(
    FULL,
    name="gemma-smoke",
    n_layers=2,
    d_model=128,
    n_heads=4,
    n_kv_heads=4,
    head_dim=32,
    d_ff=256,
    vocab_size=512,
)
