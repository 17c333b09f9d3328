"""mamba2-370m [ssm] -- SSD (state-space duality) [arXiv:2405.21060].

48L d_model=1024 (attention-free) vocab=50280, ssm_state=128.
d_inner = 2*d_model = 2048, head_dim 64 -> 32 SSD heads.  O(L) decode makes
long_500k native for this arch.
"""

import dataclasses

from repro_torch.models.config import ModelConfig

FULL = ModelConfig(
    name="mamba2-370m",
    arch_type="ssm",
    n_layers=48,
    d_model=1024,
    n_heads=0,
    n_kv_heads=0,
    d_ff=0,
    vocab_size=50280,
    ssm_state=128,
    ssm_head_dim=64,
    ssm_expand=2,
    ssm_conv=4,
    ssm_chunk=256,
    tie_embeddings=True,
    rope_mode="none",
    supports_long_context=True,
    source="arXiv:2405.21060",
)

SMOKE = dataclasses.replace(
    FULL,
    name="mamba2-smoke",
    n_layers=2,
    d_model=128,
    vocab_size=512,
    ssm_state=16,
    ssm_head_dim=32,
    ssm_chunk=32,
)
