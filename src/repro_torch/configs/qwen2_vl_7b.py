"""qwen2-vl-7b [vlm] -- M-RoPE, dynamic resolution [arXiv:2409.12191].

28L d_model=3584 28H (GQA kv=4) d_ff=18944 vocab=152064.
The ViT/projector frontend is a STUB: input_specs supplies precomputed patch
embeddings (B, n_patches, d_model) merged into the first token positions;
M-RoPE rotates with (t, h, w) position triples split (16, 24, 24) across
frequency slots.  Full attention -> long_500k skipped.
"""

import dataclasses

from repro_torch.models.config import ModelConfig

FULL = ModelConfig(
    name="qwen2-vl-7b",
    arch_type="vlm",
    n_layers=28,
    d_model=3584,
    n_heads=28,
    n_kv_heads=4,
    head_dim=128,
    d_ff=18944,
    vocab_size=152064,
    qkv_bias=True,
    rope_mode="mrope",
    mrope_sections=(16, 24, 24),
    rope_theta=1_000_000.0,
    n_patches=1024,  # stub patch-embedding count
    source="arXiv:2409.12191",
)

SMOKE = dataclasses.replace(
    FULL,
    name="qwen2-vl-smoke",
    n_layers=2,
    d_model=128,
    n_heads=4,
    n_kv_heads=2,
    head_dim=32,
    d_ff=256,
    vocab_size=512,
    n_patches=16,
    mrope_sections=(4, 6, 6),  # head_dim 32 -> 16 frequency slots
)
