"""jamba-1.5-large-398b [hybrid] -- Mamba+attention 1:7 interleave + MoE
[arXiv:2403.19887].

72L d_model=8192 64H (GQA kv=8) d_ff=24576 vocab=65536, MoE 16e top-2.
Scanned as 9 super-blocks of [1 attn + 7 mamba] layers, every layer with a
16-expert top-2 MoE MLP.  Mamba layers make long_500k O(L); the 9 attention
layers use a sliding window in long-context serving.
"""

import dataclasses

from repro_torch.models.config import ModelConfig

FULL = ModelConfig(
    name="jamba-1.5-large-398b",
    arch_type="hybrid",
    n_layers=72,
    attn_every=8,  # 1:7 attn:mamba
    d_model=8192,
    n_heads=64,
    n_kv_heads=8,
    head_dim=128,
    d_ff=24576,
    vocab_size=65536,
    n_experts=16,
    moe_top_k=2,
    ssm_state=128,
    ssm_head_dim=64,
    ssm_expand=2,
    ssm_conv=4,
    ssm_chunk=256,
    sliding_window=4096,  # attn layers go local in long-context serving
    supports_long_context=True,
    source="arXiv:2403.19887",
)

SMOKE = dataclasses.replace(
    FULL,
    name="jamba-smoke",
    n_layers=4,
    attn_every=4,
    d_model=128,
    n_heads=4,
    n_kv_heads=2,
    head_dim=32,
    d_ff=256,
    vocab_size=512,
    n_experts=4,
    ssm_state=16,
    ssm_head_dim=32,
    ssm_chunk=32,
    sliding_window=64,
)
