"""llama4-maverick-400b-a17b [moe] -- MoE, early fusion.

48L d_model=5120 40H (GQA kv=8) d_ff=8192 vocab=202048, MoE 128e top-1 with a
shared expert.  Llama-4 uses chunked local attention (iRoPE) on most layers,
which we realize as a sliding window -- this is what makes long_500k decode
sub-quadratic for this arch.  [hf:meta-llama/Llama-4-Scout-17B-16E]
"""

import dataclasses

from repro_torch.models.config import ModelConfig

FULL = ModelConfig(
    name="llama4-maverick-400b-a17b",
    arch_type="moe",
    n_layers=48,
    d_model=5120,
    n_heads=40,
    n_kv_heads=8,
    head_dim=128,
    d_ff=8192,
    vocab_size=202048,
    n_experts=128,
    moe_top_k=1,
    n_shared_experts=1,
    sliding_window=8192,  # chunked/local attention (iRoPE-style)
    rope_theta=500_000.0,
    supports_long_context=True,
    source="hf:meta-llama/Llama-4-Scout-17B-16E (maverick sibling card)",
)

SMOKE = dataclasses.replace(
    FULL,
    name="llama4-maverick-smoke",
    n_layers=2,
    d_model=128,
    n_heads=4,
    n_kv_heads=2,
    head_dim=32,
    d_ff=256,
    vocab_size=512,
    n_experts=4,
    sliding_window=64,
)
