"""qwen1.5-0.5b [dense] -- QKV bias [hf:Qwen/Qwen1.5-0.5B].

24L d_model=1024 16H (kv=16) d_ff=2816 vocab=151936.
Full attention -> long_500k skipped.
"""

import dataclasses

from repro_torch.models.config import ModelConfig

FULL = ModelConfig(
    name="qwen1.5-0.5b",
    arch_type="dense",
    n_layers=24,
    d_model=1024,
    n_heads=16,
    n_kv_heads=16,
    head_dim=64,
    d_ff=2816,
    vocab_size=151936,
    qkv_bias=True,
    tie_embeddings=True,
    source="hf:Qwen/Qwen1.5-0.5B",
)

SMOKE = dataclasses.replace(
    FULL,
    name="qwen1.5-smoke",
    n_layers=2,
    d_model=128,
    n_heads=4,
    n_kv_heads=4,
    head_dim=32,
    d_ff=256,
    vocab_size=512,
)
