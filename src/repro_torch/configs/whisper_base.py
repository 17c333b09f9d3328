"""whisper-base [audio] -- enc-dec transformer backbone [arXiv:2212.04356].

6L (x2: 6 encoder + 6 decoder) d_model=512 8H (kv=8) d_ff=2048 vocab=51865.
The mel-spectrogram + conv frontend is a STUB: input_specs supplies
precomputed frame embeddings (B, 1500, d_model).  Learned positions, no rope.
Enc-dec (not encoder-only) -> decode_32k IS lowered; long_500k skipped
(quadratic decoder attention, 1.5k-frame encoder bound).
"""

import dataclasses

from repro_torch.models.config import ModelConfig

FULL = ModelConfig(
    name="whisper-base",
    arch_type="encdec",
    n_layers=6,
    n_enc_layers=6,
    d_model=512,
    n_heads=8,
    n_kv_heads=8,
    head_dim=64,
    d_ff=2048,
    vocab_size=51865,
    mlp_act="geglu",
    rope_mode="none",
    enc_seq=1500,
    frontend_dim=512,
    dec_pos_len=32768,  # decode_32k cache length
    source="arXiv:2212.04356",
)

SMOKE = dataclasses.replace(
    FULL,
    name="whisper-smoke",
    n_layers=2,
    n_enc_layers=2,
    d_model=128,
    n_heads=4,
    n_kv_heads=4,
    head_dim=32,
    d_ff=256,
    vocab_size=512,
    enc_seq=64,
    frontend_dim=128,
    dec_pos_len=256,
)
