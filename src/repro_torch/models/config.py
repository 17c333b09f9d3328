"""Architecture configuration for the model zoo (port of
``repro.models.config``).

One frozen dataclass drives every family (dense / moe / ssm / hybrid /
encdec-audio / vlm).  Fields unused by a family stay at their zero default.
Configs for the ten assigned architectures live in ``repro_torch/configs/``.
The fields, their defaults, the derived sizes and the analytic counts are
the reference's; ``torch_dtype`` maps ``dtype`` to the torch dtype of the
parameters and activations.
"""

from __future__ import annotations

import dataclasses

import torch

#: ``ModelConfig.dtype`` -> torch dtype.
DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32, "float64": torch.float64}


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    arch_type: str  # dense | moe | ssm | hybrid | encdec | vlm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0  # 0 -> d_model // n_heads

    # attention / embedding details
    mlp_act: str = "swiglu"  # swiglu | geglu
    qkv_bias: bool = False
    rope_theta: float = 10_000.0
    rope_mode: str = "standard"  # standard | mrope | none
    sliding_window: int = 0  # 0 = full attention; >0 = local window (decode)
    tie_embeddings: bool = False
    norm_eps: float = 1e-5
    logit_softcap: float = 0.0

    # MoE
    n_experts: int = 0
    moe_top_k: int = 0
    n_shared_experts: int = 0
    moe_capacity_factor: float = 1.25
    router_aux_weight: float = 0.01

    # SSM (Mamba2 / SSD)
    ssm_state: int = 0
    ssm_head_dim: int = 64
    ssm_expand: int = 2
    ssm_conv: int = 4
    ssm_chunk: int = 256
    ssm_groups: int = 1

    # hybrid (jamba-style): one attention layer every `attn_every` layers
    attn_every: int = 0

    # encoder-decoder (whisper backbone; conv/mel frontend is a stub)
    n_enc_layers: int = 0
    enc_seq: int = 1500  # whisper frame positions after conv frontend
    frontend_dim: int = 0  # stub embedding dim (== d_model for whisper)
    dec_pos_len: int = 8192  # learned decoder position table size

    # vlm (qwen2-vl backbone; ViT frontend is a stub)
    n_patches: int = 0  # stub patch-embedding count for input_specs
    mrope_sections: tuple[int, ...] = (16, 24, 24)  # qwen2-vl t/h/w split

    # numerics
    dtype: str = "bfloat16"

    # capability flags
    supports_long_context: bool = False  # sub-quadratic decode available?
    has_decoder: bool = True  # encoder-only archs would be False

    # provenance
    source: str = ""  # citation for the config numbers

    def __post_init__(self):
        if self.arch_type not in ("dense", "moe", "ssm", "hybrid", "encdec", "vlm"):
            raise ValueError(f"bad arch_type {self.arch_type}")
        if self.arch_type in ("moe",) and self.n_experts <= 0:
            raise ValueError("moe arch needs n_experts")
        if self.arch_type == "hybrid" and self.attn_every <= 0:
            raise ValueError("hybrid arch needs attn_every")

    # -- derived sizes -------------------------------------------------------

    @property
    def torch_dtype(self) -> torch.dtype:
        """The torch dtype of ``dtype`` (``bfloat16``, ``float32``, ``float64``)."""
        try:
            return DTYPES[self.dtype]
        except KeyError:
            raise ValueError(f"unsupported dtype {self.dtype!r}; one of {sorted(DTYPES)}") from None

    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim or (self.d_model // max(self.n_heads, 1))

    @property
    def q_dim(self) -> int:
        return self.n_heads * self.resolved_head_dim

    @property
    def kv_dim(self) -> int:
        return self.n_kv_heads * self.resolved_head_dim

    @property
    def ssm_inner(self) -> int:
        return self.ssm_expand * self.d_model

    @property
    def ssm_heads(self) -> int:
        return self.ssm_inner // self.ssm_head_dim

    @property
    def ssm_conv_channels(self) -> int:
        # conv runs over [x | B | C] streams as in Mamba2
        return self.ssm_inner + 2 * self.ssm_groups * self.ssm_state

    @property
    def ssm_in_proj_dim(self) -> int:
        # [z | x | B | C | dt]
        return 2 * self.ssm_inner + 2 * self.ssm_groups * self.ssm_state + self.ssm_heads

    @property
    def is_moe_mlp(self) -> bool:
        return self.n_experts > 0

    @property
    def n_blocks(self) -> int:
        """Scan length.  Hybrids scan super-blocks of `attn_every` layers."""
        if self.arch_type == "hybrid":
            assert self.n_layers % self.attn_every == 0
            return self.n_layers // self.attn_every
        return self.n_layers

    @property
    def block_kind(self) -> str:
        if self.arch_type == "ssm":
            return "ssm"
        if self.arch_type == "hybrid":
            return "hybrid"
        return "attn"

    def param_count(self) -> int:
        """Analytic parameter count (used for 6*N*D roofline bookkeeping)."""
        d, ff, v = self.d_model, self.d_ff, self.vocab_size
        emb = v * d * (1 if self.tie_embeddings else 2)
        attn = d * self.q_dim + 2 * d * self.kv_dim + self.q_dim * d

        if self.is_moe_mlp:
            mlp = self.n_experts * 3 * d * ff + d * self.n_experts
            mlp += self.n_shared_experts * 3 * d * ff
        else:
            mlp = 3 * d * ff

        ssm = (
            d * self.ssm_in_proj_dim
            + self.ssm_conv * self.ssm_conv_channels
            + 3 * self.ssm_heads
            + self.ssm_inner
            + self.ssm_inner * d
        )

        norms = 2 * d
        if self.arch_type == "ssm":
            per_layer = ssm + norms  # mamba2 blocks have no separate MLP
            total = self.n_layers * per_layer
        elif self.arch_type == "hybrid":
            n_attn = self.n_layers // self.attn_every
            n_ssm = self.n_layers - n_attn
            total = n_attn * (attn + mlp + norms) + n_ssm * (ssm + mlp + norms)
        elif self.arch_type == "encdec":
            dec = self.n_layers * (attn + attn + mlp + 3 * d)  # self+cross
            enc = self.n_enc_layers * (attn + mlp + norms)
            total = dec + enc
        else:
            total = self.n_layers * (attn + mlp + norms)
        return int(total + emb + d)

    def active_param_count(self) -> int:
        """Active params per token (MoE: top_k + shared experts only)."""
        if not self.is_moe_mlp:
            return self.param_count()
        d, ff = self.d_model, self.d_ff
        # subtract the inactive experts: each MLP site keeps top_k + shared.
        per_site_full = self.n_experts * 3 * d * ff
        per_site_active = (self.moe_top_k + self.n_shared_experts) * 3 * d * ff
        n_sites = self.n_layers  # every layer has an MLP in moe/hybrid archs
        return int(self.param_count() - n_sites * (per_site_full - per_site_active))
