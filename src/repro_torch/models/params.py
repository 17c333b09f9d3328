"""Parameter declaration (port of ``repro.models.params``): one table of
(shape, logical shard axes, init kind) per architecture family.

Params are a FLAT dict ``{name: tensor}``.  Block-stacked params carry a
leading ``n_blocks`` dim and the prefix ``blocks/`` (iterated over in
models/model.py); encoder blocks use ``enc_blocks/``.  The names, shapes
and axes are the reference's, so carrying parameters across is a copy by
name (``repro_torch.convert.lm_params``).  The same table yields
``init_params`` (materialized tensors), ``param_shapes`` and
``count_params``; the axes wait for the mesh functions (ROADMAP Queue A,
A11).

``init_params`` draws leaf i of the sorted table from a CPU generator
seeded from ``(seed, 2, i)`` (``algorithms.stream_seed``), in float32, and
casts it to ``cfg.dtype`` as the reference's ``_init_leaf`` does; so the
card and the CPU start from the same numbers.  With ``device_draws`` the
generator of ``(seed, 2, i)`` lives on ``device`` and the leaf is drawn
there: the card's own numbers, for the full-width models whose CPU draw
takes minutes.  Torch cannot replay the reference's threefry keys: parity
comes from carrying its parameters across.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any

import torch

from repro_torch.core.algorithms import stream_seed
from repro_torch.device import resolve_device
from repro_torch.models.config import ModelConfig


@dataclasses.dataclass(frozen=True)
class ParamDef:
    shape: tuple[int, ...]
    axes: tuple[Any, ...]  # logical shard axes, len == len(shape)
    init: str  # normal | fan_in | zeros | ones | a_log | dt_bias


def _attn_defs(cfg: ModelConfig, lead: tuple[int, ...], prefix: str) -> dict[str, ParamDef]:
    d, q, kv = cfg.d_model, cfg.q_dim, cfg.kv_dim
    defs = {
        f"{prefix}ln": ParamDef(lead + (d,), (None,) * len(lead) + (None,), "ones"),
        f"{prefix}wq": ParamDef(lead + (d, q), (None,) * len(lead) + (None, "model"), "fan_in"),
        f"{prefix}wk": ParamDef(lead + (d, kv), (None,) * len(lead) + (None, "model"), "fan_in"),
        f"{prefix}wv": ParamDef(lead + (d, kv), (None,) * len(lead) + (None, "model"), "fan_in"),
        f"{prefix}wo": ParamDef(lead + (q, d), (None,) * len(lead) + ("model", None), "fan_in"),
    }
    if cfg.qkv_bias:
        defs |= {
            f"{prefix}bq": ParamDef(lead + (q,), (None,) * len(lead) + ("model",), "zeros"),
            f"{prefix}bk": ParamDef(lead + (kv,), (None,) * len(lead) + ("model",), "zeros"),
            f"{prefix}bv": ParamDef(lead + (kv,), (None,) * len(lead) + ("model",), "zeros"),
        }
    return defs


def _mlp_defs(cfg: ModelConfig, lead: tuple[int, ...], prefix: str) -> dict[str, ParamDef]:
    d, ff = cfg.d_model, cfg.d_ff
    nl = len(lead)
    if cfg.is_moe_mlp:
        e = cfg.n_experts
        defs = {
            f"{prefix}ln": ParamDef(lead + (d,), (None,) * nl + (None,), "ones"),
            f"{prefix}router": ParamDef(lead + (d, e), (None,) * nl + (None, None), "fan_in"),
            f"{prefix}we_gate": ParamDef(lead + (e, d, ff), (None,) * nl + ("model", None, None), "fan_in"),
            f"{prefix}we_up": ParamDef(lead + (e, d, ff), (None,) * nl + ("model", None, None), "fan_in"),
            f"{prefix}we_down": ParamDef(lead + (e, ff, d), (None,) * nl + ("model", None, None), "fan_in"),
        }
        if cfg.n_shared_experts:
            sf = ff * cfg.n_shared_experts
            defs |= {
                f"{prefix}ws_gate": ParamDef(lead + (d, sf), (None,) * nl + (None, "model"), "fan_in"),
                f"{prefix}ws_up": ParamDef(lead + (d, sf), (None,) * nl + (None, "model"), "fan_in"),
                f"{prefix}ws_down": ParamDef(lead + (sf, d), (None,) * nl + ("model", None), "fan_in"),
            }
        return defs
    return {
        f"{prefix}ln": ParamDef(lead + (d,), (None,) * nl + (None,), "ones"),
        f"{prefix}w_gate": ParamDef(lead + (d, ff), (None,) * nl + (None, "model"), "fan_in"),
        f"{prefix}w_up": ParamDef(lead + (d, ff), (None,) * nl + (None, "model"), "fan_in"),
        f"{prefix}w_down": ParamDef(lead + (ff, d), (None,) * nl + ("model", None), "fan_in"),
    }


def _ssm_defs(cfg: ModelConfig, lead: tuple[int, ...], prefix: str) -> dict[str, ParamDef]:
    d = cfg.d_model
    nl = len(lead)
    return {
        f"{prefix}ln": ParamDef(lead + (d,), (None,) * nl + (None,), "ones"),
        f"{prefix}in_proj": ParamDef(
            lead + (d, cfg.ssm_in_proj_dim), (None,) * nl + (None, "model"), "fan_in"
        ),
        f"{prefix}conv_w": ParamDef(
            lead + (cfg.ssm_conv, cfg.ssm_conv_channels), (None,) * nl + (None, "model"), "fan_in"
        ),
        f"{prefix}conv_b": ParamDef(
            lead + (cfg.ssm_conv_channels,), (None,) * nl + ("model",), "zeros"
        ),
        f"{prefix}a_log": ParamDef(lead + (cfg.ssm_heads,), (None,) * nl + ("model",), "a_log"),
        f"{prefix}d_skip": ParamDef(lead + (cfg.ssm_heads,), (None,) * nl + ("model",), "ones"),
        f"{prefix}dt_bias": ParamDef(lead + (cfg.ssm_heads,), (None,) * nl + ("model",), "dt_bias"),
        f"{prefix}out_norm": ParamDef(lead + (cfg.ssm_inner,), (None,) * nl + ("model",), "ones"),
        f"{prefix}out_proj": ParamDef(
            lead + (cfg.ssm_inner, d), (None,) * nl + ("model", None), "fan_in"
        ),
    }


def param_defs(cfg: ModelConfig) -> dict[str, ParamDef]:
    d, v = cfg.d_model, cfg.vocab_size
    nb = cfg.n_blocks
    defs: dict[str, ParamDef] = {
        "embed": ParamDef((v, d), ("model", None), "normal"),
        "final_norm": ParamDef((d,), (None,), "ones"),
    }
    if not cfg.tie_embeddings:
        defs["lm_head"] = ParamDef((d, v), (None, "model"), "fan_in")

    lead = (nb,)
    if cfg.arch_type == "ssm":
        defs |= _ssm_defs(cfg, lead, "blocks/")
    elif cfg.arch_type == "hybrid":
        # Super-block = 1 attention layer + (attn_every - 1) mamba layers,
        # every layer followed by the (MoE) MLP.
        n_ssm = cfg.attn_every - 1
        defs |= _attn_defs(cfg, lead, "blocks/attn.")
        defs |= _ssm_defs(cfg, lead + (n_ssm,), "blocks/ssm.")
        defs |= _mlp_defs(cfg, lead + (cfg.attn_every,), "blocks/mlp.")
    elif cfg.arch_type == "encdec":
        defs |= _attn_defs(cfg, lead, "blocks/self.")
        defs |= _attn_defs(cfg, lead, "blocks/cross.")
        defs |= _mlp_defs(cfg, lead, "blocks/mlp.")
        enc_lead = (cfg.n_enc_layers,)
        defs |= _attn_defs(cfg, enc_lead, "enc_blocks/attn.")
        defs |= _mlp_defs(cfg, enc_lead, "enc_blocks/mlp.")
        defs["enc_norm"] = ParamDef((d,), (None,), "ones")
        defs["enc_pos"] = ParamDef((cfg.enc_seq, d), (None, None), "normal")
        defs["dec_pos"] = ParamDef((cfg.dec_pos_len, d), (None, None), "normal")
    else:  # dense | moe | vlm
        defs |= _attn_defs(cfg, lead, "blocks/attn.")
        defs |= _mlp_defs(cfg, lead, "blocks/mlp.")
    return defs


# -- materialization ----------------------------------------------------------


def _init_leaf(gen: torch.Generator, pd: ParamDef, dtype: torch.dtype) -> torch.Tensor:
    """One leaf drawn from ``gen`` on its device in float32, cast to
    ``dtype`` (the draws scaled in place: a full-width expert leaf is
    gigabytes)."""
    f32, dev = torch.float32, gen.device
    if pd.init == "zeros":
        return torch.zeros(pd.shape, dtype=dtype, device=dev)
    if pd.init == "ones":
        return torch.ones(pd.shape, dtype=dtype, device=dev)
    if pd.init == "normal":
        return torch.randn(pd.shape, generator=gen, dtype=f32, device=dev).mul_(0.02).to(dtype)
    if pd.init == "fan_in":
        fan_in = pd.shape[-2] if len(pd.shape) >= 2 else pd.shape[-1]
        scale = 1.0 / math.sqrt(max(fan_in, 1))
        return torch.randn(pd.shape, generator=gen, dtype=f32, device=dev).mul_(scale).to(dtype)
    if pd.init == "a_log":
        # A in [1, 16] as in Mamba2; stored as log(A), used as -exp(a_log).
        u = 1.0 + 15.0 * torch.rand(pd.shape, generator=gen, dtype=f32, device=dev)
        return torch.log(u).to(dtype)
    if pd.init == "dt_bias":
        # dt in [1e-3, 1e-1] through softplus-inverse.
        u = 1e-3 + (1e-1 - 1e-3) * torch.rand(pd.shape, generator=gen, dtype=f32, device=dev)
        return torch.log(torch.expm1(u)).to(dtype)
    raise ValueError(pd.init)


def init_params(seed: int, cfg: ModelConfig, device: str | torch.device = "cuda",
                device_draws: bool = False) -> dict[str, torch.Tensor]:
    """Every leaf of ``param_defs(cfg)`` in ``cfg.dtype`` on ``device``; leaf
    i of the sorted table from the generator of ``(seed, 2, i)``, on the
    CPU (the default: the same numbers on every device) or, with
    ``device_draws``, on ``device``.  No leaf requires a gradient."""
    device = resolve_device(device)
    dtype = cfg.torch_dtype
    where = device if device_draws else torch.device("cpu")
    out = {}
    for i, (name, pd) in enumerate(sorted(param_defs(cfg).items())):
        gen = torch.Generator(device=where).manual_seed(stream_seed(seed, 2, i))
        out[name] = _init_leaf(gen, pd, dtype).to(device)
    return out


def param_shapes(cfg: ModelConfig) -> dict[str, tuple[tuple[int, ...], torch.dtype]]:
    """Each leaf's (shape, dtype), with nothing allocated."""
    dtype = cfg.torch_dtype
    return {n: (pd.shape, dtype) for n, pd in param_defs(cfg).items()}


def count_params(cfg: ModelConfig) -> int:
    return sum(math.prod(pd.shape) for pd in param_defs(cfg).values())
