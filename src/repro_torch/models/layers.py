"""Transformer layer primitives (port of ``repro.models.layers``, the dense
path): RMSNorm, RoPE, GQA attention (full and query-chunked) and the gated
MLPs.  M-RoPE and the MoE layer come with the moe and vlm families
(ROADMAP Queue A, A13b), cached decode with A13c.

Conventions, as the reference's:
* activations are in the config dtype (bf16 for the published configs);
  norms, RoPE, the attention scores and softmax run in float32 (in float64
  where the inputs are float64: ``_wide``);
* where the reference asks its einsum for a float32 result of bf16
  operands (``preferred_element_type``), the operands are widened first:
  a product of two bf16 numbers is exact in float32, so the sums are the
  reference's up to their order;
* attention params are stored flat ``(d, H*hd)``; heads are reshaped
  inside;
* ``window > 0`` applies a local (sliding) attention mask.

Every function is shape-static and reads nothing on the host, so it runs
inside a captured CUDA graph.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional

import torch
import torch.nn.functional as F

from repro_torch.models.config import ModelConfig


def _wide(x: torch.Tensor) -> torch.Tensor:
    """``x`` in float32, or in its own type where that is wider."""
    return x.to(torch.promote_types(x.dtype, torch.float32))


def rmsnorm(x: torch.Tensor, scale: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    xf = _wide(x)
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    out = xf * torch.rsqrt(var + eps) * scale.to(xf.dtype)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# Rotary embeddings
# ---------------------------------------------------------------------------


def _rope_angles(positions: torch.Tensor, head_dim: int, theta: float,
                 dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """positions (...,) -> angles (..., head_dim//2)."""
    half = head_dim // 2
    inv_freq = theta ** (-torch.arange(0, half, dtype=dtype, device=positions.device) / half)
    return positions.to(dtype)[..., None] * inv_freq


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float,
               mode: str = "standard") -> torch.Tensor:
    """x (B, L, H, hd); positions (B, L).  ``mode`` ``standard`` rotates the
    two halves of each head (``jnp.split``'s halves, not an interleave);
    ``none`` returns x.  ``mrope`` comes with the vlm family (A13b)."""
    if mode == "none":
        return x
    if mode != "standard":
        raise NotImplementedError(f"rope mode {mode!r} comes with the vlm family "
                                  "(ROADMAP Queue A, A13b)")
    xf = _wide(x)
    ang = _rope_angles(positions, x.shape[-1], theta, xf.dtype)  # (B, L, half)
    cos = torch.cos(ang)[..., None, :]  # (B, L, 1, half)
    sin = torch.sin(ang)[..., None, :]
    x1, x2 = torch.chunk(xf, 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# GQA attention
# ---------------------------------------------------------------------------


def _split_heads(x: torch.Tensor, n_heads: int) -> torch.Tensor:
    b, l, _ = x.shape
    return x.reshape(b, l, n_heads, -1)


def repeat_groups(t: torch.Tensor, rep: int, dim: int) -> torch.Tensor:
    """``jnp.repeat(t, rep, axis=dim)``: each entry along ``dim`` repeated
    ``rep`` times in turn (``repeat_interleave``, not ``Tensor.repeat``),
    written as an expand and a copy, so the shapes are static."""
    if rep == 1:
        return t
    shape = list(t.shape)
    out = t.unsqueeze(dim + 1).expand(*shape[:dim + 1], rep, *shape[dim + 1:])
    return out.reshape(*shape[:dim], shape[dim] * rep, *shape[dim + 1:])


def _repeat_kv(k: torch.Tensor, n_heads: int) -> torch.Tensor:
    """(B, S, KV, hd) -> (B, S, H, hd) by group replication: query head h
    reads KV head h // (H / KV)."""
    return repeat_groups(k, n_heads // k.shape[2], 2)


def _attn_mask(q_len: int, kv_len: int, *, causal: bool, window: int, q_offset: int = 0,
               kv_valid: Optional[torch.Tensor] = None, device=None) -> torch.Tensor:
    """Boolean (q_len, kv_len) attention mask on ``device``."""
    qi = torch.arange(q_len, device=device)[:, None] + q_offset
    ki = torch.arange(kv_len, device=device)[None, :]
    mask = torch.ones((q_len, kv_len), dtype=torch.bool, device=device)
    if causal:
        mask &= ki <= qi
    if window > 0:
        mask &= ki > qi - window
    if kv_valid is not None:
        mask &= kv_valid[None, :]
    return mask


def _scores(q: torch.Tensor, k: torch.Tensor) -> torch.Tensor:
    """(B, L, H, hd) x (B, S, H, hd) -> scaled scores (B, H, L, S) in float32
    (or wider): the operands widened first, then divided by sqrt(hd)."""
    scores = torch.einsum("blhd,bshd->bhls", _wide(q), _wide(k))
    return scores / math.sqrt(q.shape[-1])


def attention_chunked(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *, causal: bool,
                      window: int, chunk: int) -> torch.Tensor:
    """Query-chunked attention: a loop over the L/chunk query blocks (a
    static count), so the score matrix is only (B, H, chunk, S) at a time.
    Semantics identical to ``attention_core`` with a causal/window mask."""
    b, l, h, hd = q.shape
    s = k.shape[1]
    assert l % chunk == 0, (l, chunk)
    kr = _repeat_kv(k, h)
    vr = _repeat_kv(v, h)
    ki = torch.arange(s, device=q.device)[None, :]
    outs = []
    for off in range(0, l, chunk):
        qb = q[:, off:off + chunk]
        scores = _scores(qb, kr)
        qi = torch.arange(chunk, device=q.device)[:, None] + off
        m = torch.ones((chunk, s), dtype=torch.bool, device=q.device)
        if causal:
            m &= ki <= qi
        if window > 0:
            m &= ki > qi - window
        scores = torch.where(m, scores, -1e30)
        probs = torch.softmax(scores, dim=-1)
        outs.append(torch.einsum("bhls,bshd->blhd", probs.to(qb.dtype), vr))
    return torch.cat(outs, dim=1)


def attention_core(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, mask: torch.Tensor,
                   softcap: float = 0.0) -> torch.Tensor:
    """q (B, Lq, H, hd), k and v (B, S, KV, hd), mask broadcastable to
    (B, H, Lq, S) -> (B, Lq, H, hd) in q's dtype."""
    h = q.shape[2]
    kr = _repeat_kv(k, h)
    vr = _repeat_kv(v, h)
    scores = _scores(q, kr)
    if softcap > 0.0:
        scores = softcap * torch.tanh(scores / softcap)
    scores = torch.where(mask, scores, -1e30)
    probs = torch.softmax(scores, dim=-1)
    return torch.einsum("bhls,bshd->blhd", probs.to(q.dtype), vr)


class AttnParams(NamedTuple):
    ln: torch.Tensor
    wq: torch.Tensor
    wk: torch.Tensor
    wv: torch.Tensor
    wo: torch.Tensor
    bq: Optional[torch.Tensor] = None
    bk: Optional[torch.Tensor] = None
    bv: Optional[torch.Tensor] = None


def pick_attn(p: dict, prefix: str) -> AttnParams:
    return AttnParams(
        ln=p[f"{prefix}ln"],
        wq=p[f"{prefix}wq"],
        wk=p[f"{prefix}wk"],
        wv=p[f"{prefix}wv"],
        wo=p[f"{prefix}wo"],
        bq=p.get(f"{prefix}bq"),
        bk=p.get(f"{prefix}bk"),
        bv=p.get(f"{prefix}bv"),
    )


def _project_qkv(ap: AttnParams, x: torch.Tensor, cfg: ModelConfig):
    xn = rmsnorm(x, ap.ln, cfg.norm_eps)
    q = xn @ ap.wq
    k = xn @ ap.wk
    v = xn @ ap.wv
    if ap.bq is not None:
        q = q + ap.bq
        k = k + ap.bk
        v = v + ap.bv
    return (
        _split_heads(q, cfg.n_heads),
        _split_heads(k, cfg.n_kv_heads),
        _split_heads(v, cfg.n_kv_heads),
    )


def attn_block(ap: AttnParams, x: torch.Tensor, cfg: ModelConfig, positions: torch.Tensor, *,
               causal: bool = True, window: int = 0, chunk: int = 0) -> torch.Tensor:
    """Full-sequence self-attention on the residual stream x (B, L, d).
    Returns the residual delta (the caller adds).  ``chunk > 0`` takes the
    query-chunked form when L is a multiple of it and at least twice it.
    Cross-attention comes with the encoder-decoder family."""
    q, k, v = _project_qkv(ap, x, cfg)
    q = apply_rope(q, positions, cfg.rope_theta, cfg.rope_mode)
    k = apply_rope(k, positions, cfg.rope_theta, cfg.rope_mode)
    if chunk > 0 and q.shape[1] % chunk == 0 and q.shape[1] >= 2 * chunk:
        out = attention_chunked(q, k, v, causal=causal, window=window, chunk=chunk)
    else:
        mask = _attn_mask(q.shape[1], k.shape[1], causal=causal, window=window,
                          device=x.device)
        out = attention_core(q, k, v, mask)
    out = out.reshape(out.shape[0], out.shape[1], -1)
    return out @ ap.wo


# ---------------------------------------------------------------------------
# Gated MLP
# ---------------------------------------------------------------------------


def _act(name: str, x: torch.Tensor) -> torch.Tensor:
    if name == "swiglu":
        return F.silu(x)
    if name == "geglu":
        return F.gelu(x, approximate="tanh")
    raise ValueError(name)


def mlp_block(p: dict, prefix: str, x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """Gated MLP (swiglu / geglu).  Returns the residual delta."""
    xn = rmsnorm(x, p[f"{prefix}ln"], cfg.norm_eps)
    gate = xn @ p[f"{prefix}w_gate"]
    up = xn @ p[f"{prefix}w_up"]
    h = _act(cfg.mlp_act, gate) * up
    return h @ p[f"{prefix}w_down"]
