"""Transformer layer primitives (port of ``repro.models.layers``): RMSNorm,
RoPE and M-RoPE, GQA attention (full, query-chunked, cross and cached
one-token decode), the gated MLPs and the MoE layer.

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


def _mrope_angles(positions3: torch.Tensor, head_dim: int, theta: float,
                  sections: tuple[int, ...], dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """Qwen2-VL M-RoPE: positions3 (..., 3) t/h/w -> angles (..., half).  The
    half-dim frequency slots are split into ``sections`` (t, h, w); each slot
    rotates by the position component of its section [arXiv:2409.12191].
    The components are spread over their slots by an expand (static
    shapes, no index tensor copied from the host)."""
    half = head_dim // 2
    assert sum(sections) == half, (sections, half)
    inv_freq = theta ** (-torch.arange(0, half, dtype=dtype, device=positions3.device) / half)
    pos = positions3.to(dtype)
    per_slot = torch.cat([pos[..., i:i + 1].expand(*pos.shape[:-1], s)
                          for i, s in enumerate(sections)], dim=-1)  # (..., half)
    return per_slot * inv_freq


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float,
               mode: str = "standard", sections: tuple[int, ...] = (16, 24, 24)) -> torch.Tensor:
    """x (B, L, H, hd); positions (B, L), or (B, L, 3) for ``mrope``.  The
    ``standard`` and ``mrope`` modes rotate the two halves of each head
    (``jnp.split``'s halves, not an interleave) by float32 angles; ``none``
    returns x."""
    if mode == "none":
        return x
    xf = _wide(x)
    if mode == "mrope":
        ang = _mrope_angles(positions, x.shape[-1], theta, sections, xf.dtype)  # (B, L, half)
    else:
        ang = _rope_angles(positions, x.shape[-1], theta, xf.dtype)
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


def _project_qkv(ap: AttnParams, x: torch.Tensor, cfg: ModelConfig, kv: bool = True):
    """The normed stream's query heads and, with ``kv``, its key and value
    heads (cross-attention takes the encoder's: (q, None, None))."""
    xn = rmsnorm(x, ap.ln, cfg.norm_eps)
    q = xn @ ap.wq
    if ap.bq is not None:
        q = q + ap.bq
    if not kv:
        return _split_heads(q, cfg.n_heads), None, None
    k = xn @ ap.wk
    v = xn @ ap.wv
    if ap.bk is not None:
        k = k + ap.bk
        v = v + ap.bv
    return (
        _split_heads(q, cfg.n_heads),
        _split_heads(k, cfg.n_kv_heads),
        _split_heads(v, cfg.n_kv_heads),
    )


def attn_block(ap: AttnParams, x: torch.Tensor, cfg: ModelConfig, positions: torch.Tensor, *,
               causal: bool = True, window: int = 0,
               cross_kv: Optional[tuple[torch.Tensor, torch.Tensor]] = None, chunk: int = 0,
               return_kv: bool = False):
    """Full-sequence attention on the residual stream x (B, L, d) (train,
    prefill, the encoder).  Returns the residual delta (the caller adds);
    with ``return_kv`` also the layer's key heads after RoPE and its value
    heads (B, L, KV, hd), the K/V a prefill caches.  ``cross_kv`` (the
    encoder's key and value heads (B, S, KV, hd)) makes it cross-attention:
    no RoPE and every key visible.  ``chunk > 0`` takes the query-chunked
    form when L is a multiple of it and at least twice it."""
    q, k, v = _project_qkv(ap, x, cfg, kv=cross_kv is None)
    if cross_kv is not None:
        k, v = cross_kv
        mask = torch.ones((q.shape[1], k.shape[1]), dtype=torch.bool, device=x.device)
        out = attention_core(q, k, v, mask)
    else:
        q = apply_rope(q, positions, cfg.rope_theta, cfg.rope_mode, cfg.mrope_sections)
        k = apply_rope(k, positions, cfg.rope_theta, cfg.rope_mode, cfg.mrope_sections)
        if chunk > 0 and q.shape[1] % chunk == 0 and q.shape[1] >= 2 * chunk:
            out = attention_chunked(q, k, v, causal=causal, window=window, chunk=chunk)
        else:
            mask = _attn_mask(q.shape[1], k.shape[1], causal=causal, window=window,
                              device=x.device)
            out = attention_core(q, k, v, mask)
    out = out.reshape(out.shape[0], out.shape[1], -1) @ ap.wo
    return (out, k, v) if return_kv else out


def attn_decode(ap: AttnParams, x: torch.Tensor, cfg: ModelConfig, k_cache: torch.Tensor,
                v_cache: torch.Tensor, pos: torch.Tensor, *, window: int = 0,
                cross: bool = False) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """One-token cached attention: x (B, 1, d), caches (B, S, KV, hd), pos a
    0-d integer tensor (the token's position).  Returns (delta, k_cache,
    v_cache).  Self-attention applies RoPE at ``pos`` (M-RoPE: ``pos`` in
    all three components), writes the token's K/V into the caches in place
    at ``pos`` and attends to keys ``ki <= pos`` (and ``ki > pos - window``);
    the write index is clamped to S-1, as the reference's
    ``dynamic_update_slice`` clamps its start, the mask is not.  With
    ``cross`` the caches hold the encoder's K/V: every key visible, nothing
    written.  No host read: it runs inside a captured graph."""
    q, k, v = _project_qkv(ap, x, cfg, kv=not cross)
    s = k_cache.shape[1]
    if cross:
        mask = torch.ones((1, s), dtype=torch.bool, device=x.device)
    else:
        b = x.shape[0]
        posb = pos.expand(b, 1) if cfg.rope_mode != "mrope" else pos.expand(b, 1, 3)
        q = apply_rope(q, posb, cfg.rope_theta, cfg.rope_mode, cfg.mrope_sections)
        k = apply_rope(k, posb, cfg.rope_theta, cfg.rope_mode, cfg.mrope_sections)
        at = pos.clamp(0, s - 1).reshape(1)
        k_cache.index_copy_(1, at, k.to(k_cache.dtype))
        v_cache.index_copy_(1, at, v.to(v_cache.dtype))
        ki = torch.arange(s, device=x.device)
        mask = ki <= pos
        if window > 0:
            mask &= ki > pos - window
        mask = mask[None, :]
    out = attention_core(q, k_cache, v_cache, mask)
    return out.reshape(out.shape[0], 1, -1) @ ap.wo, k_cache, v_cache


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


# ---------------------------------------------------------------------------
# Mixture of Experts (capacity-based dispatch)
# ---------------------------------------------------------------------------


class Routing(NamedTuple):
    """One MoE layer's routing of G groups of t tokens, k slots a token; the
    slots run token-major, each token's k slots in top-k order."""
    probs: torch.Tensor  # (G, t, E) router probabilities, float32 (or wider)
    expert: torch.Tensor  # (G, t, k) int64: each token's experts, top-k order
    gate: torch.Tensor  # (G, t, k) the normalized gates, probs' dtype
    rank: torch.Tensor  # (G, t*k) int64: each slot's place in its expert's queue
    keep: torch.Tensor  # (G, t*k) bool: rank < capacity (the rest are dropped)
    capacity: int  # slots an expert, per group


def moe_capacity(cfg: ModelConfig, tokens: int) -> int:
    """Slots an expert for a group of ``tokens`` tokens (Python ints, as
    the reference's): int(max(cf * t * k / E, 4)) rounded up to a multiple
    of 4, at most t * k."""
    k = cfg.moe_top_k
    capacity = int(max(cfg.moe_capacity_factor * tokens * k / cfg.n_experts, 4))
    return min(capacity + (-capacity) % 4, tokens * k)


class Routes:
    """The routings of a forward's MoE layers in call order, handed in as
    ``forward``'s ``routes``: each layer appends its ``Routing``.  Given a
    ``pin`` (another forward's ``Routes`` over the same groups), each layer
    takes its experts from the pin's layer and computes its own gates,
    ranks and drops from them: a bf16 forward pinned to its float64 run's
    choices differs from it by rounding alone."""

    def __init__(self, pin: Optional["Routes"] = None):
        self.calls: list[Routing] = []
        self.pin = pin


#: The largest share (p_k - p_{k+1}) / p_k of a float64 run's k-th router
#: probability at which a bf16 run of the same forward may choose other
#: experts (``flip_margins``): the largest such margin measured over the
#: SMOKE MoE stacks, 0.0976 (jamba's forward, ``scripts/moe_flip_margins.py``),
#: raised to a power of two.
NEAR_TIE = 2.0 ** -3


def flip_margins(routes: Routes, routes64: Routes, length: int) -> torch.Tensor:
    """The margins (p_k - p_{k+1}) / p_k of the float64 run ``routes64`` at
    each token whose top-k choice the run ``routes`` of the same forward
    changes first: at no earlier position of its sequence did a layer
    change a choice or a drop (attention and the SSM carry a change to the
    later positions, and a group's drops to its other tokens).  A choice
    may change only at a near-tie (a margin at most ``NEAR_TIE``).  Raises
    if a drop changed where no choice of its group did."""
    moved = torch.zeros(routes.calls[0].expert.shape[:2], dtype=torch.bool).reshape(-1, length)
    margins = []
    for r, r64 in zip(routes.calls, routes64.calls, strict=True):
        expert, keep, expert64, keep64 = (a.cpu() for a in (r.expert, r.keep, r64.expert,
                                                             r64.keep))
        g, t, k = expert.shape
        # each token's experts and kept slots in expert order: a swap within
        # a token's top-k order changes neither (only the aux's top-1)
        (chosen, order), (chosen64, order64) = expert.sort(-1), expert64.sort(-1)
        flip = (chosen != chosen64).any(-1)
        dropped = (keep.reshape(g, t, k).gather(-1, order)
                   != keep64.reshape(g, t, k).gather(-1, order64)).any(-1)
        if not bool(flip.any(-1)[dropped.any(-1)].all()):
            raise AssertionError("a drop moved with no choice moved in its group")
        p = r64.probs.cpu().double().sort(-1, descending=True).values
        margin = ((p[..., k - 1] - p[..., k]) / p[..., k - 1]).reshape(-1, length)
        margins.append(margin[flip.reshape(-1, length) & ~moved])
        moved = torch.cummax((moved | (flip | dropped).reshape(-1, length)).int(),
                             dim=1).values.bool()
    return torch.cat(margins)


def moe_route(router: torch.Tensor, xt: torch.Tensor, cfg: ModelConfig,
              routes: Optional[Routes] = None) -> Routing:
    """The router over normed tokens xt (G, t, d), each group on its own:
    float32 logits, softmax, top-k of the probabilities (a stable
    descending sort: ties to the lower index, as ``lax.top_k``), the gates
    normalized by max(sum, 1e-9), and each slot's rank among the slots of
    its group that chose its expert before it.  With ``routes`` the
    routing is appended there, and where it has a pin the experts are the
    pin's."""
    g, t, _ = xt.shape
    k = cfg.moe_top_k
    probs = torch.softmax(_wide(xt) @ _wide(router), dim=-1)
    if routes is not None and routes.pin is not None:
        expert = routes.pin.calls[len(routes.calls)].expert.to(probs.device)
        gate = probs.gather(-1, expert)
    else:
        vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
        gate, expert = vals[..., :k], idx[..., :k]
    gate = gate / torch.clamp_min(gate.sum(-1, keepdim=True), 1e-9)
    slot_expert = expert.reshape(g, t * k)
    onehot = F.one_hot(slot_expert, cfg.n_experts)  # (G, t*k, E)
    rank = (torch.cumsum(onehot, dim=1) - onehot).gather(-1, slot_expert[..., None])[..., 0]
    capacity = moe_capacity(cfg, t)
    routing = Routing(probs, expert, gate, rank, rank < capacity, capacity)
    if routes is not None:
        routes.calls.append(routing)
    return routing


def moe_block(p: dict, prefix: str, x: torch.Tensor, cfg: ModelConfig, *,
              groups: int = 1, routes: Optional[Routes] = None
              ) -> tuple[torch.Tensor, torch.Tensor]:
    """Top-k MoE with per-expert capacity and dispatch, on x (B, L, d) split
    into ``groups`` equal groups of sequences along B: each group is routed,
    ranked, dropped and balanced on its own, as the reference's block on
    that group alone.  The kept slots of every group are placed in one
    (E, G*C, d) buffer, so the three expert GEMMs are one batched product
    each over all groups; slots beyond an expert's capacity are dropped
    (Switch-style); the shared experts (llama4) run densely.  Returns (the
    residual delta, the Switch load-balance loss of each group (G,)): the
    reference's block with ``return_aux``, as its model calls it.
    ``routes`` as ``moe_route``'s."""
    b, l, d = x.shape
    xn = rmsnorm(x, p[f"{prefix}ln"], cfg.norm_eps)
    g = groups
    t, k, e = b // g * l, cfg.moe_top_k, cfg.n_experts
    xt = xn.reshape(g, t, d)
    r = moe_route(p[f"{prefix}router"], xt, cfg, routes)
    c = r.capacity

    # each slot's row in the buffer: its expert's queue within its group
    # (a dropped slot reads rank 0, as the reference gathers it, and is
    # written to a spare last row, so every kept row has one writer)
    base = (r.expert.reshape(g, t * k) * (g * c)
            + torch.arange(g, device=x.device)[:, None] * c)
    row = base + torch.where(r.keep, r.rank, 0)
    dest = torch.where(r.keep, row, e * g * c)
    buf = xt.new_zeros((e * g * c + 1, d)).index_copy_(
        0, dest.reshape(-1), repeat_groups(xt, k, 1).reshape(-1, d))
    buf = buf[:-1].reshape(e, g * c, d)

    h = _act(cfg.mlp_act, torch.bmm(buf, p[f"{prefix}we_gate"])) * torch.bmm(
        buf, p[f"{prefix}we_up"])
    out_e = torch.bmm(h, p[f"{prefix}we_down"]).reshape(e * g * c, d)

    # combine: the gate cast to the activation dtype before the multiply
    gate = torch.where(r.keep, r.gate.reshape(g, t * k), 0.0).to(xt.dtype)
    y = (out_e[row] * gate[..., None]).reshape(g * t, k, d).sum(1)

    if cfg.n_shared_experts:
        xf = xt.reshape(g * t, d)
        sg = _act(cfg.mlp_act, xf @ p[f"{prefix}ws_gate"])
        y = y + (sg * (xf @ p[f"{prefix}ws_up"])) @ p[f"{prefix}ws_down"]

    # Switch-style load-balance auxiliary loss, per group
    frac_tokens = F.one_hot(r.expert[..., 0], e).to(r.probs.dtype).mean(1)
    frac_probs = r.probs.mean(1)
    return y.reshape(b, l, d), e * torch.sum(frac_tokens * frac_probs, dim=-1)
