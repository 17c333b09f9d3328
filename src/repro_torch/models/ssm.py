"""Mamba2 / SSD (state-space duality) blocks [arXiv:2405.21060] (port of
``repro.models.ssm``).

The sequence runs through the chunked SSD algorithm: within-chunk
quadratic (attention-dual) products and an inter-chunk linear recurrence
over chunk states, O(L) in the sequence length.  The recurrence is a loop
over the chunks, whose count is static (the reference's ``lax.scan``).
Decode is the O(1) recurrent update h <- exp(dt*A) h + dt * B x^T on a
cache of the last K-1 conv inputs and the state, updated in place.

Layout: H = expand*d/headdim heads; B and C use ``ssm_groups`` groups
broadcast across heads (G=1 for mamba2).  As in ``layers``, the SSD
contractions widen bf16 operands to float32 before the product.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch
import torch.nn.functional as F

from repro_torch.device import resolve_device
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import _wide, repeat_groups, rmsnorm


class SsmParams(NamedTuple):
    ln: torch.Tensor
    in_proj: torch.Tensor  # (d, 2*din + 2*G*N + H)
    conv_w: torch.Tensor  # (K, conv_channels)
    conv_b: torch.Tensor  # (conv_channels,)
    a_log: torch.Tensor  # (H,)
    d_skip: torch.Tensor  # (H,)
    dt_bias: torch.Tensor  # (H,)
    out_norm: torch.Tensor  # (din,)
    out_proj: torch.Tensor  # (din, d)


def pick_ssm(p: dict, prefix: str) -> SsmParams:
    return SsmParams(
        ln=p[f"{prefix}ln"],
        in_proj=p[f"{prefix}in_proj"],
        conv_w=p[f"{prefix}conv_w"],
        conv_b=p[f"{prefix}conv_b"],
        a_log=p[f"{prefix}a_log"],
        d_skip=p[f"{prefix}d_skip"],
        dt_bias=p[f"{prefix}dt_bias"],
        out_norm=p[f"{prefix}out_norm"],
        out_proj=p[f"{prefix}out_proj"],
    )


def _split_in_proj(cfg: ModelConfig, zxbcdt: torch.Tensor):
    din = cfg.ssm_inner
    gn = cfg.ssm_groups * cfg.ssm_state
    z, xbc, dt = torch.split(zxbcdt, [din, din + 2 * gn, cfg.ssm_heads], dim=-1)
    return z, xbc, dt  # z (..., din), xbc (..., din+2GN), dt (..., H)


def _causal_conv_train(xbc: torch.Tensor, w: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Depthwise causal conv over seq.  xbc (B, L, C), w (K, C): the K
    shifted products summed in the input's dtype, as the reference's."""
    k = w.shape[0]
    pad = F.pad(xbc, (0, 0, k - 1, 0))
    out = torch.zeros_like(xbc)
    for i in range(k):
        out = out + pad[:, i:i + xbc.shape[1], :] * w[i]
    return F.silu(out + b)


def _segsum_decay(a_chunk: torch.Tensor) -> torch.Tensor:
    """a (B, C, Q, H) log-decays -> L (B, C, H, Q, Q) with
    L[q, s] = exp(sum_{i=s+1..q} a_i) for q >= s else 0."""
    q = a_chunk.shape[2]
    cum = torch.cumsum(a_chunk, dim=2)  # (B, C, Q, H)
    diff = cum[:, :, :, None, :] - cum[:, :, None, :, :]  # (B,C,Q,S,H): sum_{s+1..q}
    mask = torch.ones((q, q), dtype=torch.bool, device=a_chunk.device).tril()
    diff = diff.masked_fill(~mask[None, None, :, :, None], float("-inf"))
    return torch.exp(diff).permute(0, 1, 4, 2, 3)  # (B, C, H, Q, S)


def ssd_scan(
    cfg: ModelConfig,
    x: torch.Tensor,  # (B, L, H, P) inputs
    dt: torch.Tensor,  # (B, L, H) positive step sizes
    a: torch.Tensor,  # (H,) negative decay rates (-exp(a_log))
    bmat: torch.Tensor,  # (B, L, G, N)
    cmat: torch.Tensor,  # (B, L, G, N)
    h0: Optional[torch.Tensor] = None,  # (B, H, P, N) initial state
) -> tuple[torch.Tensor, torch.Tensor]:
    """Chunked SSD.  Returns (y (B,L,H,P) in x's dtype, final_state
    (B,H,P,N) in float32 or wider)."""
    bsz, l_orig, h, p = x.shape
    g, n = bmat.shape[2], bmat.shape[3]
    q = min(cfg.ssm_chunk, l_orig)
    # Pad the sequence to a chunk multiple (static shapes).  Padded steps
    # use dt = 0, i.e. identity decay and zero input: they change neither
    # outputs nor the final state.
    pad = (-l_orig) % q
    if pad:
        x = F.pad(x, (0, 0, 0, 0, 0, pad))
        dt = F.pad(dt, (0, 0, 0, pad))
        bmat = F.pad(bmat, (0, 0, 0, 0, 0, pad))
        cmat = F.pad(cmat, (0, 0, 0, 0, 0, pad))
    l = l_orig + pad
    c = l // q
    rep = h // g

    xr = x.reshape(bsz, c, q, h, p)
    dtr = dt.reshape(bsz, c, q, h)
    # each group repeated for its heads in turn (jnp.repeat)
    br = repeat_groups(bmat.reshape(bsz, c, q, g, n), rep, 3)  # (B,C,Q,H,N)
    cr = repeat_groups(cmat.reshape(bsz, c, q, g, n), rep, 3)

    a_steps = dtr * a  # (B, C, Q, H) log-decay per step
    dtx = _wide(xr * dtr[..., None])  # (B, C, Q, H, P)

    # --- within-chunk (quadratic, attention-dual) ---
    lmask = _segsum_decay(a_steps)  # (B, C, H, Q, S)
    cb = torch.einsum("bcqhn,bcshn->bchqs", _wide(cr), _wide(br))
    y_diag = torch.einsum("bchqs,bcshp->bcqhp", cb * lmask, dtx)

    # --- chunk states ---
    cum = torch.cumsum(a_steps, dim=2)  # (B, C, Q, H)
    total = cum[:, :, -1:, :]  # (B, C, 1, H)
    decay_to_end = torch.exp(total - cum)  # (B, C, Q, H) decay from step q to chunk end
    states = torch.einsum("bcqhn,bcqh,bcqhp->bchpn", _wide(br), decay_to_end, dtx)

    # --- inter-chunk recurrence, over the static chunk count ---
    chunk_decay = torch.exp(total[:, :, 0, :])  # (B, C, H)
    hcur = (_wide(h0) if h0 is not None
            else torch.zeros((bsz, h, p, n), dtype=states.dtype, device=x.device))
    hprevs = []
    for ci in range(c):
        hprevs.append(hcur)  # the state entering chunk ci
        hcur = hcur * chunk_decay[:, ci, :, None, None] + states[:, ci]
    hprev = torch.stack(hprevs, dim=1)  # (B, C, H, P, N)

    # --- off-chunk contribution ---
    in_decay = torch.exp(cum)  # (B, C, Q, H) decay from chunk start to step q
    y_off = torch.einsum("bcqhn,bcqh,bchpn->bcqhp", _wide(cr), in_decay, hprev)

    y = (y_diag + y_off).reshape(bsz, l, h, p)[:, :l_orig]
    return y.to(x.dtype), hcur


def ssm_block_full(sp: SsmParams, x: torch.Tensor, cfg: ModelConfig
                   ) -> tuple[torch.Tensor, "SsmCache"]:
    """Full-sequence Mamba2 block.  x (B, L, d) -> (residual delta, the
    cache a decode continues from: the last K-1 conv inputs, zero-padded
    on the left where L < K-1, and the SSD's final state)."""
    bsz, l, _ = x.shape
    h, p, n, g = cfg.ssm_heads, cfg.ssm_head_dim, cfg.ssm_state, cfg.ssm_groups
    xn = rmsnorm(x, sp.ln, cfg.norm_eps)
    zxbcdt = xn @ sp.in_proj
    z, xbc, dt = _split_in_proj(cfg, zxbcdt)
    conv_tail = F.pad(xbc, (0, 0, cfg.ssm_conv - 1, 0))[:, l:]
    xbc = _causal_conv_train(xbc, sp.conv_w, sp.conv_b)
    xs, bmat, cmat = torch.split(xbc, [cfg.ssm_inner, g * n, g * n], dim=-1)
    xs = xs.reshape(bsz, l, h, p)
    bmat = bmat.reshape(bsz, l, g, n)
    cmat = cmat.reshape(bsz, l, g, n)
    dtv = F.softplus(_wide(dt) + sp.dt_bias)  # (B, L, H)
    a = -torch.exp(_wide(sp.a_log))  # (H,)
    y, hfin = ssd_scan(cfg, xs, dtv, a, bmat, cmat)
    y = y + xs * sp.d_skip[None, None, :, None].to(y.dtype)
    y = y.reshape(bsz, l, cfg.ssm_inner)
    y = y * F.silu(z)  # gated output
    y = rmsnorm(y, sp.out_norm, cfg.norm_eps)
    return y @ sp.out_proj, SsmCache(conv=conv_tail, state=hfin)


def ssm_block_train(sp: SsmParams, x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """Full-sequence Mamba2 block.  x (B, L, d) -> residual delta."""
    return ssm_block_full(sp, x, cfg)[0]


class SsmCache(NamedTuple):
    conv: torch.Tensor  # (B, K-1, conv_channels) rolling conv inputs
    state: torch.Tensor  # (B, H, P, N) SSD recurrent state, float32 (or wider)


def init_ssm_cache(cfg: ModelConfig, batch: int, dtype: torch.dtype = torch.float32,
                   device="cuda") -> SsmCache:
    device = resolve_device(device)
    return SsmCache(
        conv=torch.zeros((batch, cfg.ssm_conv - 1, cfg.ssm_conv_channels), dtype=dtype,
                         device=device),
        state=torch.zeros((batch, cfg.ssm_heads, cfg.ssm_head_dim, cfg.ssm_state),
                          dtype=dtype, device=device))


def ssm_block_decode(sp: SsmParams, x: torch.Tensor, cfg: ModelConfig, cache: SsmCache
                     ) -> tuple[torch.Tensor, SsmCache]:
    """One-token recurrent update.  x (B, 1, d) -> (residual delta, cache).
    The conv window rolls in the cache's conv dtype (the config dtype in
    ``model.init_cache``); the state update, the C read-out and the D skip
    run in the state's float32 (or wider).  The cache's two tensors are
    updated in place and returned, so a captured decode step keeps static
    buffers."""
    bsz = x.shape[0]
    h, p, n, g = cfg.ssm_heads, cfg.ssm_head_dim, cfg.ssm_state, cfg.ssm_groups
    xn = rmsnorm(x[:, 0, :], sp.ln, cfg.norm_eps)  # (B, d)
    zxbcdt = xn @ sp.in_proj
    z, xbc, dt = _split_in_proj(cfg, zxbcdt)

    # rolling causal conv: the K-1 cached inputs and this one; the depthwise
    # sum of products rounded once to the window's dtype
    wdt = torch.promote_types(cache.conv.dtype, xbc.dtype)
    window = torch.cat([cache.conv.to(wdt), xbc[:, None, :].to(wdt)], dim=1)  # (B, K, C)
    conv_out = torch.einsum("bkc,kc->bc", _wide(window), _wide(sp.conv_w)).to(wdt) + sp.conv_b
    xbc = F.silu(conv_out)
    cache.conv.copy_(window[:, 1:, :])

    xs, bmat, cmat = torch.split(xbc, [cfg.ssm_inner, g * n, g * n], dim=-1)
    xs = _wide(xs.reshape(bsz, h, p))
    bmat = _wide(repeat_groups(bmat.reshape(bsz, g, n), h // g, 1))  # (B, H, N)
    cmat = _wide(repeat_groups(cmat.reshape(bsz, g, n), h // g, 1))
    dtv = F.softplus(_wide(dt) + sp.dt_bias)  # (B, H)
    a = -torch.exp(_wide(sp.a_log))
    decay = torch.exp(dtv * a)  # (B, H)

    sdt = cache.state.dtype
    dbx = (dtv[:, :, None] * xs)[..., None] * bmat[:, :, None, :]  # (B, H, P, N)
    cache.state.copy_(cache.state * decay[:, :, None, None].to(sdt) + dbx.to(sdt))
    y = torch.einsum("bhpn,bhn->bhp", cache.state, cmat.to(sdt))
    y = y + xs.to(sdt) * _wide(sp.d_skip)[None, :, None].to(sdt)
    y = y.reshape(bsz, cfg.ssm_inner).to(x.dtype)
    y = y * F.silu(z)
    y = rmsnorm(y, sp.out_norm, cfg.norm_eps)
    return (y @ sp.out_proj)[:, None, :], cache
