"""Model assembly (port of ``repro.models.model``): the full-sequence
forward and the LM loss of every family, and serving's prefill and
one-token decode over the KV and SSM caches.

The stack is a Python loop over the ``blocks/`` leaves, one slice of each
stacked leaf a block (the reference's ``lax.scan``); with no autograd in
the port's forward, remat has nothing to do.  ``train_step`` comes with
ROADMAP Queue A, A13d.  The encoder-decoder family (whisper) runs when the
batch carries its stub encoder frames (``"frames"``); the reference's LM
objective never makes them (ROADMAP Queue C), so there it raises.

``forward`` takes a group count: the batch is G equal groups of
sequences, each group's MoE routing, capacity, drops and auxiliary loss
its own, as the reference's forward of that group alone (the LM
objective's points, which the reference evaluates one by one).

``prefill`` fills a ``DecodeCache`` (the reference's layouts) and
``decode_step`` advances it by one token in place: every write is an
``index_copy_`` or ``copy_`` at the cache's device-side position, so a
decode step is shape-static, reads nothing on the host and runs as a
captured CUDA graph (``launch/serve.py``).
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch
import torch.nn.functional as F

from repro_torch.device import resolve_device
from repro_torch.models import layers as L
from repro_torch.models import ssm as S
from repro_torch.models.config import ModelConfig
from repro_torch.sharding.rules import ShardingPolicy

Params = dict[str, torch.Tensor]


def check_ported(cfg: ModelConfig, batch: Optional[dict] = None) -> None:
    """Raises ``NotImplementedError`` naming the reference's gap for an
    encoder-decoder batch without encoder frames (or no batch: the LM
    objective's, which never has them)."""
    if cfg.arch_type == "encdec" and (batch is None or "frames" not in batch):
        raise NotImplementedError(
            f"{cfg.name}: the encoder-decoder forward needs encoder frames ('frames'), which "
            "the reference's LM objective never makes (its KeyError: 'frames'; the "
            "reference's gap, ROADMAP Queue C)")


# ---------------------------------------------------------------------------
# caches
# ---------------------------------------------------------------------------


class AttnCache(NamedTuple):
    k: torch.Tensor  # (nb, B, S, KV, hd)
    v: torch.Tensor


class SsmStack(NamedTuple):
    conv: torch.Tensor  # (nb, [n_ssm,] B, K-1, C), the config dtype
    state: torch.Tensor  # (nb, [n_ssm,] B, H, P, N), float32 (or wider)


class DecodeCache(NamedTuple):
    """Union cache; unused members are size-0 tensors."""

    attn: AttnCache
    ssm: SsmStack
    cross: AttnCache  # encdec only: the encoder's K/V per decoder layer
    pos: torch.Tensor  # () int64 on the device: the next write position


def init_cache(cfg: ModelConfig, batch: int, seq: int, dtype: Optional[torch.dtype] = None,
               device="cuda") -> DecodeCache:
    """A zero cache of ``seq`` positions for ``batch`` sequences at pos 0."""
    device = resolve_device(device)
    dtype = dtype or cfg.torch_dtype
    wide = torch.promote_types(dtype, torch.float32)
    zeros = lambda shape, dt=dtype: torch.zeros(shape, dtype=dt, device=device)
    nb, kv, hd = cfg.n_blocks, cfg.n_kv_heads, cfg.resolved_head_dim
    empty = AttnCache(zeros((0,)), zeros((0,)))
    attn = empty if cfg.arch_type == "ssm" else AttnCache(zeros((nb, batch, seq, kv, hd)),
                                                         zeros((nb, batch, seq, kv, hd)))
    ssm = SsmStack(zeros((0,)), zeros((0,), wide))
    if cfg.arch_type in ("ssm", "hybrid"):
        lead = (nb,) if cfg.arch_type == "ssm" else (nb, cfg.attn_every - 1)
        ssm = SsmStack(zeros(lead + (batch, cfg.ssm_conv - 1, cfg.ssm_conv_channels)),
                       zeros(lead + (batch, cfg.ssm_heads, cfg.ssm_head_dim, cfg.ssm_state),
                             wide))
    cross = empty
    if cfg.arch_type == "encdec":
        cross = AttnCache(zeros((nb, batch, cfg.enc_seq, kv, hd)),
                          zeros((nb, batch, cfg.enc_seq, kv, hd)))
    return DecodeCache(attn, ssm, cross, torch.zeros((), dtype=torch.int64, device=device))


def cache_bytes(cache: DecodeCache) -> int:
    """The bytes of every tensor of the cache."""
    return sum(t.numel() * t.element_size() for t in (*cache.attn, *cache.ssm, *cache.cross,
                                                      cache.pos))


# ---------------------------------------------------------------------------
# block bodies (full sequence)
# ---------------------------------------------------------------------------


def _block_params(p: Params, prefix: str = "blocks/") -> Params:
    return {k[len(prefix):]: v for k, v in p.items() if k.startswith(prefix)}


def _index_sub(bp: Params, prefix: str, i: int) -> Params:
    """The i-th inner layer of a super-block parameter group."""
    return {k: v[i] for k, v in bp.items() if k.startswith(prefix)}


def _mlp_or_moe(bp: Params, prefix: str, x: torch.Tensor, cfg: ModelConfig, groups: int,
                routes: Optional[L.Routes]) -> tuple[torch.Tensor, torch.Tensor]:
    """The (MoE) MLP's residual delta and each group's aux (G,)."""
    if cfg.is_moe_mlp:
        return L.moe_block(bp, prefix, x, cfg, groups=groups, routes=routes)
    return (L.mlp_block(bp, prefix, x, cfg),
            torch.zeros(groups, dtype=torch.float32, device=x.device))


def _cached_block(bp: Params, x: torch.Tensor, cfg: ModelConfig, positions: torch.Tensor,
                  policy: ShardingPolicy, window: int, groups: int,
                  routes: Optional[L.Routes] = None):
    """One block of the stack, full-sequence mode: the ``ssm`` kind (a
    Mamba2 layer), the ``hybrid`` kind (1 attention layer and its (MoE)
    MLP, then ``attn_every - 1`` Mamba2 layers, each followed by its (MoE)
    MLP) or the ``attn`` kind (attention, then the (MoE) MLP).  Returns
    (x, each group's aux summed over the block's MLPs, the attention
    layer's (K after RoPE, V) or None, each Mamba2 layer's ``SsmCache``):
    what a prefill caches."""
    if cfg.block_kind == "ssm":
        d, sc = S.ssm_block_full(S.pick_ssm(bp, ""), x, cfg)
        return x + d, torch.zeros(groups, dtype=torch.float32, device=x.device), None, [sc]
    d, k, v = L.attn_block(L.pick_attn(bp, "attn."), x, cfg, positions, window=window,
                           chunk=policy.attn_chunk, return_kv=True)
    x = x + d
    if cfg.block_kind != "hybrid":
        d, aux = _mlp_or_moe(bp, "mlp.", x, cfg, groups, routes)
        return x + d, aux, (k, v), []
    d, aux = _mlp_or_moe(_index_sub(bp, "mlp.", 0), "mlp.", x, cfg, groups, routes)
    x = x + d
    caches = []
    for i in range(cfg.attn_every - 1):
        d, sc = S.ssm_block_full(S.pick_ssm(_index_sub(bp, "ssm.", i), "ssm."), x, cfg)
        x = x + d
        caches.append(sc)
        d, a = _mlp_or_moe(_index_sub(bp, "mlp.", i + 1), "mlp.", x, cfg, groups, routes)
        x = x + d
        aux = aux + a
    return x, aux, (k, v), caches


def _full_block(bp: Params, x: torch.Tensor, cfg: ModelConfig, positions: torch.Tensor,
                policy: ShardingPolicy, window: int, groups: int,
                routes: Optional[L.Routes] = None) -> tuple[torch.Tensor, torch.Tensor]:
    """``_cached_block``'s (x, aux)."""
    return _cached_block(bp, x, cfg, positions, policy, window, groups, routes)[:2]


def _encdec_block(bp: Params, x: torch.Tensor, enc_out: torch.Tensor, cfg: ModelConfig,
                  positions: torch.Tensor, policy: ShardingPolicy):
    """One decoder block of the encoder-decoder, full-sequence mode: causal
    self-attention, cross-attention on K/V projected raw from the normed
    encoder output (as the reference's forward and prefill), the MLP.
    Returns (x, the self-attention's (K, V), the cross (K, V))."""
    d, k, v = L.attn_block(L.pick_attn(bp, "self."), x, cfg, positions, causal=True,
                           chunk=policy.attn_chunk, return_kv=True)
    x = x + d
    ca = L.pick_attn(bp, "cross.")
    heads = (x.shape[0], -1, cfg.n_kv_heads, cfg.resolved_head_dim)
    ck, cv = (enc_out @ ca.wk).reshape(heads), (enc_out @ ca.wv).reshape(heads)
    x = x + L.attn_block(ca, x, cfg, positions, cross_kv=(ck, cv))
    return x + L.mlp_block(bp, "mlp.", x, cfg), (k, v), (ck, cv)


# ---------------------------------------------------------------------------
# forward
# ---------------------------------------------------------------------------


def _positions_for(cfg: ModelConfig, batch: dict, bsz: int, length: int,
                   device) -> torch.Tensor:
    """(B, L) token positions 0..L-1; for M-RoPE ``batch["positions"]``
    (B, L, 3) if given, else the same position in all three components."""
    if cfg.rope_mode == "mrope":
        if "positions" in batch:
            return batch["positions"]
        return torch.arange(length, device=device)[None, :, None].expand(bsz, length, 3)
    return torch.arange(length, device=device)[None, :].expand(bsz, length)


def _embed(p: Params, cfg: ModelConfig, tokens: torch.Tensor) -> torch.Tensor:
    return p["embed"][tokens]


def _merge_patches(x: torch.Tensor, batch: dict) -> torch.Tensor:
    """VLM: the first n_patches positions overwritten with the (stub) patch
    embeddings (B, n_patches, d), the projector output of the vision
    tower."""
    patches = batch.get("patches")
    if patches is None:
        return x
    return torch.cat([patches.to(x.dtype), x[:, patches.shape[1]:]], dim=1)


def _unembed(p: Params, cfg: ModelConfig, x: torch.Tensor) -> torch.Tensor:
    """The final norm and the vocabulary projection (the tied embedding's
    transpose or ``lm_head``), then the logit softcap where the config has
    one.  ``final_norm`` may carry leading axes that broadcast against x's
    (B, L): one set of gains a sequence."""
    x = L.rmsnorm(x, p["final_norm"], cfg.norm_eps)
    head = p["embed"].T if cfg.tie_embeddings else p["lm_head"]
    logits = x @ head
    if cfg.logit_softcap > 0:
        logits = cfg.logit_softcap * torch.tanh(logits / cfg.logit_softcap)
    return logits


def _encode(p: Params, cfg: ModelConfig, frames: torch.Tensor) -> torch.Tensor:
    """Whisper-style encoder over (stub) frame embeddings (B, enc_seq, d):
    the learned positions, bidirectional attention blocks, ``enc_norm``."""
    dtype = cfg.torch_dtype
    x = frames.to(dtype) + p["enc_pos"][None, :frames.shape[1], :].to(dtype)
    pos = torch.arange(x.shape[1], device=x.device)[None, :].expand(x.shape[:2])
    blocks = _block_params(p, "enc_blocks/")
    for i in range(cfg.n_enc_layers):
        bp = {k: v[i] for k, v in blocks.items()}
        x = x + L.attn_block(L.pick_attn(bp, "attn."), x, cfg, pos, causal=False)
        x = x + L.mlp_block(bp, "mlp.", x, cfg)
    return L.rmsnorm(x, p["enc_norm"], cfg.norm_eps)


def _trunk(p: Params, cfg: ModelConfig, batch: dict, policy: ShardingPolicy, groups: int,
           routes: Optional[L.Routes], keep: bool = False):
    """The stack over ``batch``: (x (B, L, d) before the final norm, each
    group's aux, and with ``keep`` (a prefill) each block's attention
    (K, V) or None, its ``SsmCache`` list and its cross (K, V) or None;
    without, empty lists: a forward holds no layer's K/V or state past
    its block)."""
    check_ported(cfg, batch)
    tokens = batch["tokens"]
    bsz, length = tokens.shape
    if bsz % groups:
        raise ValueError(f"a batch of {bsz} sequences does not split into {groups} groups")
    x = _embed(p, cfg, tokens)
    if cfg.arch_type == "vlm":
        x = _merge_patches(x, batch)
    positions = _positions_for(cfg, batch, bsz, length, tokens.device)
    blocks = _block_params(p)
    aux = torch.zeros(groups, dtype=torch.float32, device=x.device)
    kvs, ssms, crosses = [], [], []
    enc_out = None
    if cfg.arch_type == "encdec":
        enc_out = _encode(p, cfg, batch["frames"])
        x = x + p["dec_pos"][None, :length, :].to(x.dtype)
    for i in range(cfg.n_blocks):
        bp = {k: v[i] for k, v in blocks.items()}
        if enc_out is not None:
            x, kv, cross = _encdec_block(bp, x, enc_out, cfg, positions, policy)
            sc = []
        else:
            x, a, kv, sc = _cached_block(bp, x, cfg, positions, policy, cfg.sliding_window,
                                         groups, routes)
            aux, cross = aux + a, None
        if keep:
            kvs.append(kv)
            ssms.append(sc)
            crosses.append(cross)
    return x, aux, kvs, ssms, crosses


def forward(p: Params, cfg: ModelConfig, batch: dict, policy: ShardingPolicy,
            groups: int = 1, routes: Optional[L.Routes] = None
            ) -> tuple[torch.Tensor, torch.Tensor]:
    """Full-sequence forward of ``batch["tokens"]`` (B, L) (and, for the vlm
    family, ``"patches"`` and ``"positions"`` where given; for the
    encoder-decoder the stub frames ``"frames"`` (B, enc_seq, d)).  Returns
    (logits (B, L, V) in the config dtype, moe_aux (groups,)): the router's
    auxiliary loss of each of ``groups`` equal groups of sequences along
    B, summed over the blocks (0 for the dense, ssm and encdec families).
    With ``routes`` (``layers.Routes``) each MoE layer's routing is
    appended there, or taken from its pin."""
    x, aux, _, _, _ = _trunk(p, cfg, batch, policy, groups, routes)
    return _unembed(p, cfg, x), aux


# ---------------------------------------------------------------------------
# loss
# ---------------------------------------------------------------------------


def token_nll(logits: torch.Tensor, labels: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-token negative log-likelihood in float32 (or wider), 0 where the
    label is negative, and the valid mask: logits (..., V), labels (...).
    The label's logit is gathered, which is the reference's masked sum
    (one term and zeros) exactly."""
    valid = labels >= 0
    lf = L._wide(logits)
    lse = torch.logsumexp(lf, dim=-1)
    picked = lf.gather(-1, labels.clamp_min(0)[..., None])[..., 0]
    return (lse - picked) * valid, valid


def lm_loss(p: Params, cfg: ModelConfig, batch: dict, policy: ShardingPolicy,
            routes: Optional[L.Routes] = None) -> tuple[torch.Tensor, dict]:
    """Mean next-token NLL over the valid labels (``batch["labels"]``, -1
    to skip) plus the router's auxiliary loss: (total, {"loss", "moe_aux",
    "tokens"}).  The token count stays a tensor (nothing is read on the
    host).  ``routes`` as ``forward``'s."""
    logits, aux = forward(p, cfg, batch, policy, routes=routes)
    aux = aux.reshape(())
    nll, valid = token_nll(logits, batch["labels"])
    n = torch.clamp_min(valid.sum(), 1)
    loss = nll.sum() / n
    total = loss + cfg.router_aux_weight * aux
    return total, {"loss": loss, "moe_aux": aux, "tokens": n}


# ---------------------------------------------------------------------------
# prefill and decode
# ---------------------------------------------------------------------------


def prefill(p: Params, cfg: ModelConfig, batch: dict, policy: ShardingPolicy,
            cache_len: int = 0, routes: Optional[L.Routes] = None
            ) -> tuple[torch.Tensor, DecodeCache]:
    """The full-sequence forward of ``batch`` (as ``forward``'s, one MoE
    group) that also fills the decode cache: each attention layer's K
    (after RoPE) and V zero-padded to ``cache_len`` positions (default L),
    each Mamba2 layer's conv tail and SSD final state, each decoder layer's
    cross K/V.  Returns (the last token's logits (B, V), the cache at
    pos = L)."""
    tokens = batch["tokens"]
    bsz, length = tokens.shape
    cache_len = cache_len or length
    x, _, kvs, ssms, crosses = _trunk(p, cfg, batch, policy, 1, routes, keep=True)
    dev, dtype = tokens.device, cfg.torch_dtype
    none = torch.zeros((0,), dtype=dtype, device=dev)
    stack = lambda ts: torch.stack(list(ts))
    pad = lambda t: F.pad(t, (0, 0, 0, 0, 0, cache_len - length))
    attn = cross = AttnCache(none, none)
    if kvs[0] is not None:
        attn = AttnCache(stack(pad(k) for k, _ in kvs), stack(pad(v) for _, v in kvs))
    if crosses[0] is not None:
        cross = AttnCache(stack(k for k, _ in crosses), stack(v for _, v in crosses))
    ssm = SsmStack(none, none.to(torch.promote_types(dtype, torch.float32)))
    if ssms[0]:  # ssm: (nb, B, ...); hybrid: (nb, n_ssm, B, ...)
        one = (lambda ts: ts[0]) if cfg.arch_type == "ssm" else torch.stack
        ssm = SsmStack(stack(one([c.conv for c in sc]) for sc in ssms),
                       stack(one([c.state for c in sc]) for sc in ssms))
    cache = DecodeCache(attn, ssm, cross, torch.full((), length, dtype=torch.int64, device=dev))
    return _unembed(p, cfg, x[:, -1:, :])[:, 0, :], cache


def decode_step(p: Params, cfg: ModelConfig, cache: DecodeCache, token: torch.Tensor,
                policy: ShardingPolicy, routes: Optional[L.Routes] = None
                ) -> tuple[torch.Tensor, DecodeCache]:
    """One-token decode: token (B, 1) at the cache's position -> (logits
    (B, V), cache).  The cache is updated in place (its K/V written at
    ``pos``, its conv windows and states replaced, ``pos`` advanced by one)
    and returned: clone it (``core.graphs.clone``) to decode twice from
    one state.  MoE layers route the B tokens as one group, as the
    reference's.  Shape-static and free of host reads: it runs inside a
    captured CUDA graph."""
    pos = cache.pos
    x = _embed(p, cfg, token)
    window = cfg.sliding_window
    blocks = _block_params(p)
    if cfg.arch_type == "encdec":
        row = pos.clamp(0, p["dec_pos"].shape[0] - 1).reshape(1)
        x = x + p["dec_pos"].index_select(0, row)[None].to(x.dtype)
    for i in range(cfg.n_blocks):
        bp = {k: v[i] for k, v in blocks.items()}
        if cfg.arch_type == "encdec":
            x = x + L.attn_decode(L.pick_attn(bp, "self."), x, cfg, cache.attn.k[i],
                                  cache.attn.v[i], pos)[0]
            x = x + L.attn_decode(L.pick_attn(bp, "cross."), x, cfg, cache.cross.k[i],
                                  cache.cross.v[i], pos, cross=True)[0]
            x = x + L.mlp_block(bp, "mlp.", x, cfg)
            continue
        if cfg.arch_type == "ssm":
            x = x + S.ssm_block_decode(S.pick_ssm(bp, ""), x, cfg,
                                       S.SsmCache(cache.ssm.conv[i], cache.ssm.state[i]))[0]
            continue
        x = x + L.attn_decode(L.pick_attn(bp, "attn."), x, cfg, cache.attn.k[i],
                              cache.attn.v[i], pos, window=window)[0]
        if cfg.arch_type != "hybrid":
            x = x + _mlp_or_moe(bp, "mlp.", x, cfg, 1, routes)[0]
            continue
        x = x + _mlp_or_moe(_index_sub(bp, "mlp.", 0), "mlp.", x, cfg, 1, routes)[0]
        for j in range(cfg.attn_every - 1):
            sp = S.pick_ssm(_index_sub(bp, "ssm.", j), "ssm.")
            x = x + S.ssm_block_decode(sp, x, cfg, S.SsmCache(cache.ssm.conv[i, j],
                                                               cache.ssm.state[i, j]))[0]
            x = x + _mlp_or_moe(_index_sub(bp, "mlp.", j + 1), "mlp.", x, cfg, 1, routes)[0]
    pos.add_(1)
    return _unembed(p, cfg, x)[:, 0, :], cache
