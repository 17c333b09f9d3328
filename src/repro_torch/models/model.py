"""Model assembly (port of ``repro.models.model``, the full-sequence forward
and the LM loss of the dense, moe, ssm, hybrid and vlm families).

The stack is a Python loop over the ``blocks/`` leaves, one slice of each
stacked leaf a block (the reference's ``lax.scan``); with no autograd in
the port's forward, remat has nothing to do.  ``train_step``, prefill and
decode come with ROADMAP Queue A, A13c.  The encoder-decoder family
(whisper) is not run: its forward needs encoder frames, which the
reference's LM objective never makes (ROADMAP Queue C).

``forward`` takes a group count: the batch is G equal groups of
sequences, each group's MoE routing, capacity, drops and auxiliary loss
its own, as the reference's forward of that group alone (the LM
objective's points, which the reference evaluates one by one).
"""

from __future__ import annotations

from typing import Optional

import torch

from repro_torch.models import layers as L
from repro_torch.models import ssm as S
from repro_torch.models.config import ModelConfig
from repro_torch.sharding.rules import ShardingPolicy

Params = dict[str, torch.Tensor]


def check_ported(cfg: ModelConfig) -> None:
    """Raises ``NotImplementedError`` naming the reference's gap for the
    family whose forward the port does not run (the encoder-decoder)."""
    if cfg.arch_type == "encdec":
        raise NotImplementedError(
            f"{cfg.name}: the encoder-decoder forward needs encoder frames ('frames'), which "
            "the reference's LM objective never makes (its KeyError: 'frames'; the "
            "reference's gap, ROADMAP Queue C)")


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


def _full_block(bp: Params, x: torch.Tensor, cfg: ModelConfig, positions: torch.Tensor,
                policy: ShardingPolicy, window: int, groups: int,
                routes: Optional[L.Routes] = None) -> tuple[torch.Tensor, torch.Tensor]:
    """One block of the stack, full-sequence mode: the ``ssm`` kind (a
    Mamba2 layer), the ``hybrid`` kind (1 attention layer and its (MoE)
    MLP, then ``attn_every - 1`` Mamba2 layers, each followed by its (MoE)
    MLP) or the ``attn`` kind (attention, then the (MoE) MLP).  Returns
    (x, each group's aux summed over the block's MLPs)."""
    if cfg.block_kind == "ssm":
        return (x + S.ssm_block_train(S.pick_ssm(bp, ""), x, cfg),
                torch.zeros(groups, dtype=torch.float32, device=x.device))
    x = x + L.attn_block(L.pick_attn(bp, "attn."), x, cfg, positions, window=window,
                         chunk=policy.attn_chunk)
    if cfg.block_kind != "hybrid":
        d, aux = _mlp_or_moe(bp, "mlp.", x, cfg, groups, routes)
        return x + d, aux
    d, aux = _mlp_or_moe(_index_sub(bp, "mlp.", 0), "mlp.", x, cfg, groups, routes)
    x = x + d
    for i in range(cfg.attn_every - 1):
        x = x + S.ssm_block_train(S.pick_ssm(_index_sub(bp, "ssm.", i), "ssm."), x, cfg)
        d, a = _mlp_or_moe(_index_sub(bp, "mlp.", i + 1), "mlp.", x, cfg, groups, routes)
        x = x + d
        aux = aux + a
    return x, aux


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


def forward(p: Params, cfg: ModelConfig, batch: dict, policy: ShardingPolicy,
            groups: int = 1, routes: Optional[L.Routes] = None
            ) -> tuple[torch.Tensor, torch.Tensor]:
    """Full-sequence forward of ``batch["tokens"]`` (B, L) (and, for the vlm
    family, ``"patches"`` and ``"positions"`` where given).  Returns
    (logits (B, L, V) in the config dtype, moe_aux (groups,)): the router's
    auxiliary loss of each of ``groups`` equal groups of sequences along
    B, summed over the blocks (0 for the dense and ssm families).  With
    ``routes`` (``layers.Routes``) each MoE layer's routing is appended
    there, or taken from its pin."""
    check_ported(cfg)
    tokens = batch["tokens"]
    bsz, length = tokens.shape
    if bsz % groups:
        raise ValueError(f"a batch of {bsz} sequences does not split into {groups} groups")
    x = _embed(p, cfg, tokens)
    if cfg.arch_type == "vlm":
        x = _merge_patches(x, batch)
    positions = _positions_for(cfg, batch, bsz, length, tokens.device)
    window = cfg.sliding_window
    blocks = _block_params(p)
    aux = torch.zeros(groups, dtype=torch.float32, device=x.device)
    for i in range(cfg.n_blocks):
        x, a = _full_block({k: v[i] for k, v in blocks.items()}, x, cfg, positions, policy,
                           window, groups, routes)
        aux = aux + a
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
