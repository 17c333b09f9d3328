"""Model assembly (port of ``repro.models.model``, the full-sequence forward
and the LM loss of the dense and ssm families).

The stack is a Python loop over the ``blocks/`` leaves, one slice of each
stacked leaf a block (the reference's ``lax.scan``); with no autograd in
the port's forward, remat has nothing to do.  The moe, hybrid and vlm
forwards come with ROADMAP Queue A, A13b; ``train_step``, prefill and
decode with A13c.  The encoder-decoder family (whisper) is not run: its
forward needs encoder frames, which the reference's LM objective never
makes (ROADMAP Queue C).
"""

from __future__ import annotations

import torch

from repro_torch.models import layers as L
from repro_torch.models import ssm as S
from repro_torch.models.config import ModelConfig
from repro_torch.sharding.rules import ShardingPolicy

Params = dict[str, torch.Tensor]

#: Families whose forward is still to port, and their item.
_UNPORTED = {"moe": "A13b", "hybrid": "A13b", "vlm": "A13b"}


def check_ported(cfg: ModelConfig) -> None:
    """Raises ``NotImplementedError`` naming the ROADMAP item (or the
    reference's gap) of a family whose forward the port does not run."""
    if cfg.arch_type in _UNPORTED:
        raise NotImplementedError(
            f"{cfg.name}: the {cfg.arch_type} forward is not ported yet "
            f"(ROADMAP Queue A, {_UNPORTED[cfg.arch_type]})")
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


def _full_block(bp: Params, x: torch.Tensor, cfg: ModelConfig, positions: torch.Tensor,
                policy: ShardingPolicy, window: int) -> torch.Tensor:
    """One block of the stack, full-sequence mode: the ``ssm`` kind (a
    Mamba2 layer) or the ``attn`` kind (attention, then the gated MLP)."""
    if cfg.block_kind == "ssm":
        return x + S.ssm_block_train(S.pick_ssm(bp, ""), x, cfg)
    x = x + L.attn_block(L.pick_attn(bp, "attn."), x, cfg, positions, window=window,
                         chunk=policy.attn_chunk)
    return x + L.mlp_block(bp, "mlp.", x, cfg)


# ---------------------------------------------------------------------------
# forward
# ---------------------------------------------------------------------------


def _positions_for(cfg: ModelConfig, batch: dict, bsz: int, length: int,
                   device) -> torch.Tensor:
    """(B, L) token positions 0..L-1 (M-RoPE's (B, L, 3) comes with A13b)."""
    return torch.arange(length, device=device)[None, :].expand(bsz, length)


def _embed(p: Params, cfg: ModelConfig, tokens: torch.Tensor) -> torch.Tensor:
    return p["embed"][tokens]


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


def forward(p: Params, cfg: ModelConfig, batch: dict,
            policy: ShardingPolicy) -> tuple[torch.Tensor, torch.Tensor]:
    """Full-sequence forward of ``batch["tokens"]`` (B, L).  Returns
    (logits (B, L, V) in the config dtype, moe_aux ()); the dense and ssm
    families' aux is 0."""
    check_ported(cfg)
    tokens = batch["tokens"]
    bsz, length = tokens.shape
    x = _embed(p, cfg, tokens)
    positions = _positions_for(cfg, batch, bsz, length, tokens.device)
    window = cfg.sliding_window
    blocks = _block_params(p)
    for i in range(cfg.n_blocks):
        x = _full_block({k: v[i] for k, v in blocks.items()}, x, cfg, positions, policy,
                        window)
    return _unembed(p, cfg, x), torch.zeros((), dtype=torch.float32, device=x.device)


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


def lm_loss(p: Params, cfg: ModelConfig, batch: dict,
            policy: ShardingPolicy) -> tuple[torch.Tensor, dict]:
    """Mean next-token NLL over the valid labels (``batch["labels"]``, -1
    to skip) plus the router's auxiliary loss: (total, {"loss", "moe_aux",
    "tokens"}).  The token count stays a tensor (nothing is read on the
    host)."""
    logits, aux = forward(p, cfg, batch, policy)
    nll, valid = token_nll(logits, batch["labels"])
    n = torch.clamp_min(valid.sum(), 1)
    loss = nll.sum() / n
    total = loss + cfg.router_aux_weight * aux
    return total, {"loss": loss, "moe_aux": aux, "tokens": n}
