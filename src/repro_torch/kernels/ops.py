"""Public wrappers of the port's kernels (port of ``repro.kernels.ops``).

The RFF and SE Gram kernels take their inputs as they are (the kernels
mask ragged shapes): ``rff_features`` flattens leading axes into rows, so
one launch covers a whole (N, cap, d) trajectory batch; ``rff_grad`` and
``rff_grad_rows`` take one w or one w per row; ``sqexp`` takes 2-D or
client-batched (N, a, d) inputs.  Each makes its inputs contiguous and
raises ``TypeError`` on inputs that are not f32.

The GP scoring and gradient-mean kernels come client-batched
(``*_clients``) and single-client (``uncertainty_scores``,
``grad_mean_batch``).

Each call picks block sizes (``kernels.autotune`` unless pinned; pinned
pairs are validated; the client-batched calls as the kinds
"score_clients" and "grad_clients", the single-client calls as "score"
and "grad"), zero-pads the candidate axis to a ``block_n`` multiple, and
routes: ``block_cap >= cap`` to the resident route, a smaller
``block_cap`` to the cap-tiled route, at any cap (neither pads the
trajectory: the scoring's panels of ``block_cap`` rows and the gradient's
chunks of at most ``block_cap`` rows mask the ragged edge); padded
candidate rows are sliced away.  Both scoring kinds' resident kernel is a
thread block cluster per client and candidate tile; every gradient route
is one cluster kernel, whose resident routes take clusters of up to 8
blocks client-batched and 16 for one client and end, at d=300, at cap
1480 and 2960 (``kernels.autotune``), beyond which the tuner takes the
tiled route.  A CPU tensor runs the kernel's plain version, a CUDA tensor
the kernel.  Lengthscale and prior are runtime scalars, so the kernels
run on the jitted-free main path.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.kernels import autotune, gp_grad, gp_score
from repro_torch.kernels import rff_features as _rff_features
from repro_torch.kernels import rff_grad as _rff_grad
from repro_torch.kernels import sqexp as _sqexp


def rff_features(x: torch.Tensor, v: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """phi(X) = sqrt(2/M) cos(X V^T + b): (..., n, d) -> (..., n, M), one launch."""
    lead, d = x.shape[:-1], x.shape[-1]
    out = _rff_features.rff_features(x.reshape(-1, d).contiguous(), v.contiguous(),
                                     b.contiguous())
    return out.reshape(*lead, v.shape[0])


def rff_grad(x: torch.Tensor, v: torch.Tensor, b: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """grad phi(X)^T w with one w (M,) for every row: (n, d) -> (n, d)."""
    return _rff_grad.rff_grad(x.contiguous(), v.contiguous(), b.contiguous(), w.contiguous())


def rff_grad_rows(x: torch.Tensor, v: torch.Tensor, b: torch.Tensor,
                  ws: torch.Tensor) -> torch.Tensor:
    """Per-row weights: row i is grad phi(x_i)^T w_i, x (n, d), ws (n, M) -> (n, d)."""
    return _rff_grad.rff_grad_rows(x.contiguous(), v.contiguous(), b.contiguous(),
                                   ws.contiguous())


def sqexp(x1: torch.Tensor, x2: torch.Tensor, lengthscale: float) -> torch.Tensor:
    """SE Gram: (n, d), (m, d) -> (n, m), or (N, a, d), (N, b, d) -> (N, a, b)."""
    if x1.dim() != x2.dim() or x1.dim() not in (2, 3):
        raise ValueError(f"sqexp takes two 2-D or two 3-D inputs, got shapes "
                         f"{tuple(x1.shape)} and {tuple(x2.shape)}")
    if x1.dim() == 2:
        return _sqexp.sqexp_clients(x1[None].contiguous(), x2[None].contiguous(),
                                    lengthscale=lengthscale)[0]
    return _sqexp.sqexp_clients(x1.contiguous(), x2.contiguous(), lengthscale=lengthscale)


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


def _pad_axis(a: torch.Tensor, axis: int, target: int) -> torch.Tensor:
    """Zero-pad one axis to ``target`` (returns ``a`` itself when no pad)."""
    pad = target - a.shape[axis]
    if pad == 0:
        return a
    widths = [0, 0] * (a.dim() - axis - 1) + [0, pad]
    return F.pad(a, widths)


def _pad_gram(a: torch.Tensor, target: int) -> torch.Tensor:
    """Zero-pad both trailing axes of a (..., cap, cap) array."""
    return _pad_axis(_pad_axis(a, a.dim() - 1, target), a.dim() - 2, target)


def _resolve_blocks(kind, n, cap, d, block_n, block_cap):
    """Unset block sizes come from the tuner; pinned ones are validated."""
    pinned = block_n is not None or block_cap is not None
    if block_n is None or block_cap is None:
        bn, bc = autotune.select_blocks(kind, n=n, cap=cap, d=d)
        block_n = bn if block_n is None else block_n
        block_cap = bc if block_cap is None else block_cap
    if pinned:
        autotune.validate_blocks(kind, block_n=block_n, block_cap=block_cap, cap=cap, d=d)
    return block_n, block_cap


def _scores(kind, resident, tiled, cands, xs, binv, pmat, lengthscale, prior, block_n,
            block_cap):
    """Pad, route and slice back the scoring of ``cands`` (..., n, d)."""
    n, d = cands.shape[-2:]
    cap = xs.shape[-2]
    block_n, block_cap = _resolve_blocks(kind, n, cap, d, block_n, block_cap)
    c = _pad_axis(cands, cands.dim() - 2, _round_up(n, block_n)).contiguous()
    args = (c, xs.contiguous(), binv.contiguous(), pmat.contiguous())
    if block_cap >= cap:
        out = resident(*args, lengthscale=lengthscale, prior=prior, block_n=block_n)
    else:
        out = tiled(*args, lengthscale=lengthscale, prior=prior, block_n=block_n,
                    block_cap=block_cap)
    return out[..., :n]


def _grad(kind, resident, tiled, cands, xs, alpha, lengthscale, block_n, block_cap):
    """Pad, route and slice back the gradient mean at ``cands`` (..., n, d)."""
    n, d = cands.shape[-2:]
    cap = xs.shape[-2]
    block_n, block_cap = _resolve_blocks(kind, n, cap, d, block_n, block_cap)
    c = _pad_axis(cands, cands.dim() - 2, _round_up(n, block_n)).contiguous()
    args = (c, xs.contiguous(), alpha.contiguous())
    if block_cap >= cap:
        out = resident(*args, lengthscale=lengthscale, block_n=block_n)
    else:
        out = tiled(*args, lengthscale=lengthscale, block_n=block_n, block_cap=block_cap)
    return out[..., :n, :]


def uncertainty_scores_clients(
    cands: torch.Tensor,
    xs: torch.Tensor,
    binv: torch.Tensor,
    pmat: torch.Tensor,
    *,
    lengthscale: float,
    prior: float,
    block_n: int | None = None,
    block_cap: int | None = None,
) -> torch.Tensor:
    """Client-batched uncertainty scores: (N, n, d) -> (N, n)."""
    return _scores("score_clients", gp_score.uncertainty_scores_resident,
                   gp_score.uncertainty_scores_tiled,
                   cands, xs, binv, pmat, lengthscale, prior, block_n, block_cap)


def uncertainty_scores(
    cands: torch.Tensor,
    xs: torch.Tensor,
    binv: torch.Tensor,
    pmat: torch.Tensor,
    *,
    lengthscale: float,
    prior: float,
    block_n: int | None = None,
    block_cap: int | None = None,
) -> torch.Tensor:
    """One client's uncertainty scores: (n, d) candidates, xs (cap, d),
    B and P (cap, cap) -> (n,)."""
    return _scores("score", gp_score.uncertainty_scores_single_resident,
                   gp_score.uncertainty_scores_single_tiled,
                   cands, xs, binv, pmat, lengthscale, prior, block_n, block_cap)


def grad_mean_clients(
    cands: torch.Tensor,
    xs: torch.Tensor,
    alpha: torch.Tensor,
    *,
    lengthscale: float,
    block_n: int | None = None,
    block_cap: int | None = None,
) -> torch.Tensor:
    """Client-batched gradient mean: (N, n, d) -> (N, n, d); ``alpha`` (N, cap)
    must already carry each client's validity mask."""
    return _grad("grad_clients", gp_grad.grad_mean_resident, gp_grad.grad_mean_tiled,
                 cands, xs, alpha, lengthscale, block_n, block_cap)


def grad_mean_batch(
    cands: torch.Tensor,
    xs: torch.Tensor,
    alpha: torch.Tensor,
    *,
    lengthscale: float,
    block_n: int | None = None,
    block_cap: int | None = None,
) -> torch.Tensor:
    """One client's gradient mean: (n, d) queries, xs (cap, d) -> (n, d);
    ``alpha`` (cap,) must already carry the validity mask."""
    return _grad("grad", gp_grad.grad_mean_single_resident, gp_grad.grad_mean_single_tiled,
                 cands, xs, alpha, lengthscale, block_n, block_cap)
