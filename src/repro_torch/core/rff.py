"""Random Fourier features and the transferable global surrogate (port of
``repro.core.rff``: paper Sec. 4.2.1 + Appx. B).

phi(x) = sqrt(2/M) cos(V x + b),  V_j ~ N(0, I/l^2),  b_j ~ U[0, 2pi],

and the M-dim weights w = Phi (Khat + s^2 I)^{-1} y (eq. 6) that each
client sends to the server: ``fit_w_chol`` (the deferred engine), ``fit_w``
(the clamped eigh of the per-client engines) and ``fit_w_from_factor``
(``rff_fit_exact``), each for a stacked client batch.

The two contractions with the feature bank run on the port's kernels
(``kernels.ops``; plain torch on CPU tensors): ``features`` is the RFF
feature kernel (B6), one launch for a whole (N, cap, d) trajectory batch;
``grad_features_t_w`` and its ``_batch`` and ``_rows`` forms are the RFF
gradient kernel (B5).  The eq. 8 correction of the client-batched engine
takes two ``_rows`` calls per local step, one on ``w_global`` and one on
``w_local``, with the difference taken after them, as in the reference.
The Gram solves of the fits stay on ``torch.linalg``.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.core import gp_surrogate as gp
from repro_torch.kernels import ops


class RFFParams(NamedTuple):
    v: torch.Tensor  # (M, d) frequencies
    b: torch.Tensor  # (M,) phases

    @property
    def n_features(self) -> int:
        return self.v.shape[0]


def make_rff(draws, n_features: int, dim: int, lengthscale: float) -> RFFParams:
    """The shared feature bank, from the draw source's standard-normal
    (M, d) and uniform [0, 2 pi) (M,) bank draws."""
    z, b = draws.bank(n_features, dim)
    return RFFParams(v=z / lengthscale, b=b)


def features(params: RFFParams, xs: torch.Tensor) -> torch.Tensor:
    """phi(X): (..., n, d) -> (..., n, M)."""
    return ops.rff_features(xs, params.v, params.b)


def grad_features_t_w(params: RFFParams, x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """grad phi(x)^T w: x (d,), w (M,) -> (d,)."""
    return grad_features_t_w_batch(params, x[None], w)[0]


def grad_features_t_w_batch(params: RFFParams, xs: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """One weight vector for every row: xs (n, d), w (M,) -> (n, d)."""
    return ops.rff_grad(xs, params.v, params.b, w)


def grad_features_t_w_rows(params: RFFParams, xs: torch.Tensor, ws: torch.Tensor) -> torch.Tensor:
    """Per-row weights: xs (n, d), ws (n, M) -> (n, d); row i is
    grad phi(x_i)^T w_i = -sqrt(2/M) (sin(V x_i + b) o w_i) V."""
    return ops.rff_grad_rows(xs, params.v, params.b, ws)


def fit_w_chol(params: RFFParams, traj: gp.Trajectory, hyper: gp.GPHyper,
               factor: gp.GramFactor) -> torch.Tensor:
    """Eq. 6 per client by Cholesky: (N, M).

    If a live pivot of the RFF Gram dips below the pivot floor, that client
    takes the solve through its cached exact-GP factor instead (selected
    with ``torch.where``, no eigh), as in the reference.
    """
    mask = traj.valid_mask()
    phi = features(params, traj.xs) * mask[..., None]  # (N, cap, M)
    jitter = gp._jitter_of(hyper)
    gram = phi @ phi.transpose(-1, -2) + torch.diag_embed(jitter * mask + (1.0 - mask))
    chol, info = torch.linalg.cholesky_ex(gram)
    ok = gp._factor_health(chol, mask, jitter, info)
    ys_m = traj.ys * mask
    safe = torch.where(ok[:, None, None], chol, gp._eye_like(gram))
    alpha = gp.chol_solve(safe, ys_m[..., None])[..., 0]
    alpha_fb = gp.factor_solve(factor, ys_m)
    alpha = torch.where(ok[:, None], alpha, alpha_fb)
    return (phi.transpose(-1, -2) @ alpha[..., None])[..., 0]


def fit_w(params: RFFParams, traj: gp.Trajectory, hyper: gp.GPHyper) -> torch.Tensor:
    """Eq. 6 per client by the clamped eigh of the RFF Gram (the per-client
    engines' round-end fit): (N, M).  Invalid slots contribute nothing."""
    mask = traj.valid_mask()
    phi = features(params, traj.xs) * mask[..., None]  # (N, cap, M)
    jitter = gp._jitter_of(hyper)
    gram = phi @ phi.transpose(-1, -2) + torch.diag_embed(jitter * mask + (1.0 - mask))
    v, w = gp._clamped_eigh(gram, jitter)
    vb = v.transpose(-1, -2) @ (traj.ys * mask)[..., None]
    alpha = v @ (vb / w[..., None])
    return (phi.transpose(-1, -2) @ alpha)[..., 0]


def fit_w_from_factor(params: RFFParams, traj: gp.Trajectory,
                      factor: gp.GramFactor) -> torch.Tensor:
    """w = Phi (K + s^2 I)^{-1} y per client through the cached exact-GP
    factor (``AlgoConfig.rff_fit_exact``): (N, M)."""
    mask = traj.valid_mask()
    alpha = gp.factor_solve(factor, traj.ys * mask)
    phi = features(params, traj.xs) * mask[..., None]
    return (phi.transpose(-1, -2) @ alpha[..., None])[..., 0]
