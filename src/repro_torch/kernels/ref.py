"""Plain torch oracles of the port's kernels (port of ``repro.kernels.ref``).

They are the numerical ground truth of the port's CUDA kernels and the
path a CPU tensor takes through ``kernels.ops``.

* The RFF features and gradient contraction: x (n, d), the bank v (M, d)
  and b (M,); ``rff_grad`` takes one w (M,) for every row,
  ``rff_grad_rows`` one w per row, ws (n, M).
* The SE Gram ``sqexp``, 2-D (n, d) x (m, d) or client-batched
  (N, a, d) x (N, b, d), in the expanded form with the clamp at 0.
* The GP scoring and gradient mean.  The ``*_clients`` forms carry a
  leading client axis N: candidates (N, n, d), trajectory xs (N, cap, d),
  the masked Gram inverse B and P = B o XX^T (N, cap, cap), alpha
  (N, cap).  ``uncertainty_scores`` and ``grad_mean_batch`` are the
  single-client forms: the same shapes without N.
"""

from __future__ import annotations

import math

import torch


def rff_features(x, v, b):
    """phi(X) = sqrt(2/M) cos(X V^T + b): (n, d), (M, d), (M,) -> (n, M)."""
    return math.sqrt(2.0 / v.shape[0]) * torch.cos(x @ v.T + b)


def rff_grad_rows(x, v, b, ws):
    """Row i is grad phi(x_i)^T w_i = -sqrt(2/M) (sin(V x_i + b) o w_i) V:
    x (n, d), ws (n, M) -> (n, d)."""
    s = torch.sin(x @ v.T + b)
    return -math.sqrt(2.0 / v.shape[0]) * ((s * ws) @ v)


def rff_grad(x, v, b, w):
    """grad phi(X)^T w with one w (M,) for every row: (n, d) -> (n, d)."""
    return rff_grad_rows(x, v, b, w[None, :])


def sqexp(x1, x2, lengthscale: float):
    """K = exp(-max(|x1|^2 + |x2|^2 - 2 x1.x2, 0) / 2 l^2):
    (n, d), (m, d) -> (n, m), or (N, a, d), (N, b, d) -> (N, a, b)."""
    n1 = torch.sum(x1 * x1, dim=-1)
    n2 = torch.sum(x2 * x2, dim=-1)
    cross = x1 @ x2.transpose(-1, -2)
    d2 = torch.clamp(n1[..., :, None] + n2[..., None, :] - 2.0 * cross, min=0.0)
    return torch.exp(-0.5 * d2 / (lengthscale**2))


def sqexp_f64(x1, x2, lengthscale: float):
    """``sqexp`` with the distances taken in float64 and the Gram rounded to
    the inputs' type once: the SE Gram wrapper's plain version on CPU
    tensors.  In f32 the expanded distance cancels for points a few 1e-2
    apart (a ring's, the active queries'), which the kernel's compensated
    and f64 sums do not; on the small attack engine (d=16) that f32 Gram
    alone moved the CPU run an Adam step away from a float64 run."""
    return sqexp(x1.double(), x2.double(), lengthscale).to(x1.dtype)


def _h_cross(cands: torch.Tensor, xs: torch.Tensor, lengthscale: float):
    """SE kernel vectors h (N, n, cap), the c.x_t table and ||c||^2 (N, n)."""
    n1 = torch.sum(cands * cands, dim=-1)
    n2 = torch.sum(xs * xs, dim=-1)
    cross = torch.einsum("bnd,bcd->bnc", cands, xs)
    d2 = torch.clamp(n1[..., None] + n2[:, None, :] - 2.0 * cross, min=0.0)
    return torch.exp(-0.5 * d2 / (lengthscale**2)), cross, n1


def uncertainty_scores_clients(cands, xs, binv, pmat, lengthscale: float, prior: float):
    """Textbook form of the scores, (N, n, d) -> (N, n):

        corr(c) = (1/l^4) [ h^T P h - 2 (h o Xc)^T B h + (c.c) h^T B h ],
        score(c) = max(prior - corr(c), 0),   h_t = k(c, x_t).
    """
    h, cross, n1 = _h_cross(cands, xs, lengthscale)
    g1 = torch.einsum("bnc,bck->bnk", h, pmat)
    g2 = torch.einsum("bnc,bck->bnk", h, binv)
    t1 = torch.sum(g1 * h, dim=-1)
    t2 = torch.sum(h * cross * g2, dim=-1)
    t3 = n1 * torch.sum(h * g2, dim=-1)
    corr = (t1 - 2.0 * t2 + t3) / (lengthscale**4)
    return torch.clamp(prior - corr, min=0.0).to(cands.dtype)


def uncertainty_scores_clients_fused(cands, xs, binv, pmat, lengthscale: float, prior: float):
    """The same scores through the fused epilogue

        t1 - 2 t2 + t3 = sum_k [ g1 - (2 cross - c.c) o g2 ]_k h_k,

    the order the kernels use (one elementwise pass, one reduction)."""
    h, cross, n1 = _h_cross(cands, xs, lengthscale)
    g1 = torch.einsum("bnc,bck->bnk", h, pmat)
    g2 = torch.einsum("bnc,bck->bnk", h, binv)
    m = g1 - (2.0 * cross - n1[..., None]) * g2
    corr = torch.sum(m * h, dim=-1) / (lengthscale**4)
    return torch.clamp(prior - corr, min=0.0).to(cands.dtype)


def grad_mean_clients(cands, xs, alpha, lengthscale: float):
    """Posterior gradient mean, (N, n, d) -> (N, n, d):

        grad_mu(c) = (1/l^2) [ (h o alpha) @ X - (h . alpha) c ],

    with the validity mask already folded into alpha."""
    h, _, _ = _h_cross(cands, xs, lengthscale)
    w = h * alpha[:, None, :]
    out = torch.einsum("bnc,bcd->bnd", w, xs) - torch.sum(w, dim=-1, keepdim=True) * cands
    return (out / (lengthscale**2)).to(cands.dtype)


def uncertainty_scores(cands, xs, binv, pmat, lengthscale: float, prior: float):
    """Single-client textbook scores: (n, d) -> (n,)."""
    return uncertainty_scores_clients(cands[None], xs[None], binv[None], pmat[None],
                                      lengthscale, prior)[0]


def grad_mean_batch(cands, xs, alpha, lengthscale: float):
    """Single-client posterior gradient mean J(c)^T alpha (eq. 5):
    (n, d) -> (n, d), with the validity mask already folded into alpha."""
    return grad_mean_clients(cands[None], xs[None], alpha[None], lengthscale)[0]
