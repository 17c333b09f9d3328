"""Plain torch oracles of the GP kernels (port of ``repro.kernels.ref``).

They are the numerical ground truth of the port's CUDA kernels and the
path a CPU tensor takes through ``kernels.ops``.  The ``*_clients`` forms
carry a leading client axis N: candidates (N, n, d), trajectory xs
(N, cap, d), the masked Gram inverse B and P = B o XX^T (N, cap, cap),
alpha (N, cap).  ``uncertainty_scores`` and ``grad_mean_batch`` are the
single-client forms: the same shapes without N.
"""

from __future__ import annotations

import torch


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
