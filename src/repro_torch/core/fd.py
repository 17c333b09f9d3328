"""Finite-difference gradient estimation (port of ``repro.core.fd``; paper
eq. 3), the estimator of the FD baselines (FedZO, FedProx, SCAFFOLD):

    Delta(x) = (1/Q) sum_q (y(x + lam u_q) - y(x)) / lam * u_q

Each estimate consumes Q+1 queries (Q perturbed + 1 at x).  The directions
and the query noise are arguments, drawn by the engine's draw source.
"""

from __future__ import annotations

import torch


def sample_directions(gen: torch.Generator, q: int, dim: int) -> torch.Tensor:
    """u_q ~ N(0, I) as in the paper (Lemma D.1): (q, dim)."""
    return torch.randn(q, dim, generator=gen, device=gen.device)


def fd_grad(query_fn, cobjs, x: torch.Tensor, noise: torch.Tensor, directions: torch.Tensor,
            lam: float) -> torch.Tensor:
    """FD estimate of each client's gradient at its x (N, d): directions
    (N, Q, d), query noise (N, Q+1) with the noise of the query at x first.
    Returns (N, d)."""
    q = directions.shape[-2]
    y0 = query_fn(cobjs, x[:, None, :], noise[:, :1])  # (N, 1)
    ys = query_fn(cobjs, x[:, None, :] + lam * directions, noise[:, 1:])  # (N, Q)
    coef = (ys - y0) / lam
    return torch.sum(coef[..., None] * directions, dim=-2) / q


def fd_queries(q: int) -> int:
    """Queries consumed per finite-difference estimate (Q perturbed + 1)."""
    return q + 1
