"""Finite-difference directions (port of ``repro.core.fd``).

Only what the FZooS state needs is ported here: the direction sampler that
fills the constant ``fd_bank`` of Prop. D.4 and the per-call query count.
The FD gradient estimator itself belongs to the FD baselines, which are
not part of this package yet.
"""

from __future__ import annotations

import torch


def sample_directions(gen: torch.Generator, q: int, dim: int) -> torch.Tensor:
    """u_q ~ N(0, I) as in the paper (Lemma D.1): (q, dim)."""
    return torch.randn(q, dim, generator=gen, device=gen.device)


def fd_queries(q: int) -> int:
    """Queries consumed per finite-difference estimate (Q perturbed + 1)."""
    return q + 1
