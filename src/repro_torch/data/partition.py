"""Federated heterogeneity partitioners (port of ``repro.data.partition``;
paper Appx. E.2/E.3).

The paper controls client heterogeneity two ways:

* synthetic: Dirichlet(1/N) weights per dimension (Appx. E.1) -- that lives
  in core/objectives.py;
* real data: each client sees only ``P * n_classes`` label classes
  (Appx. E.2: CIFAR/MNIST attack models; E.3: Covertype metric fine-tuning).
  A larger P means MORE shared classes and hence LESS heterogeneity.

These partitioners operate on numpy label arrays and return per-client
index sets (no sample duplicated within a client, every client non-empty).
They are the reference's numpy code, copied so that the port imports
nothing of the reference: the same draws, the same index arrays, the same
validation and messages.
"""

from __future__ import annotations

import numpy as np


def _check_n_clients(n_clients: int) -> None:
    if not isinstance(n_clients, (int, np.integer)) or n_clients < 1:
        raise ValueError(f"n_clients={n_clients!r} must be an int >= 1")


def label_subset_partition(
    labels: np.ndarray,
    n_clients: int,
    p_shared: float,
    seed: int = 0,
    min_per_client: int = 8,
) -> list[np.ndarray]:
    """Paper E.2/E.3: client i samples floor(P * C) classes and takes all
    points of those classes.  P = 1 -> every client sees everything."""
    # Validate up front: p_shared > 1 would crash deep inside rng.choice
    # with an opaque "cannot take a larger sample" error, and p_shared <= 0
    # would silently degenerate to 1 class per client.
    _check_n_clients(n_clients)
    if not (np.isfinite(p_shared) and 0.0 < p_shared <= 1.0):
        raise ValueError(
            f"p_shared={p_shared!r} must be a fraction in (0, 1] of the label "
            "classes each client sees (paper Appx. E.2: larger P = less "
            "heterogeneity)"
        )
    rng = np.random.default_rng(seed)
    classes = np.unique(labels)
    n_take = max(int(round(p_shared * len(classes))), 1)
    out = []
    for _ in range(n_clients):
        chosen = rng.choice(classes, size=n_take, replace=False)
        idx = np.where(np.isin(labels, chosen))[0]
        if len(idx) < min_per_client:
            # Degenerate draw; pad from the COMPLEMENT of the chosen points
            # -- sampling from all points could duplicate an index already
            # in `idx`, violating the no-duplicates-within-a-client
            # guarantee above.
            pool = np.setdiff1d(np.arange(len(labels)), idx)
            take = min(min_per_client - len(idx), len(pool))
            extra = rng.choice(pool, size=take, replace=False)
            idx = np.concatenate([idx, extra])
        out.append(np.sort(idx))
    return out


def dirichlet_partition(
    labels: np.ndarray, n_clients: int, alpha: float, seed: int = 0
) -> list[np.ndarray]:
    """Standard non-IID Dirichlet split: class-c points divided across
    clients with proportions ~ Dir(alpha).  Disjoint and exhaustive."""
    # alpha <= 0 is outside the Dirichlet domain; numpy "accepts" it and
    # returns NaN proportions, silently emptying every client.
    _check_n_clients(n_clients)
    if not (np.isfinite(alpha) and alpha > 0.0):
        raise ValueError(
            f"alpha={alpha!r} must be a positive finite Dirichlet "
            "concentration (smaller alpha = more heterogeneity)"
        )
    rng = np.random.default_rng(seed)
    out: list[list[int]] = [[] for _ in range(n_clients)]
    for c in np.unique(labels):
        idx = np.where(labels == c)[0]
        rng.shuffle(idx)
        props = rng.dirichlet(np.full(n_clients, alpha))
        cuts = (np.cumsum(props)[:-1] * len(idx)).astype(int)
        for i, part in enumerate(np.split(idx, cuts)):
            out[i].extend(part.tolist())
    return [np.sort(np.array(ix, dtype=np.int64)) for ix in out]
