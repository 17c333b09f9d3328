"""Between-round repair of the deferred engine (port of
``repro.core.rounds.repair_flagged_clients``, single-process path)."""

from __future__ import annotations

import torch

from repro_torch.core import gp_surrogate as gp


def repair_flagged_clients(states, cfg):
    """Repair every client flagged ``needs_repair``; returns (states, count).

    Reads the (N,) flag vector to the host; when clients are flagged, one
    batched clamped eigh over exactly those clients' Grams restores them.
    A no-op for the engines that do not defer repairs (they never flag).
    """
    if not cfg.deferred:
        return states, 0
    flags = states.factor.needs_repair
    idx = torch.nonzero(flags).flatten()
    if idx.numel() == 0:
        return states, 0
    jitter = max(float(cfg.noise), 1e-4)
    sub = gp.GramFactor(*(a[idx] for a in states.factor))
    rep = gp.factor_repair_masked(sub, jitter)
    merged = []
    for full, part in zip(states.factor, rep):
        full = full.clone()
        full[idx] = part
        merged.append(full)
    return states._replace(factor=gp.GramFactor(*merged)), int(idx.numel())
