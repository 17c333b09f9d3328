"""The single-process multi-round engine (port of ``repro.core.rounds``).

``run_rounds`` runs the rounds in chunks of ``chunk`` rounds: the history
is preallocated on the device and written chunk by chunk at a host-known
round offset, and ``global_value_fn`` is evaluated inside the chunk, so
F(x_r) never round-trips to the host mid-chunk.  Between the rounds of a
chunk nothing runs (the deferred engine's ``needs_repair`` flags persist
to the boundary, as in the reference's scan); after every chunk the
flagged clients are repaired.

On the card each chunk of a capturable engine (``graphs.captures``: the
deferred client-batched FZooS engine and the FD baselines, on the
``ClientDraws`` draw source) is one replay of a captured CUDA graph, the
port's counterpart of the reference's one jitted ``lax.scan`` per chunk
(``core/graphs.py``).  The other engines run the same chunk code eagerly.

The boundary decides the repair on the host: ``repair_flagged_clients``
reads the (N,) flags once per chunk, where the reference decides under
``lax.cond`` on the device (``boundary_repair_on_device``); the eigh of a
repair checks its errors on the host, so it cannot run inside a graph.

``simulate(..., chunk=0)`` keeps the per-round loop, the equivalence
oracle, which repairs after every round.
"""

from __future__ import annotations

from typing import Any, Callable

import torch

from repro_torch.core import algorithms as alg
from repro_torch.core import gp_surrogate as gp
from repro_torch.core import graphs

GlobalValueFn = Callable[[Any, torch.Tensor], torch.Tensor]

#: Chunk length of ``simulate(..., chunk=None)``, as in the reference.
DEFAULT_CHUNK = 16


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


def history_init(rounds: int, x0: torch.Tensor, f0: torch.Tensor) -> alg.SimResult:
    """The preallocated per-round history on x0's device, row 0 set: the
    buffers are the eventual ``SimResult``, filled chunk by chunk."""
    dev = x0.device
    zeros = lambda n: torch.zeros((n,), dtype=torch.float32, device=dev)
    xs = torch.zeros((rounds + 1, x0.shape[-1]), dtype=x0.dtype, device=dev)
    xs[0] = x0
    f_values = zeros(rounds + 1)
    f_values[0] = torch.as_tensor(f0, dtype=torch.float32, device=dev)
    return alg.SimResult(xs, f_values, *(zeros(rounds) for _ in range(7)))


def hist_write(hist: alg.SimResult, ys, offset: int) -> None:
    """Write a chunk's stacked per-round outputs (x, F, queries, cos,
    disparity, refactor, repair, drop, quarantine) at round ``offset``."""
    k = ys[0].shape[0]
    hist.xs[offset + 1:offset + 1 + k] = ys[0]
    hist.f_values[offset + 1:offset + 1 + k] = ys[1]
    for buf, y in zip(hist[2:], ys[2:]):
        buf[offset:offset + k] = y


def chunk_fn(cfg, rff, query_fn, cobjs, draws, global_value_fn: GlobalValueFn,
             diag_global_grad, length: int, eval_every: int, rounds_total: int):
    """``length`` rounds with nothing between them: returns
    ``chunk(states, sx, offset) -> (states, last server iterate, ys)``,
    ``ys`` the per-round outputs stacked along a leading axis of ``length``
    and ``offset`` the chunk's first round as a 0-d int64 tensor on the
    device.  F is evaluated every round; with ``eval_every > 1`` it holds
    NaN on the rounds the reference skips (the absolute 1-based round not a
    multiple of ``eval_every`` and not ``rounds_total``, the run's last),
    selected on the device from ``offset``, so a captured chunk serves
    every offset."""

    def chunk(states, sx, offset):
        rows = []
        for i in range(length):
            states, stats = alg.run_round(cfg, rff, query_fn, cobjs, states, sx, draws,
                                          diag_global_grad)
            sx = stats.server_x
            f = torch.as_tensor(global_value_fn(cobjs, sx), dtype=torch.float32)
            if eval_every > 1:
                r1 = offset + (i + 1)
                want = (r1 % eval_every == 0) | (r1 == rounds_total)
                f = torch.where(want, f, torch.full_like(f, float("nan")))
            rows.append((sx, f, stats.queries_per_client, stats.mean_cos, stats.mean_disparity,
                         stats.refactor_rate, stats.repair_rate, stats.drop_rate,
                         stats.quarantine_rate))
        ys = tuple(torch.stack(col) for col in zip(*rows))
        return states, sx, ys

    return chunk


def run_rounds(cfg, rff, query_fn, cobjs, states, x0: torch.Tensor,
               global_value_fn: GlobalValueFn, rounds: int, chunk: int, *, draws,
               diag_global_grad=None, eval_every: int = 1):
    """Run ``rounds`` communication rounds in chunks of ``chunk`` rounds;
    returns (final stacked ClientState, SimResult history).

    Full chunks first, then a shorter last one; after every chunk the
    deferred engine's flagged clients are repaired.  On a CUDA device a
    capturable engine (``graphs.captures``) replays one captured graph per
    chunk length; every other engine, and every engine on the CPU, runs the
    same chunk eagerly.  A capture that fails raises.
    """
    if rounds < 0:
        raise ValueError(f"rounds must be >= 0, got {rounds}")
    if chunk < 1:
        raise ValueError("run_rounds requires chunk >= 1 (chunk=0 selects the "
                         "Python-loop oracle in simulate)")
    if eval_every < 1:
        raise ValueError(f"eval_every must be >= 1, got {eval_every}")
    chunk = min(chunk, max(rounds, 1))
    dev = x0.device
    hist = history_init(rounds, x0, global_value_fn(cobjs, x0))
    make = lambda k, d: chunk_fn(cfg, rff, query_fn, cobjs, d, global_value_fn,
                                 diag_global_grad, k, eval_every, rounds)
    captured = None
    if rounds and graphs.captures(cfg, draws, dev):
        captured = graphs.CapturedChunks(make, draws, states, x0)
    sx, done = x0, 0
    while done < rounds:
        k = min(chunk, rounds - done)
        if captured is not None:
            ys = captured.run(k, done)
            states, sx = captured.states, captured.sx
        else:
            offset = torch.full((), done, dtype=torch.int64, device=dev)
            states, sx, ys = make(k, draws)(states, sx, offset)
        hist_write(hist, ys, done)
        done += k
        states, n_repaired = repair_flagged_clients(states, cfg)
        if captured is not None and n_repaired:
            captured.load(states)
    return states, hist
