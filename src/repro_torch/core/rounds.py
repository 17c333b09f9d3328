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

``checkpoint_dir`` checkpoints the run at chunk boundaries, after the
repair (``checkpoint/io.py``): the stacked state, the history and the draw
source's generator states, so a resumed run is bit for bit the run that
was not stopped, on the CPU and in captured chunks alike.

``simulate(..., chunk=0)`` keeps the per-round loop, the equivalence
oracle, which repairs after every round.

Faults (``faults.FaultConfig``): every round of a chunk reads its draws
from the run's ``FaultSchedule`` at the absolute round ``offset + i``, a
device tensor, so one captured chunk serves every offset.  The faulted
boundary reads the host once: whether the server iterate is finite, and
the N quarantine flags.  A non-finite iterate (a run without tolerance,
poisoned) raises ``FloatingPointError`` before anything is written, as
the reference does without a ``checkpoint_dir``; with one, the
reference rolls the chunk back, which is not ported yet (ROADMAP Queue A,
A10b), so it raises too.  After the repair, the tolerant engine restarts
the quarantined clients at the server iterate (``make_quarantine_reset``;
the reference's ``boundary_quarantine_reset``).  Quarantines persist to
the boundary, so a chunked run is its loop bit for bit only where no
client is quarantined in a round that does not end a chunk: the loop
resets after every round.
"""

from __future__ import annotations

from functools import partial
from typing import Any, Callable, Optional

import torch

from repro_torch.checkpoint import io as ckpt_io
from repro_torch.core import algorithms as alg
from repro_torch.core import gp_surrogate as gp
from repro_torch.core import graphs
from repro_torch.faults import injector

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


def quarantine_reset_flagged(states, cfg, server_x, reset=None):
    """Restart the quarantined clients at ``server_x``; returns (states,
    count).  Reads the (N,) flags to the host and returns ``states``
    itself when none is raised (the loop's reset; chunks read the flags
    with the boundary's finiteness check).  ``reset`` is
    ``make_quarantine_reset(cfg, ...)``'s function, built here if None."""
    n = int(states.quarantined.sum())
    if n == 0:
        return states, 0
    if reset is None:
        reset = alg.make_quarantine_reset(cfg, states.x.device)
    return reset(states, server_x), n


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
             diag_global_grad, length: int, eval_every: int, rounds_total: int, faults=None):
    """``length`` rounds with nothing between them: returns
    ``chunk(states, sx, offset) -> (states, last server iterate, ys)``,
    ``ys`` the per-round outputs stacked along a leading axis of ``length``
    and ``offset`` the chunk's first round as a 0-d int64 tensor on the
    device.  F is evaluated every round; with ``eval_every > 1`` it holds
    NaN on the rounds the reference skips (the absolute 1-based round not a
    multiple of ``eval_every`` and not ``rounds_total``, the run's last),
    selected on the device from ``offset``, so a captured chunk serves
    every offset.  ``faults`` (a ``FaultSchedule``) is read at the
    absolute round ``offset + i``, on the device as well."""

    def chunk(states, sx, offset):
        rows = []
        for i in range(length):
            states, stats = alg.run_round(
                cfg, rff, query_fn, cobjs, states, sx, draws, diag_global_grad, faults=faults,
                round_idx=None if faults is None else offset + i)
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


def _restore_newest_good(checkpoint_dir: str, run_meta: dict, rounds: int, x0: torch.Tensor,
                         states_like, draws_like):
    """Restore from the newest complete, uncorrupted checkpoint step.

    A step whose meta is unreadable or whose arrays fail the integrity
    checks (``CorruptCheckpointError``) is skipped with a printed line and
    the next older one is tried.  A step of another run identity raises.
    Returns ``(states, hist, draws_state, start)``; ``hist`` is None when
    nothing under ``checkpoint_dir`` restores.
    """
    for step in sorted(ckpt_io.list_steps(checkpoint_dir), reverse=True):
        try:
            saved = ckpt_io.load_meta(checkpoint_dir, step).get("extra") or {}
        except (OSError, ValueError) as e:
            print(f"[repro_torch.rounds] checkpoint step {step}: unreadable meta ({e}); "
                  "trying an older step")
            continue
        for field in ("rounds", "cfg", "eval_every", "faults"):
            if saved.get(field) not in (None, run_meta[field]):
                raise ValueError(
                    f"checkpoint_dir {checkpoint_dir!r} holds a run with "
                    f"{field}={saved[field]!r}, cannot resume it with "
                    f"{field}={run_meta[field]!r}; point at a fresh directory")
        hist_like = history_init(rounds, x0, torch.zeros((), dtype=torch.float32))
        try:
            states, hist, draws, start = ckpt_io.restore_round_state(
                checkpoint_dir, states_like, hist_like, step=step, draws_like=draws_like)
        except (ckpt_io.CorruptCheckpointError, OSError) as e:
            print(f"[repro_torch.rounds] checkpoint step {step}: corrupt ({e}); "
                  "trying an older step")
            continue
        return states, hist, draws, min(start, rounds)
    return states_like, None, None, 0


def run_rounds(cfg, rff, query_fn, cobjs, states, x0: torch.Tensor,
               global_value_fn: GlobalValueFn, rounds: int, chunk: int, *, draws,
               diag_global_grad=None, eval_every: int = 1,
               checkpoint_dir: Optional[str] = None, checkpoint_every: int = 1,
               async_checkpoint: bool = True, faults: Optional[injector.FaultConfig] = None):
    """Run ``rounds`` communication rounds in chunks of ``chunk`` rounds;
    returns (final stacked ClientState, SimResult history).

    Full chunks first, then a shorter last one; after every chunk the
    deferred engine's flagged clients are repaired.  On a CUDA device a
    capturable engine (``graphs.captures``) replays one captured graph per
    chunk length; every other engine, and every engine on the CPU, runs the
    same chunk eagerly.  A capture that fails raises.

    ``checkpoint_dir`` checkpoints {states, history, draws} every
    ``checkpoint_every`` chunks and at the last round; when a checkpoint
    exists the run restarts from the newest good
    step, its history and generator states included (the initial
    ``global_value_fn`` evaluation is then skipped, and ``x0`` is only the
    template of the history).  The draw source must have ``state()`` and
    ``load_state()``.  Chunks after a resume start at the restored round,
    so a resume with the same ``chunk`` and ``checkpoint_every`` meets the
    same boundaries and is bit for bit the run that was not stopped; a
    resume with another ``chunk`` moves the boundary repairs.  The write
    goes to a background thread (``async_checkpoint``) after a
    synchronous host snapshot; the last boundary's write is drained before
    the run returns, and a write's error fails the run.

    ``faults`` runs the chunks under that ``FaultConfig`` (module
    docstring); one that can never fire in ``[0, rounds)`` runs the
    faults-free engine.  It is part of the run's identity: a checkpoint
    names it, and a resume with another one raises.
    """
    if rounds < 0:
        raise ValueError(f"rounds must be >= 0, got {rounds}")
    if chunk < 1:
        raise ValueError("run_rounds requires chunk >= 1 (chunk=0 selects the "
                         "Python-loop oracle in simulate)")
    if eval_every < 1:
        raise ValueError(f"eval_every must be >= 1, got {eval_every}")
    if checkpoint_dir and not (callable(getattr(draws, "state", None))
                               and callable(getattr(draws, "load_state", None))):
        raise TypeError(f"checkpoint_dir needs a draw source with state() and load_state(); "
                        f"{type(draws).__name__} has not both, so its generators could not "
                        "be resumed")
    faults = injector.effective_config(faults, rounds)
    chunk = min(chunk, max(rounds, 1))
    dev = x0.device
    # The run's identity, recorded at every write and checked at resume;
    # ``chunk`` is recorded but not checked (the boundaries' cadence only).
    run_meta = {"rounds": rounds, "chunk": chunk, "cfg": repr(cfg),
                "eval_every": eval_every, "faults": repr(faults)}
    start, hist = 0, None
    if checkpoint_dir and ckpt_io.latest_step(checkpoint_dir) is not None:
        r_states, r_hist, r_draws, start = _restore_newest_good(
            checkpoint_dir, run_meta, rounds, x0, states, draws.state())
        if r_hist is not None:
            states, hist = r_states, r_hist
            draws.load_state(r_draws)
    if hist is None:
        hist = history_init(rounds, x0, global_value_fn(cobjs, x0))
    sx = hist.xs[start]
    schedule = reset = None
    if faults is not None:
        schedule = injector.FaultSchedule(faults, rounds, states.client_id)
        if faults.tolerate:
            reset = alg.make_quarantine_reset(cfg, dev)
    make = lambda k, d: chunk_fn(cfg, rff, query_fn, cobjs, d, global_value_fn,
                                 diag_global_grad, k, eval_every, rounds, faults=schedule)
    captured = None
    if rounds > start and graphs.captures(cfg, draws, dev):
        captured = graphs.CapturedChunks(make, draws, states, sx)
    writer = ckpt_io.AsyncCheckpointWriter() if checkpoint_dir and async_checkpoint else None
    done, chunks_done = start, 0
    try:
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
            chunks_done += 1
            restart = False
            if schedule is not None:
                # the faulted boundary's one host read: sx finite, the flags
                read = torch.cat([torch.isfinite(sx).all()[None], states.quarantined]).cpu()
                if not bool(read[0]):
                    raise FloatingPointError(_poisoned(done, checkpoint_dir))
                restart = reset is not None and bool(read[1:].any())
            states, n_repaired = repair_flagged_clients(states, cfg)
            if restart:
                states = reset(states, sx)
            if captured is not None and (n_repaired or restart):
                captured.load(states)
            if checkpoint_dir and (chunks_done % max(checkpoint_every, 1) == 0
                                   or done == rounds):
                # the snapshot completes before the next chunk overwrites
                # the state; only the file I/O goes to the writer thread
                payload = ckpt_io.prepare_round_state(states, hist, draws.state())
                write = partial(ckpt_io.write_round_state, checkpoint_dir, done, payload,
                                run_meta)
                if writer is None:
                    write()
                else:
                    writer.submit(write)
                    if done >= rounds:  # no later submit would surface its error
                        writer.wait()
    finally:
        if writer is not None:
            writer.wait()
    return states, hist


def _poisoned(done: int, checkpoint_dir: Optional[str]) -> str:
    """The error of a chunk whose server iterate is not finite."""
    if not checkpoint_dir:
        return (f"non-finite server iterate at round {done} with no checkpoint_dir to "
                "roll back to (chunk rollback needs checkpointing)")
    return (f"non-finite server iterate at round {done}: rolling the chunk back to the last "
            f"good checkpoint under {checkpoint_dir!r} is not ported yet (ROADMAP Queue A, "
            "A10b)")
