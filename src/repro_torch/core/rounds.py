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
the N quarantine flags.  After the repair, the tolerant engine restarts
the quarantined clients at the server iterate (``make_quarantine_reset``;
the reference's ``boundary_quarantine_reset``).  Quarantines persist to
the boundary, so a chunked run is its loop bit for bit only where no
client is quarantined in a round that does not end a chunk: the loop
resets after every round.

Chunk rollback (the reference's): a faulted run with a ``checkpoint_dir``
writes one step before its first chunk (the insurance), so a restore
target always exists.  A non-finite server iterate at a boundary (a run
without tolerance, poisoned), or a checkpoint write that fails with an
``OSError`` under faults, restores the newest good step (its state, its
history and its generators), turns tolerance on and runs the lost rounds
again, at most ``max_rollbacks`` times; nothing poisoned is written.  On
the card the tolerant chunks are captured afresh: no graph of the chunk
without tolerance is replayed after the turn.  Without a
``checkpoint_dir``, with the budget spent, or with nothing to restore,
the boundary raises ``FloatingPointError``.  Without faults a failed
write fails the run.
"""

from __future__ import annotations

import dataclasses
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


def run_identity(rounds: int, chunk: int, cfg, eval_every: int, faults,
                 identity: Optional[dict] = None) -> dict:
    """The run's identity, recorded in every step's ``extra`` and checked at
    resume (``newest_good``): the reference's fields, then the caller's
    ``identity`` (the launcher's seed and objective arguments, the pool's
    size, cohort and cohort seed).  ``chunk`` is recorded, never checked:
    it sets only the boundaries' cadence."""
    meta = {"rounds": rounds, "chunk": chunk, "cfg": repr(cfg), "eval_every": eval_every,
            "faults": repr(faults)}
    for field, value in (identity or {}).items():
        if field in meta:
            raise ValueError(f"identity field {field!r} is one of the run's own")
        meta[field] = value
    return meta


def newest_good(checkpoint_dir: str, run_meta: dict, restore: Callable[[int], Any],
                 who: str = "rounds"):
    """``restore(step)`` of the newest complete, uncorrupted step, or None.

    A step whose meta is unreadable or whose arrays fail the integrity
    checks (``CorruptCheckpointError``, ``OSError``) is skipped with a
    printed line and the next older one is tried.  A step of another run
    identity raises: every field of ``run_meta`` but ``chunk`` is compared,
    and a field that the step does not record is not (a step of an older
    version resumes)."""
    for step in sorted(ckpt_io.list_steps(checkpoint_dir), reverse=True):
        try:
            saved = ckpt_io.load_meta(checkpoint_dir, step).get("extra") or {}
        except (OSError, ValueError) as e:
            print(f"[repro_torch.{who}] checkpoint step {step}: unreadable meta ({e}); "
                  "trying an older step")
            continue
        for field, want in run_meta.items():
            if field != "chunk" and saved.get(field) not in (None, want):
                raise ValueError(
                    f"checkpoint_dir {checkpoint_dir!r} holds a run with "
                    f"{field}={saved[field]!r}, cannot resume it with "
                    f"{field}={want!r}; point at a fresh directory")
        try:
            return restore(step)
        except (ckpt_io.CorruptCheckpointError, OSError) as e:
            print(f"[repro_torch.{who}] checkpoint step {step}: corrupt ({e}); "
                  "trying an older step")
    return None


def _restore_newest_good(checkpoint_dir: str, run_meta: dict, rounds: int, x0: torch.Tensor,
                         states_like, draws_like):
    """Restore from the newest complete, uncorrupted checkpoint step
    (``newest_good``).  Returns ``(states, hist, draws_state, start)``;
    ``hist`` is None when nothing under ``checkpoint_dir`` restores."""
    def restore(step):
        hist_like = history_init(rounds, x0, torch.zeros((), dtype=torch.float32))
        states, hist, draws, start = ckpt_io.restore_round_state(
            checkpoint_dir, states_like, hist_like, step=step, draws_like=draws_like)
        return states, hist, draws, min(start, rounds)

    got = newest_good(checkpoint_dir, run_meta, restore)
    return got if got is not None else (states_like, None, None, 0)


def write_boundary(writer, write: Callable[[], Any], final: bool, faulted: bool,
                   done: int, who: str = "rounds") -> bool:
    """One boundary's checkpoint: ``write()`` now, or on ``writer``'s thread
    (a submit surfaces the previous write's error; the last boundary is
    drained at once, so its error is this boundary's and not the run's
    end).  Returns False when a write failed with an ``OSError`` under
    faults (the caller rolls back); without faults the error fails the
    run."""
    try:
        if writer is None:
            write()
        else:
            writer.submit(write)
            if final:
                writer.wait()
    except OSError as e:
        if not faulted:
            raise
        print(f"[repro_torch.{who}] checkpoint write failed at round {done}: {e}")
        return False
    return True


def rollback_or_raise(reason: str, done: int, checkpoint_dir: Optional[str], rollbacks: int,
                      max_rollbacks: int, writer, who: str = "rounds") -> int:
    """The checks of a rollback at round ``done`` (the reference's three
    errors): raises ``FloatingPointError`` without a ``checkpoint_dir`` or
    with the budget spent; else drains ``writer`` (a failed write is the
    fault being rolled back), prints the ROLLBACK line and returns the
    count with this one."""
    if not checkpoint_dir:
        raise FloatingPointError(f"{reason} at round {done} with no checkpoint_dir to roll "
                                 "back to (chunk rollback needs checkpointing)")
    if rollbacks >= max_rollbacks:
        raise FloatingPointError(f"{reason} at round {done}: rollback budget "
                                 f"max_rollbacks={max_rollbacks} exhausted")
    if writer is not None:
        try:
            writer.wait()
        except OSError:
            pass
    rollbacks += 1
    print(f"[repro_torch.{who}] ROLLBACK {rollbacks}/{max_rollbacks} at round {done} "
          f"({reason}): restoring last good checkpoint")
    return rollbacks


def nothing_to_restore(done: int, checkpoint_dir: str) -> FloatingPointError:
    return FloatingPointError(f"rollback at round {done} failed: no restorable checkpoint "
                              f"under {checkpoint_dir!r}")


def tolerant(fcfg, who: str = "rounds"):
    """``fcfg`` with tolerance on, printing the turn when it was off."""
    if fcfg.tolerate:
        return fcfg
    print(f"[repro_torch.{who}] re-running with fault tolerance FORCED ON")
    return dataclasses.replace(fcfg, tolerate=True)


def run_rounds(cfg, rff, query_fn, cobjs, states, x0: torch.Tensor,
               global_value_fn: GlobalValueFn, rounds: int, chunk: int, *, draws,
               diag_global_grad=None, eval_every: int = 1,
               checkpoint_dir: Optional[str] = None, checkpoint_every: int = 1,
               async_checkpoint: bool = True, faults: Optional[injector.FaultConfig] = None,
               max_rollbacks: int = 3, identity: Optional[dict] = None):
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
    the run returns.

    ``faults`` runs the chunks under that ``FaultConfig`` (module
    docstring); one that can never fire in ``[0, rounds)`` runs the
    faults-free engine.  A poisoned boundary or a failed write under faults
    rolls the run back, at most ``max_rollbacks`` times (module
    docstring).  ``identity`` adds the caller's fields to the run's
    identity (``run_identity``): a checkpoint names them with the config
    and the faults, and a resume with another value raises.
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
    run_meta = run_identity(rounds, chunk, cfg, eval_every, faults, identity)
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
    fcfg = faults

    def engine(states, sx, done):
        """(schedule, reset, chunk maker, captured chunks) of ``fcfg``."""
        schedule = reset = captured = None
        if fcfg is not None:
            schedule = injector.FaultSchedule(fcfg, rounds, cfg.n_clients, dev)
            if fcfg.tolerate:
                reset = alg.make_quarantine_reset(cfg, dev)
        make = lambda k, d: chunk_fn(cfg, rff, query_fn, cobjs, d, global_value_fn,
                                     diag_global_grad, k, eval_every, rounds, faults=schedule)
        if rounds > done and graphs.captures(cfg, draws, dev):
            captured = graphs.CapturedChunks(make, draws, states, sx)
        return schedule, reset, make, captured

    schedule, reset, make, captured = engine(states, sx, start)
    writer = ckpt_io.AsyncCheckpointWriter() if checkpoint_dir and async_checkpoint else None
    if fcfg is not None and checkpoint_dir and ckpt_io.latest_step(checkpoint_dir) is None:
        # the insurance: a restore target before the first faulted chunk
        ckpt_io.write_round_state(checkpoint_dir, start,
                                  ckpt_io.prepare_round_state(states, hist, draws.state()),
                                  run_meta)
    done, chunks_done, rollbacks = start, 0, 0
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
            ok = wrote = True
            if schedule is not None:
                # the faulted boundary's one host read: sx finite, the flags
                read = torch.cat([torch.isfinite(sx).all()[None], states.quarantined]).cpu()
                ok = bool(read[0])
            if ok:
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
                    wrote = write_boundary(
                        writer, partial(ckpt_io.write_round_state, checkpoint_dir, done,
                                        payload, run_meta),
                        done >= rounds, fcfg is not None, done)
            if ok and wrote:
                continue
            reason = "non-finite server iterate" if not ok else "checkpoint write failure"
            rollbacks = rollback_or_raise(reason, done, checkpoint_dir, rollbacks,
                                          max_rollbacks, writer)
            r_states, r_hist, r_draws, r_start = _restore_newest_good(
                checkpoint_dir, run_meta, rounds, x0, states, draws.state())
            if r_hist is None:
                raise nothing_to_restore(done, checkpoint_dir)
            states, hist, done = r_states, r_hist, r_start
            draws.load_state(r_draws)
            sx = hist.xs[done]
            chunks_done = 0
            if not fcfg.tolerate:
                fcfg = tolerant(fcfg)
                schedule, reset, make, captured = engine(states, sx, done)
            elif captured is not None:
                captured.load(states, sx)
    finally:
        if writer is not None:
            writer.wait()
    return states, hist
