"""Chunk rollback of the port's round engine (``repro_torch.core.rounds``)
against the reference's (``repro.core.rounds.run_rounds``, its rollback
branch; tests/test_faults.py).

A run without tolerance whose NaN payloads poison the server iterate, with
a ``checkpoint_dir``: the boundary finds the iterate not finite, restores
the newest good step (the insurance step 0 at the latest), turns tolerance
on and runs the lost rounds again.  On the reference's draws, recorded
round by round from its keys in the order the engine consumes them (the
poisoned chunk's draws, then the re-run's), the port rolls back at the
same round to the same step the same number of times as the reference's
own ``run_rounds``, prints the same lines and counts the same queries
and clients, in chunks of 1 (the per-round cadence) and of 2; in chunks
of 1 its F and x follow the engines' bounds through the float64 witness.

The errors are the reference's: no ``checkpoint_dir``, the budget spent,
nothing to restore.  A failed write under faults rolls back, the last
boundary's too; without faults it fails the run.  The card-only test
(skipped without one) holds a rolled-back run in captured chunks against
the same run in eager chunks, bit for bit.
"""

import dataclasses
import functools
import importlib
import importlib.util
import os
import shutil
from pathlib import Path
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import faults as rfaults
from repro.core import algorithms as ralg
from repro.core import objectives as robj
from repro.core import rounds as rrounds
from repro_torch import convert
from repro_torch import faults
from repro_torch.checkpoint import io
from repro_torch.core import algorithms as alg
from repro_torch.core import graphs
from repro_torch.core import objectives as obj
from repro_torch.core import rounds


def _port_tests(name):
    """Another test file of the port, for its helpers."""
    path = Path(__file__).resolve().parent / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"_{name}_rollback_helpers", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


TA = _port_tests("test_torch_algorithms")
TR = _port_tests("test_torch_rounds")
port64 = TA.port64  # the port in float64, the witness of TA.assert_tracks

D, N, ROUNDS, KEY = 8, 5, 8, 3
KW = dict(TA.KW, n_clients=N)
POISON = dict(seed=KEY, nan_rate=0.3, tolerate=False)
N_ = lambda a: np.asarray(a)


@pytest.fixture(scope="module")
def quads():
    rq = robj.make_quadratic(jax.random.PRNGKey(0), N, D, 5.0, 0.001)
    return rq, convert.quadratic(jax.tree_util.tree_map(np.asarray, rq), "cpu")


class InOrderDraws(TA.RecordedDraws):
    """Recorded draws handed out in the order they were recorded, across a
    rollback too: the engine restores its draw state, and the re-run's
    draws, recorded from the reference's restored keys, come next."""

    def load_state(self, states):
        pass

    def widened(self):
        out = InOrderDraws(n=self.n)
        wide = TA.RecordedDraws.widened(self)
        out.banks, out.deltas_, out.noise_, out.directions_ = (
            wide.banks, wide.deltas_, wide.noise_, wide.directions_)
        return out


_ROUND_FNS = {}


def _ref_round(fcfg, rq, rff):
    if fcfg not in _ROUND_FNS:
        rcfg = ralg.AlgoConfig(**KW)
        mean_fn = lambda tree: jax.tree_util.tree_map(lambda a: jnp.mean(a, axis=0), tree)
        _ROUND_FNS[fcfg] = jax.jit(lambda st, sx, r: ralg.run_round(
            rcfg, rff, robj.quadratic_query, rq, st, sx, mean_fn,
            sum_fn=lambda a: jnp.sum(a, axis=0), faults=fcfg, round_idx=r))
    return _ROUND_FNS[fcfg]


def ref_rollback_run(rq, chunk, rounds=ROUNDS):
    """The reference's ``run_rounds`` with rollback on ``PRNGKey(KEY)``,
    round by round: its faulted ``run_round`` without tolerance, at every
    boundary the repair (and the quarantine reset once tolerant) and the
    finiteness check; a finite boundary is the newest good step, a
    poisoned one restores it and turns tolerance on.  Returns (history,
    [(round of the fault, round restored)], the draws in the order
    consumed)."""
    rcfg, cfg = ralg.AlgoConfig(**KW), alg.AlgoConfig(**KW)
    k_init, k_rff, _ = jax.random.split(jax.random.PRNGKey(KEY), 3)
    rec = InOrderDraws(n=N)
    rff = ralg.rfflib.make_rff(k_rff, rcfg.n_features, D, rcfg.lengthscale)
    kv, kb = jax.random.split(k_rff)
    rec.banks.append((TA.T(jax.random.normal(kv, (rcfg.n_features, D))),
                      TA.T(jax.random.uniform(kb, (rcfg.n_features,), minval=0.0,
                                              maxval=2.0 * np.pi))))
    fcfg = rfaults.FaultConfig(**POISON)
    x0 = jnp.full((D,), 0.5, jnp.float32)
    states, sx = ralg.init_states(rcfg, k_init, x0), x0
    fields = ("xs", "f_values", "queries", "drop_rate", "quarantine_rate")
    hist = {f: [None] * (rounds + 1) for f in fields}
    hist["xs"][0], hist["f_values"][0] = x0, robj.quadratic_global_value(rq, x0)
    good, done, events = (states, sx, {f: list(v) for f, v in hist.items()}, 0), 0, []
    while done < rounds:
        rnd = _ref_round(fcfg, rq, rff)
        for r in range(done, min(done + chunk, rounds)):
            TA._record_round(cfg, states.key, rec)
            states, stats = rnd(states, sx, jnp.int32(r))
            sx = stats.server_x
            hist["xs"][r + 1] = sx
            hist["f_values"][r + 1] = robj.quadratic_global_value(rq, sx)
            for f in fields[2:]:
                hist[f][r + 1] = getattr(stats, {"queries": "queries_per_client"}.get(f, f))
        done = min(done + chunk, rounds)
        states, _ = rrounds.repair_flagged_clients(states, rcfg)
        if fcfg.tolerate:
            states, _ = rrounds.quarantine_reset_flagged(states, rcfg, sx)
        if np.isfinite(N_(sx)).all():
            good = (states, sx, {f: list(v) for f, v in hist.items()}, done)
            continue
        states, sx, saved, back = good
        hist = {f: list(v) for f, v in saved.items()}
        events.append((done, back))
        done, fcfg = back, dataclasses.replace(fcfg, tolerate=True)
    out = {f: N_(jnp.stack(v[1:] if f in fields[2:] else v)) for f, v in hist.items()}
    return out, events, rec


def _rollback_lines(text):
    return [ln.split("] ", 1)[1] for ln in text.splitlines()
            if "ROLLBACK" in ln or "FORCED ON" in ln]


@functools.lru_cache(maxsize=None)
def _reference_rollback(chunk):
    """The reference's ``simulate`` of the poisoned run in chunks of
    ``chunk`` with a fresh ``checkpoint_dir`` (its history, its printed
    rollback lines, its steps), and ``ref_rollback_run``'s (history,
    events, draws)."""
    import contextlib
    import io as _io
    import tempfile

    rq = robj.make_quadratic(jax.random.PRNGKey(0), N, D, 5.0, 0.001)
    with tempfile.TemporaryDirectory() as root:
        out = _io.StringIO()
        with contextlib.redirect_stdout(out):
            ref = ralg.simulate(ralg.AlgoConfig(**KW), jax.random.PRNGKey(KEY), rq,
                                robj.quadratic_query, robj.quadratic_global_value, ROUNDS,
                                chunk=chunk, checkpoint_dir=root,
                                faults=rfaults.FaultConfig(**POISON))
        steps = sorted(int(d.split("_")[1]) for d in os.listdir(root) if d.startswith("step_"))
    return ref, out.getvalue(), steps, ref_rollback_run(rq, chunk)


def _port_rollback(m, q, draws, root, chunk):
    """``m``'s (the port's, or the float64 port's) ``simulate`` of the
    poisoned run."""
    return m.alg.simulate(m.alg.AlgoConfig(**KW), 0, q, m.obj.quadratic_query,
                          m.obj.quadratic_global_value, ROUNDS, chunk=chunk, draws=draws,
                          device="cpu", checkpoint_dir=root,
                          faults=m.faults.FaultConfig(**POISON))


PORT = SimpleNamespace(alg=alg, obj=obj, faults=faults)


@pytest.mark.parametrize("chunk", [1, 2], ids=["per_round", "chunks_of_2"])
def test_rollback_matches_reference(quads, tmp_path, capsys, chunk):
    """The poisoned run without tolerance, 8 rounds: the port on the
    reference's draws rolls back where the reference's ``run_rounds`` does
    (the same lines, steps, restored round and count), with the same
    queries and counted clients every round as the reference's
    round-by-round run of the same rollback (``ref_rollback_run``, whose
    queries are its ``run_rounds``'), and ends finite."""
    ref, ref_out, ref_steps, (want, events, rec) = _reference_rollback(chunk)
    assert events and [ln for ln in _rollback_lines(ref_out) if "ROLLBACK" in ln] == [
        f"ROLLBACK {i + 1}/3 at round {at} (non-finite server iterate): restoring last good "
        "checkpoint" for i, (at, _) in enumerate(events)]
    np.testing.assert_array_equal(want["queries"], N_(ref.queries))
    draws = InOrderDraws(n=N)
    draws.banks, draws.deltas_, draws.noise_, draws.directions_ = (
        list(rec.banks), list(rec.deltas_), list(rec.noise_), list(rec.directions_))
    capsys.readouterr()
    got = _port_rollback(PORT, quads[1], draws, str(tmp_path / "port"), chunk)
    assert draws.exhausted()
    assert _rollback_lines(capsys.readouterr().out) == _rollback_lines(ref_out)
    assert io.list_steps(str(tmp_path / "port")) == ref_steps
    np.testing.assert_array_equal(got.queries.numpy(), want["queries"])
    for f in ("drop_rate", "quarantine_rate"):
        np.testing.assert_array_equal(np.rint(getattr(got, f).numpy() * N),
                                      np.rint(want[f] * N), err_msg=f)
    assert np.isfinite(got.xs.numpy()).all() and np.isfinite(got.f_values.numpy()).all()


def test_rollback_tracks_float64(quads, port64, tmp_path, capsys):
    """F and x of the rolled-back run in the per-round cadence on the
    reference's draws: within the engines' bounds of the reference's
    round-by-round run, or nearer the float64 witness than it
    (``assert_tracks``).  In chunks of 2 an active-query pick of this run
    lies within float32 rounding of a tie, and each float32 run, the
    port's and the reference's, takes its own branch from round 3 on
    (ROADMAP Queue C): there the rollback is held by its lines, steps,
    queries and counted clients (``test_rollback_matches_reference``)."""
    rq, q = quads
    _, _, _, (want, _, rec) = _reference_rollback(1)
    rec64 = rec.widened()
    draws = InOrderDraws(n=N)
    draws.banks, draws.deltas_, draws.noise_, draws.directions_ = (
        list(rec.banks), list(rec.deltas_), list(rec.noise_), list(rec.directions_))
    got = _port_rollback(PORT, q, draws, str(tmp_path / "port"), 1)

    @functools.cache
    def truth():
        m64 = SimpleNamespace(alg=port64.alg, obj=port64.obj,
                              faults=importlib.import_module("repro_torch_f64.faults"))
        return _port_rollback(m64, port64.convert.quadratic(TA.wide(rq), "cpu"), rec64,
                              str(tmp_path / "f64"), 1)

    for f, tol in (("f_values", TA.F_TOL), ("xs", TA.X_TOL)):
        TA.assert_tracks(getattr(got, f).numpy(), want[f], lambda: getattr(truth(), f), tol, f)


def _sim(q, rounds=ROUNDS, chunk=2, **kw):
    return alg.simulate(alg.AlgoConfig(**KW), 5, q, obj.quadratic_query,
                        obj.quadratic_global_value, rounds, chunk=chunk, device="cpu", **kw)


@pytest.mark.parametrize("case", ["no_checkpoint_dir", "budget_spent"])
def test_rollback_errors_are_the_reference(quads, tmp_path, case):
    """Without a checkpoint_dir, or with ``max_rollbacks=0``, the poisoned
    boundary raises the reference's ``FloatingPointError``, word for word."""
    rq, q = quads
    kw = {} if case == "no_checkpoint_dir" else dict(max_rollbacks=0)
    with pytest.raises(FloatingPointError) as ref:
        ralg.simulate(ralg.AlgoConfig(**KW), jax.random.PRNGKey(5), rq, robj.quadratic_query,
                      robj.quadratic_global_value, ROUNDS, chunk=2,
                      faults=rfaults.FaultConfig(**POISON),
                      checkpoint_dir=None if not kw else str(tmp_path / "ref"), **kw)
    with pytest.raises(FloatingPointError) as got:
        _sim(q, faults=faults.FaultConfig(**POISON),
             checkpoint_dir=None if not kw else str(tmp_path / "port"), **kw)
    assert str(got.value) == str(ref.value)
    assert ("no checkpoint_dir" if not kw else "max_rollbacks=0 exhausted") in str(got.value)


def test_rollback_with_nothing_to_restore_raises(quads, tmp_path, monkeypatch):
    """Every step fails its integrity checks: the rollback names the
    directory it could not restore from."""
    def corrupt(*args, **kwargs):
        raise io.CorruptCheckpointError("damaged")

    monkeypatch.setattr(io, "restore_round_state", corrupt)
    with pytest.raises(FloatingPointError, match="no restorable checkpoint"):
        _sim(quads[1], faults=faults.FaultConfig(**POISON), checkpoint_dir=str(tmp_path))


def test_insurance_step_before_the_first_chunk(quads, tmp_path, monkeypatch):
    """A faulted run in a fresh directory writes step 0 (its state, its
    history's row 0 and its generators, under the run's identity) before
    its first chunk runs; a faults-free run does not."""
    root = str(tmp_path / "ck")
    first = []
    real = rounds.chunk_fn

    def spy(*args, **kwargs):
        first.append(io.list_steps(root))
        return real(*args, **kwargs)

    monkeypatch.setattr(rounds, "chunk_fn", spy)
    _sim(quads[1], rounds=2, faults=faults.FaultConfig(seed=KEY, drop_rate=0.3),
         checkpoint_dir=root)
    assert first[0] == [0] and io.list_steps(root) == [0, 2]
    meta = io.load_meta(root, 0)
    assert meta["extra"]["faults"] == repr(faults.FaultConfig(seed=KEY, drop_rate=0.3))
    assert "draws" in meta["treedef"]
    _sim(quads[1], rounds=2, checkpoint_dir=str(tmp_path / "plain"))
    assert io.list_steps(str(tmp_path / "plain")) == [2]


@pytest.mark.parametrize("faulted", [True, False], ids=["faulted", "faults_free"])
def test_failed_final_write(quads, tmp_path, monkeypatch, capsys, faulted):
    """The last boundary's write fails once: under faults the run rolls back
    to the step before and writes it again; without faults the run fails."""
    real, calls = io.write_round_state, []

    def flaky(root, step, *args, **kwargs):
        calls.append(step)
        if step == 4 and calls.count(4) == 1:
            raise OSError("disk full")
        return real(root, step, *args, **kwargs)

    monkeypatch.setattr(io, "write_round_state", flaky)
    root = str(tmp_path / "ck")
    kw = dict(rounds=4, checkpoint_dir=root, async_checkpoint=False)
    if not faulted:
        with pytest.raises(OSError, match="disk full"):
            _sim(quads[1], **kw)
        return
    res = _sim(quads[1], faults=faults.FaultConfig(seed=KEY, drop_rate=0.3), **kw)
    out = capsys.readouterr().out
    assert "checkpoint write failed at round 4" in out
    assert "ROLLBACK 1/3 at round 4 (checkpoint write failure)" in out
    assert "FORCED ON" not in out and io.list_steps(root) == [0, 2, 4]
    assert np.isfinite(res.xs.numpy()).all()


def test_rollback_restores_the_generators(quads, tmp_path, monkeypatch, capsys):
    """The chunk re-run after a rollback starts from the generator states
    of the step it restored: those its first run started from, and those
    that step holds (its ``draws_*`` members).  Without the restore the
    re-run would draw on from where the poisoned chunk left them."""
    root = str(tmp_path / "ck")
    starts = TR.record_chunk_starts(monkeypatch)
    _sim(quads[1], faults=faults.FaultConfig(**POISON), checkpoint_dir=root,
         draws=alg.ClientDraws(5, range(N), "cpu"))
    assert "ROLLBACK 1/3" in capsys.readouterr().out
    (restored,) = TR.restarted_chunks(starts)
    first, rerun = [s for r, s in starts if r == restored]
    cfg, x0 = alg.AlgoConfig(**KW), torch.full((D,), 0.5)
    _, _, saved, step = io.restore_round_state(
        root, alg.init_states(cfg, x0), rounds.history_init(ROUNDS, x0, torch.zeros(())),
        step=restored, draws_like=alg.ClientDraws(0, range(N), "cpu").state())
    assert step == restored
    assert TR.same_states(rerun, first) and TR.same_states(rerun, saved)
    assert not TR.same_states(rerun, starts[-1][1])  # the draws move on


def test_rolled_back_run_resumes(quads, tmp_path):
    """A rolled-back run's steps resume like any run's: with its last step
    removed, the same call ends bit for bit where the first did."""
    root = str(tmp_path / "ck")
    run = lambda: _sim(quads[1], faults=faults.FaultConfig(**POISON), checkpoint_dir=root,
                       draws=alg.ClientDraws(5, range(N), "cpu"))
    first = run()
    last = io.latest_step(root)
    shutil.rmtree(os.path.join(root, f"step_{last:08d}"))
    TR._assert_bitwise(first, run())


# ---------------------------------------------------------------------------
# On the card (skipped without one)
# ---------------------------------------------------------------------------


def test_cuda_captured_rollback_matches_eager(tmp_path):
    """The poisoned run in captured chunks of 2 rolls back and is bit for
    bit the same run in eager chunks on the same draws, its generators
    too: the restored generator states reach the replays, and no graph of
    the chunk without tolerance is replayed after the turn."""
    dev = TR._cuda()
    cfg = alg.AlgoConfig(**KW)
    q = obj.make_quadratic(0, N, D, 5.0, 0.001, device=dev)
    sim = lambda draws, root: alg.simulate(
        cfg, 5, q, obj.quadratic_query, obj.quadratic_global_value, ROUNDS, chunk=2, draws=draws,
        device=dev, checkpoint_dir=root, faults=faults.FaultConfig(**POISON))
    graphs.COUNTS.update(captures=0, replays=0)
    captured_draws = alg.ClientDraws(5, range(N), dev)
    captured = sim(captured_draws, str(tmp_path / "c"))
    assert graphs.COUNTS["captures"] == 2
    eager_draws = TR._EagerDraws(5, range(N), dev)
    eager = sim(eager_draws, str(tmp_path / "e"))
    assert torch.isfinite(captured.xs).all()
    assert all(torch.equal(a, b) for a, b in zip(captured, eager))
    for a, b in zip(TR._gen_states(eager_draws), TR._gen_states(captured_draws)):
        assert torch.equal(a, b)
