"""The port's fault schedule and faulted round engine against the reference
(``repro.faults``, ``run_round(..., faults=...)``; tests/test_faults.py).

The schedule is a pure function of (seed, round, client, kind), and the
port computes the reference's threefry hashes itself: its tables and
per-round draws are the reference's exactly.

The engines run on the reference's injected draws.  The reference's own
keys roll back with a frozen client's state, so its draws are recorded
round by round from ``states.key`` as its engine leaves it
(``ref_run``), never re-derived from the key schedule.  ``ref_run``
drives the reference's jitted faulted ``run_round`` and its boundary (the
deferred repair, then the quarantine reset) after every round, as its
loop does, or after every chunk, as its ``run_rounds`` does; it is held to
the reference's ``simulate`` once.  Queries, the per-client quarantine
flags, drop and quarantine rates and the places of NaN must match
exactly; F and x follow tests/test_torch_algorithms.py's bounds through
its float64 witness (``assert_tracks``).
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

from repro.core import algorithms as ralg
from repro.core import objectives as robj
from repro.core import rounds as rrounds
from repro import faults as rfaults
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
    spec = importlib.util.spec_from_file_location(f"_{name}_fault_helpers", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


TA = _port_tests("test_torch_algorithms")
TR = _port_tests("test_torch_rounds")


def _smoke():
    """chip_smoke.py, for its host-side rule of what a faulted run reports."""
    path = Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("_chip_smoke_fault_rule", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


SMOKE = _smoke()
port64 = TA.port64  # the port in float64, the witness of TA.assert_tracks

D, N, ROUNDS = 8, 5, 4
KEY = 3
KW = dict(TA.KW, n_clients=N)
FD_KW = dict(TA.FD_KW, n_clients=N)
N_ = lambda a: np.asarray(a)

# ---------------------------------------------------------------------------
# The schedule
# ---------------------------------------------------------------------------

RATES = {"mixed": (0.2, 0.1, 0.05, 0.05), "small_and_full": (1e-3, 0.5, 1.0, 0.2),
         "all_full": (1.0, 1.0, 1.0, 1.0), "one_kind": (0.0, 0.0, 0.0, 0.5),
         "zero": (0.0, 0.0, 0.0, 0.0)}
WINDOWS = {"trivial": (0, None), "opened_late": (37, None), "closed_early": (0, 61),
           "both": (5, 150), "empty": (9, 9)}
SCHEDULES = [(seed, rates, window) for seed, rates, window in (
    (0, "mixed", "trivial"), (3, "small_and_full", "opened_late"),
    (11, "all_full", "closed_early"), (2**31 - 1, "one_kind", "both"),
    (-7, "mixed", "empty"), (2**33 + 5, "small_and_full", "trivial"),
    (12345, "zero", "trivial"), (1, "mixed", "both"))]


def _config(module, seed=0, rates=(0.0, 0.0, 0.0, 0.0), window=(0, None), **kw):
    return module.FaultConfig(seed=seed, **dict(zip(
        ("drop_rate", "straggle_rate", "nan_rate", "inf_rate"), rates)),
        first_round=window[0], last_round=window[1], **kw)


@pytest.mark.parametrize("seed,rates,window", SCHEDULES)
def test_schedule_table_matches_reference(seed, rates, window):
    """200 rounds x 64 clients, every kind, exactly the reference's table
    (seeds past 32 bits and negative ones included)."""
    args = dict(seed=seed, rates=RATES[rates], window=WINDOWS[window])
    want = rfaults.schedule_table(_config(rfaults, **args), 200, 64)
    got = faults.schedule_table(_config(faults, **args), 200, 64)
    assert list(got) == list(want) == list(faults.KINDS)
    for kind in faults.KINDS:
        assert got[kind].dtype == bool and got[kind].shape == (200, 64)
        np.testing.assert_array_equal(got[kind], want[kind], err_msg=kind)
    if rates == "mixed" and window == "trivial":
        assert all(got[kind].any() for kind in faults.KINDS)  # every kind fired


def test_draw_faults_matches_reference_per_round():
    """``draw_faults`` of a 0-d round tensor over permuted client ids, and a
    run's ``FaultSchedule`` read round by round, against the reference's
    ``draw_faults``, with a window that opens and closes."""
    args = dict(seed=9, rates=(0.3, 0.2, 0.2, 0.1), window=(2, 15))
    rcfg, cfg = _config(rfaults, **args), _config(faults, **args)
    ids = np.array([5, 2, 7, 0, 1, 3, 4, 6])
    table = faults.FaultSchedule(cfg, 20, len(ids))
    for r in range(20):
        want = rfaults.draw_faults(rcfg, jnp.int32(r), jnp.asarray(ids, jnp.int32))
        got = faults.draw_faults(cfg, torch.tensor(r), torch.tensor(ids, dtype=torch.int32))
        read = table.draw(torch.tensor(r), torch.tensor(ids))
        for kind in faults.KINDS:
            np.testing.assert_array_equal(getattr(got, kind).numpy(), N_(getattr(want, kind)))
            assert torch.equal(getattr(read, kind), getattr(got, kind)), (r, kind)


@pytest.mark.parametrize("kw", [
    {}, dict(drop_rate=0.2, seed=4), dict(nan_rate=0.5, first_round=5, last_round=5),
    dict(nan_rate=0.5, first_round=7, last_round=3), dict(nan_rate=0.5, first_round=100),
    dict(inf_rate=1.0, last_round=3, tolerate=False), dict(straggle_rate=0.1, first_round=2),
], ids=["zero", "drop", "empty_window", "reversed_window", "late", "closed", "opened"])
def test_config_surface_matches_reference(kw):
    """``repr``, ``injects``, ``active_in`` and ``effective_config`` give the
    reference's answers; ``effective_config`` keeps the same object."""
    rcfg, cfg = rfaults.FaultConfig(**kw), faults.FaultConfig(**kw)
    assert repr(cfg) == repr(rcfg)
    assert cfg.injects == rcfg.injects
    for rounds, start in ((8, 0), (200, 0), (8, 4), (3, 0)):
        assert cfg.active_in(rounds, start) == rcfg.active_in(rounds, start)
        eff, reff = faults.effective_config(cfg, rounds), rfaults.effective_config(rcfg, rounds)
        assert (eff is cfg) == (reff is rcfg) and (eff is None) == (reff is None)
    assert faults.effective_config(None, 8) is None


@pytest.mark.parametrize("kw", [dict(drop_rate=1.5), dict(nan_rate=-0.1),
                                dict(inf_rate=float("nan"))])
def test_rate_validation_matches_reference(kw):
    with pytest.raises(ValueError):
        rfaults.FaultConfig(**kw)
    with pytest.raises(ValueError):
        faults.FaultConfig(**kw)


# ---------------------------------------------------------------------------
# The reference's faulted engine, driven round by round
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def quads():
    rq = robj.make_quadratic(jax.random.PRNGKey(0), N, D, 5.0, 0.001)
    return rq, convert.quadratic(jax.tree_util.tree_map(np.asarray, rq), "cpu")


_ROUND_FNS = {}


def _ref_round(kw, fcfg, rq, rff):
    """The reference's jitted faulted ``run_round``, one compile per
    (engine, FaultConfig)."""
    key = (tuple(sorted(kw.items())), fcfg)
    if key not in _ROUND_FNS:
        rcfg = ralg.AlgoConfig(**kw)
        mean_fn = lambda tree: jax.tree_util.tree_map(lambda a: jnp.mean(a, axis=0), tree)
        _ROUND_FNS[key] = jax.jit(lambda st, sx, r: ralg.run_round(
            rcfg, rff, robj.quadratic_query, rq, st, sx, mean_fn,
            sum_fn=lambda a: jnp.sum(a, axis=0), faults=fcfg, round_idx=r))
    return _ROUND_FNS[key]


def ref_run(kw, fcfg, rq, rounds=ROUNDS, chunk=0):
    """The reference's faulted engine on ``jax.random.PRNGKey(KEY)``, round
    by round, with its boundary after every round (``chunk=0``, the loop of
    its ``simulate``) or after every ``chunk`` rounds and the last (its
    ``run_rounds``).  Returns (history, per-round quarantine flags and
    queries after each round, the draws of every round recorded from the
    keys the engine left)."""
    rcfg, cfg = ralg.AlgoConfig(**kw), alg.AlgoConfig(**kw)
    k_init, k_rff, _ = jax.random.split(jax.random.PRNGKey(KEY), 3)
    rec, rff = TA.RecordedDraws(n=N), None
    if rcfg.is_fzoos:
        rff = ralg.rfflib.make_rff(k_rff, rcfg.n_features, rcfg.dim, rcfg.lengthscale)
        kv, kb = jax.random.split(k_rff)
        rec.banks.append((TA.T(jax.random.normal(kv, (rcfg.n_features, rcfg.dim))),
                          TA.T(jax.random.uniform(kb, (rcfg.n_features,), minval=0.0,
                                                  maxval=2.0 * np.pi))))
    rnd = _ref_round(kw, fcfg, rq, rff)
    x0 = jnp.full((rcfg.dim,), 0.5, jnp.float32)
    states, sx = ralg.init_states(rcfg, k_init, x0), x0
    hist = {f: [] for f in ("xs", "f_values", "queries", "repair_rate", "drop_rate",
                            "quarantine_rate")}
    hist["xs"].append(x0)
    hist["f_values"].append(robj.quadratic_global_value(rq, x0))
    flags = {"quarantined": [], "queries": []}
    for r in range(rounds):
        TA._record_round(cfg, states.key, rec)  # this round's draws, from its keys
        states, stats = rnd(states, sx, jnp.int32(r))
        sx = stats.server_x
        flags["quarantined"].append(N_(states.quarantined))
        flags["queries"].append(N_(states.queries))
        if chunk == 0 or (r + 1) % chunk == 0 or r + 1 == rounds:
            if rcfg.deferred:
                states, _ = rrounds.repair_flagged_clients(states, rcfg)
            if fcfg.tolerate:
                states, _ = rrounds.quarantine_reset_flagged(states, rcfg, sx)
        hist["xs"].append(sx)
        hist["f_values"].append(robj.quadratic_global_value(rq, sx))
        for f in ("queries", "repair_rate", "drop_rate", "quarantine_rate"):
            hist[f].append(getattr(stats, {"queries": "queries_per_client"}.get(f, f)))
    return ({f: N_(jnp.stack(v)) for f, v in hist.items()},
            {f: np.stack(v) for f, v in flags.items()}, rec)


def port_run(kw, fcfg, q, rec, rounds=ROUNDS, chunk=0, module=None, monkeypatch=None):
    """The port's ``simulate`` (``module``'s: the port, or the float64
    port) on the recorded draws; with ``monkeypatch``, returns the
    per-round quarantine flags and queries after each round too."""
    m = module or SimpleNamespace(alg=alg, obj=obj, faults=faults)
    seen = {"quarantined": [], "queries": []}
    if monkeypatch is not None:
        real = m.alg.run_round

        def spy(*args, **kwargs):
            states, stats = real(*args, **kwargs)
            seen["quarantined"].append(states.quarantined.numpy().copy())
            seen["queries"].append(states.queries.numpy().copy())
            return states, stats

        monkeypatch.setattr(m.alg, "run_round", spy)
    res = m.alg.simulate(m.alg.AlgoConfig(**kw), 0, q, m.obj.quadratic_query,
                         m.obj.quadratic_global_value, rounds, draws=rec, chunk=chunk,
                         device="cpu", faults=m.faults.FaultConfig(**dataclasses.asdict(fcfg)))
    assert rec.exhausted()
    return res, {f: np.stack(v) for f, v in seen.items() if v}


def port64_modules():
    """The float64 port's algorithms, objectives and faults (``port_run``'s
    ``module``)."""
    return SimpleNamespace(alg=port64.alg, obj=port64.obj,
                           faults=importlib.import_module("repro_torch_f64.faults"))


def clients(rate):
    """The number of clients a drop or quarantine rate counts."""
    return np.rint(np.asarray(rate, np.float64) * N).astype(int)


def assert_matches_reference(got, seen, want, ref_flags, truth, f_tol, x_tol):
    """Exact: queries, per-client quarantine flags and queries after every
    round, the clients that the drop and quarantine rates count, the places
    of NaN.  F and x: within the bounds, or through the float64 witness
    ``truth()``.  The rates are held by their counts: the reference's
    ``1 - n_live / N`` is contracted on the CPU into one fused
    multiply-add with the reciprocal of N (-1.49e-8 where no client
    dropped, at N=5), the port's is the count over N correctly rounded
    (``chip_smoke.fault_expectations``)."""
    np.testing.assert_array_equal(got.queries.numpy(), want["queries"])
    np.testing.assert_array_equal(clients(got.drop_rate), clients(want["drop_rate"]))
    np.testing.assert_array_equal(clients(got.quarantine_rate), clients(want["quarantine_rate"]))
    np.testing.assert_allclose(got.drop_rate.numpy(), want["drop_rate"], atol=1e-7)
    np.testing.assert_allclose(got.quarantine_rate.numpy(), want["quarantine_rate"], atol=1e-7)
    for f in ("quarantined", "queries"):
        np.testing.assert_array_equal(seen[f], ref_flags[f], err_msg=f)
    for f, tol in (("f_values", f_tol), ("xs", x_tol)):
        g = getattr(got, f).numpy()
        np.testing.assert_array_equal(np.isnan(g), np.isnan(want[f]), err_msg=f"NaN of {f}")
        TA.assert_tracks(np.nan_to_num(g), np.nan_to_num(want[f]),
                         lambda: torch.nan_to_num(getattr(truth(), f)), tol, f)


ENGINES = {
    "deferred": (KW, TA.F_TOL, TA.X_TOL),
    "per_client": (dict(KW, defer_repair=False), TA.F_TOL, TA.X_TOL),
    "seed": (dict(KW, use_factor_cache=False), TA.F_TOL, TA.X_TOL),
    **{name: (dict(FD_KW, name=name), 1e-5, 1e-5)
       for name in ("fedzo", "fedprox", "scaffold1", "scaffold2")},
}
KIND_RATES = {"drop": dict(drop_rate=0.3), "straggle": dict(straggle_rate=0.3),
              "nan": dict(nan_rate=0.3), "inf": dict(inf_rate=0.3),
              "mix": dict(drop_rate=0.2, straggle_rate=0.2, nan_rate=0.15, inf_rate=0.15)}
#: Each kind alone and the mix on the deferred engine, the mix on the
#: others; each with tolerance and without.
MATRIX = [(engine, kind, tolerate) for tolerate in (True, False)
          for engine in ENGINES for kind in KIND_RATES
          if engine == "deferred" or kind == "mix"]


def _fault_config(kind, tolerate, module=rfaults):
    return module.FaultConfig(seed=KEY, tolerate=tolerate, **KIND_RATES[kind])


@pytest.mark.parametrize("engine,kind,tolerate", MATRIX,
                         ids=[f"{e}-{k}-{'tolerant' if t else 'intolerant'}"
                              for e, k, t in MATRIX])
def test_engine_matches_reference_under_faults(quads, monkeypatch, engine, kind, tolerate):
    """Four rounds of each engine under each fault kind (the port's
    counterpart of tests/test_faults.py::test_fault_kind_matrix), in the
    loop on both sides, on the reference's draws."""
    rq, q = quads
    kw, f_tol, x_tol = ENGINES[engine]
    rfcfg = _fault_config(kind, tolerate)
    table = rfaults.schedule_table(rfcfg, ROUNDS, N)
    assert any(table[k].any() for k in faults.KINDS if KIND_RATES[kind].get(f"{k}_rate"))
    want, ref_flags, rec = ref_run(kw, rfcfg, rq)
    rec64 = rec.widened()
    got, seen = port_run(kw, rfcfg, q, rec, monkeypatch=monkeypatch)

    @functools.cache
    def truth():
        return port_run(kw, rfcfg, port64.convert.quadratic(TA.wide(rq), "cpu"), rec64,
                        module=port64_modules())[0]

    assert_matches_reference(got, seen, want, ref_flags, truth, f_tol, x_tol)
    if tolerate:
        assert np.isfinite(got.f_values.numpy()).all() and np.isfinite(got.xs.numpy()).all()
        np.testing.assert_array_equal(got.repair_rate.numpy(), want["repair_rate"])
        if kind in ("nan", "inf"):
            assert got.quarantine_rate.max() > 0
        if kind == "straggle":
            assert not got.quarantine_rate.any()
    elif kind != "straggle":  # silence and poison reach the dense mean
        assert np.isnan(got.xs.numpy()).any()


def test_ref_run_is_the_reference(quads):
    """``ref_run`` is the reference's ``simulate``: in the loop the same
    history bit for bit; against its scan in chunks of 2 (the boundary's
    repair and reset after rounds 2 and 4), the same queries and counted
    clients, and F and x within the engines' parity bounds (the scan fuses
    the round's f32 arithmetic otherwise than one jitted round)."""
    rq, _ = quads
    rfcfg = _fault_config("mix", True)
    sim = lambda chunk: ralg.simulate(
        ralg.AlgoConfig(**KW), jax.random.PRNGKey(KEY), rq, robj.quadratic_query,
        robj.quadratic_global_value, ROUNDS, chunk=chunk, faults=rfcfg)
    loop, ref_loop = ref_run(KW, rfcfg, rq)[0], sim(0)
    for f, v in loop.items():
        np.testing.assert_array_equal(v, N_(getattr(ref_loop, f)), err_msg=f)
    chunked, _, _ = ref_run(KW, rfcfg, rq, chunk=2)
    scan = sim(2)
    np.testing.assert_array_equal(chunked["queries"], N_(scan.queries))
    for f in ("drop_rate", "quarantine_rate"):
        np.testing.assert_array_equal(clients(chunked[f]), clients(getattr(scan, f)), err_msg=f)
    for f, tol in (("xs", TA.X_TOL), ("f_values", TA.F_TOL)):
        np.testing.assert_allclose(chunked[f], N_(getattr(scan, f)), atol=tol, err_msg=f)
    assert chunked["quarantine_rate"].tolist() != loop["quarantine_rate"].tolist()


@pytest.mark.parametrize("engine", ["deferred", "fedzo"])
def test_chunks_match_reference_chunks(quads, monkeypatch, engine):
    """Chunks of 2 on both sides: quarantines persist to the boundary, so
    the rates differ from the loop's, and the port's are the reference's."""
    rq, q = quads
    kw, f_tol, x_tol = ENGINES[engine]
    rfcfg = _fault_config("mix", True)
    want, ref_flags, rec = ref_run(kw, rfcfg, rq, chunk=2)
    rec64 = rec.widened()
    got, seen = port_run(kw, rfcfg, q, rec, chunk=2, monkeypatch=monkeypatch)

    @functools.cache
    def truth():
        return port_run(kw, rfcfg, port64.convert.quadratic(TA.wide(rq), "cpu"), rec64,
                        chunk=2, module=port64_modules())[0]

    assert_matches_reference(got, seen, want, ref_flags, truth, f_tol, x_tol)
    cfg = alg.AlgoConfig(**kw)
    expected = SMOKE.fault_expectations(faults.FaultConfig(**dataclasses.asdict(rfcfg)), ROUNDS,
                                        N, 2, cfg.queries_per_round())
    for got_row, want_row in zip((got.drop_rate, got.quarantine_rate, got.queries), expected):
        np.testing.assert_array_equal(got_row.numpy(), want_row)
    np.testing.assert_array_equal(seen["queries"][-1], expected[3])


def test_run_round_reads_a_config_or_a_schedule_alike(quads):
    """``run_round`` with a ``FaultConfig`` (hashed that round) and with the
    run's ``FaultSchedule`` (read from its table): the same round bit for
    bit, at a round where every kind fires."""
    _, q = quads
    cfg = alg.AlgoConfig(**KW)
    fcfg = faults.FaultConfig(seed=KEY, drop_rate=0.3, straggle_rate=0.3, nan_rate=0.3,
                              inf_rate=0.3)
    states = alg.init_states(cfg, torch.full((D,), 0.5))
    r = torch.tensor(2)
    assert all(getattr(faults.draw_faults(fcfg, r, states.client_id), k).any()
               for k in faults.KINDS)
    outs = []
    for how in (fcfg, faults.FaultSchedule(fcfg, 4, N)):
        draws = alg.ClientDraws(5, range(N), "cpu")
        rff = alg.rfflib.make_rff(draws, cfg.n_features, D, cfg.lengthscale)
        outs.append(alg.run_round(cfg, rff, obj.quadratic_query, q, states,
                                  torch.full((D,), 0.5), draws, faults=how, round_idx=r))
    for a, b in zip(graphs.tensors(outs[0]), graphs.tensors(outs[1])):
        assert torch.equal(a, b)
    with pytest.raises(ValueError, match="round_idx"):
        alg.run_round(cfg, None, obj.quadratic_query, q, states, torch.full((D,), 0.5), None,
                      faults=fcfg)


# ---------------------------------------------------------------------------
# The port's own runs: quarantine reset, chunks and the loop, faults off,
# no tolerance, resume, convergence
# ---------------------------------------------------------------------------


def _flagged_states(kw, flags):
    """tests/test_faults.py's states: fresh, moved off x0, queries counted,
    ``flags`` quarantined (the reference's)."""
    rcfg = ralg.AlgoConfig(**kw)
    states = ralg.init_states(rcfg, jax.random.PRNGKey(2), jnp.full((rcfg.dim,), 0.5))
    return states._replace(
        x=states.x + 1.0,
        queries=states.queries + jnp.arange(rcfg.n_clients, dtype=states.queries.dtype),
        quarantined=jnp.asarray(flags))


@pytest.mark.parametrize("engine", ["deferred", "scaffold2"])
def test_quarantine_reset_matches_reference(engine):
    """The port's reset against the reference's ``make_quarantine_reset``
    (the fresh-client oracle) on the same states: every leaf bit for bit
    (the FD direction bank, the port's own draw, against the port's fresh
    bank), the flags cleared; ``quarantine_reset_flagged`` without a flag
    returns the states themselves."""
    kw = ENGINES[engine][0]
    flags = np.array([True, False, False, True, False])
    rstates = _flagged_states(kw, flags)
    sx = jnp.linspace(0.2, 0.8, D, dtype=jnp.float32)
    want = ralg.make_quarantine_reset(ralg.AlgoConfig(**kw))(rstates, sx)
    cfg = alg.AlgoConfig(**kw)
    states = convert.client_state(jax.tree_util.tree_map(np.asarray, rstates), "cpu")
    got, n = rounds.quarantine_reset_flagged(states, cfg, TA.T(sx))
    assert n == 2 and not got.quarantined.any()
    fresh_bank = alg.init_states(cfg, torch.zeros(D)).fd_bank[0]
    for field in alg.ClientState._fields:
        g, w = getattr(got, field), getattr(want, field)
        if field == "opt":  # the moments; the step counter is shared in the port
            w = getattr(w, "inner", w)
            g, w = (g.mu, g.nu), (w.mu, w.nu)
        for gl, wl in zip(jax.tree_util.tree_leaves(g), jax.tree_util.tree_leaves(w)):
            wl = N_(wl)
            if field == "fd_bank":
                np.testing.assert_array_equal(gl[~flags].numpy(), wl[~flags])
                assert all(torch.equal(gl[i], fresh_bank) for i in np.flatnonzero(flags))
            else:
                np.testing.assert_array_equal(gl.numpy(), wl, err_msg=field)
    same, n0 = rounds.quarantine_reset_flagged(got, cfg, TA.T(sx))
    assert n0 == 0 and same is got


@pytest.fixture(scope="module")
def quad():
    return obj.make_quadratic(0, N, D, 5.0, 0.001, device="cpu")


def _sim(cfg, quad, rounds=6, seed=5, **kw):
    return alg.simulate(cfg, seed, quad, obj.quadratic_query, obj.quadratic_global_value, rounds,
                        device="cpu", **kw)


MIX = faults.FaultConfig(seed=KEY, **KIND_RATES["mix"])


@pytest.mark.parametrize("engine", ["deferred", "per_client", "scaffold1"])
def test_chunks_match_the_loop(quad, engine):
    """Bit for bit: chunks of 1 under the mix (the loop's cadence of
    resets), chunks of 4 under drop and straggle (nothing quarantined, so
    no reset).  Chunks of 4 under the mix follow the quarantine rule at
    their own cadence, within the reference's faulted scan-vs-loop bounds
    (tests/test_faults.py: x 0.1, F 5e-2)."""
    cfg = alg.AlgoConfig(**ENGINES[engine][0])
    loop = _sim(cfg, quad, chunk=0, faults=MIX)
    TR._assert_bitwise(loop, _sim(cfg, quad, chunk=1, faults=MIX))
    calm = faults.FaultConfig(seed=KEY, drop_rate=0.3, straggle_rate=0.3)
    TR._assert_bitwise(_sim(cfg, quad, chunk=0, faults=calm), _sim(cfg, quad, chunk=4, faults=calm))
    chunked = _sim(cfg, quad, chunk=4, faults=MIX)
    for res, chunk in ((loop, 0), (chunked, 4)):
        drop, quar, _, _ = SMOKE.fault_expectations(MIX, 6, N, chunk, cfg.queries_per_round())
        np.testing.assert_array_equal(res.drop_rate.numpy(), drop)
        np.testing.assert_array_equal(res.quarantine_rate.numpy(), quar)
    assert loop.quarantine_rate.tolist() != chunked.quarantine_rate.tolist()
    np.testing.assert_allclose(chunked.xs.numpy(), loop.xs.numpy(), atol=0.1)
    np.testing.assert_allclose(chunked.f_values.numpy(), loop.f_values.numpy(), atol=5e-2)


@pytest.mark.parametrize("chunk", [0, 3])
def test_faults_off_is_faults_none(quad, chunk):
    """A window that never opens inside the run runs the faults-free engine
    bit for bit (``effective_config``), with tolerance or without."""
    cfg = alg.AlgoConfig(**KW)
    plain = _sim(cfg, quad, chunk=chunk)
    for fcfg in (faults.FaultConfig(seed=3, nan_rate=0.9, tolerate=False, first_round=100),
                 faults.FaultConfig(drop_rate=0.5, straggle_rate=0.5, first_round=6)):
        TR._assert_bitwise(plain, _sim(cfg, quad, chunk=chunk, faults=fcfg))


def test_zero_rates_run_the_masked_engine(quad):
    """Every rate 0 with tolerance: the masked engine with nothing injected.
    Its mean is a sum over the live count, the faults-free one
    ``torch.mean``: within the engines' parity bounds of the faults-free
    run (an ulp of the mean grows through the GP solves), the same
    queries, nothing dropped or quarantined."""
    cfg = alg.AlgoConfig(**KW)
    plain, masked = _sim(cfg, quad, chunk=3), _sim(cfg, quad, chunk=3, faults=faults.FaultConfig())
    np.testing.assert_allclose(masked.xs.numpy(), plain.xs.numpy(), atol=TA.X_TOL)
    np.testing.assert_allclose(masked.f_values.numpy(), plain.f_values.numpy(), atol=TA.F_TOL)
    np.testing.assert_array_equal(masked.queries.numpy(), plain.queries.numpy())
    assert not masked.drop_rate.any() and not masked.quarantine_rate.any()


def test_no_tolerance_poisons_or_raises(quad, tmp_path, capsys):
    """Without tolerance a NaN payload poisons the dense mean: NaN rows from
    the first poisoned round in the loop, as the reference's loop; in
    chunks a ``FloatingPointError`` at the first boundary, naming the
    missing checkpoint_dir, or, with one, a rollback to the last good step
    (tests/test_torch_rollback.py): the run ends finite with tolerance
    forced on, and no poisoned step is ever written."""
    cfg = alg.AlgoConfig(**KW)
    fcfg = faults.FaultConfig(seed=KEY, nan_rate=0.3, tolerate=False)
    first = int(np.flatnonzero(faults.schedule_table(fcfg, 6, N)["nan"].any(1))[0])
    loop = _sim(cfg, quad, chunk=0, faults=fcfg)
    assert np.isfinite(loop.xs[:first + 1].numpy()).all()
    assert np.isnan(loop.xs[first + 1:].numpy()).all()
    with pytest.raises(FloatingPointError, match="no checkpoint_dir"):
        _sim(cfg, quad, chunk=2, faults=fcfg)
    root = str(tmp_path / "ck")
    rolled = _sim(cfg, quad, chunk=2, faults=fcfg, checkpoint_dir=root)
    out = capsys.readouterr().out
    assert "ROLLBACK 1/3" in out and "FORCED ON" in out
    assert np.isfinite(rolled.xs.numpy()).all()
    for step in io.list_steps(root):
        hist = io.restore_round_state(root, alg.init_states(cfg, torch.zeros(D)),
                                      rounds.history_init(6, torch.zeros(D), torch.zeros(())),
                                      step=step,
                                      draws_like=alg.ClientDraws(5, range(N), "cpu").state())[1]
        assert np.isfinite(hist.xs[:step + 1].numpy()).all()


def test_faulted_resume_is_bitwise(quad, tmp_path):
    """Six rounds under the mix in chunks of 2 with checkpoints (and the
    insurance step 0 a faulted run writes first): with the last step
    removed the resumed run is the straight run bit for bit, its
    generators included; the step names the FaultConfig, and a resume with
    another one raises."""
    cfg, root = alg.AlgoConfig(**KW), str(tmp_path / "ck")

    def run(**kw):
        draws = alg.ClientDraws(5, range(N), "cpu")
        return _sim(cfg, quad, chunk=2, faults=MIX, draws=draws, **kw), draws

    straight, straight_draws = run()
    first, _ = run(checkpoint_dir=root)
    TR._assert_bitwise(straight, first)
    assert io.list_steps(root) == [0, 2, 4, 6]
    assert io.load_meta(root, 6)["extra"]["faults"] == repr(MIX)
    shutil.rmtree(os.path.join(root, f"step_{6:08d}"))
    resumed, resumed_draws = run(checkpoint_dir=root)
    TR._assert_bitwise(straight, resumed)
    for a, b in zip(straight_draws.state(), resumed_draws.state()):
        assert torch.equal(a, b)
    with pytest.raises(ValueError, match="faults"):
        _sim(cfg, quad, chunk=2, faults=dataclasses.replace(MIX, seed=KEY + 1),
             checkpoint_dir=root)


def test_dropout_run_still_converges(quad):
    """tests/test_faults.py's scenario on the port's own draws: 20% dropout
    over 20 rounds in chunks of 8 still lowers F."""
    cfg = alg.AlgoConfig(**KW)
    res = _sim(cfg, quad, rounds=20, chunk=8, faults=faults.FaultConfig(seed=11, drop_rate=0.2))
    f = res.f_values.numpy()
    assert np.isfinite(f).all() and f[-1] < f[0]
    assert res.drop_rate.max() > 0


# ---------------------------------------------------------------------------
# On the card (skipped without one)
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("engine", ["deferred", "fedzo"])
def test_cuda_captured_faulted_chunks_match_eager(engine):
    """Five rounds under the mix in chunks of 2 (two captures, three
    replays) against the same chunks run eagerly on the same draws: bit for
    bit, every generator left in the same state (no client is flagged for
    repair at this size; quarantines fall at the same boundaries)."""
    dev = TR._cuda()
    cfg = alg.AlgoConfig(**ENGINES[engine][0])
    q = obj.make_quadratic(0, N, D, 5.0, 0.001, device=dev)
    sim = lambda draws: alg.simulate(cfg, 5, q, obj.quadratic_query, obj.quadratic_global_value,
                                     5, draws=draws, chunk=2, device=dev, faults=MIX)
    graphs.COUNTS.update(captures=0, replays=0)
    captured_draws, eager_draws = alg.ClientDraws(5, range(N), dev), TR._EagerDraws(5, range(N),
                                                                                  dev)
    captured = sim(captured_draws)
    assert graphs.COUNTS == {"captures": 2, "replays": 3}
    eager = sim(eager_draws)
    assert graphs.COUNTS == {"captures": 2, "replays": 3}
    assert eager.repair_rate.abs().max().item() == 0
    assert all(torch.equal(a, b) for a, b in zip(captured, eager))
    for a, b in zip(TR._gen_states(eager_draws), TR._gen_states(captured_draws)):
        assert torch.equal(a, b)


def test_cuda_eager_faulted_chunk_has_no_host_sync():
    """One eager chunk of two faulted rounds of the deferred engine issues
    no synchronizing call: the schedule is read on the device."""
    dev = TR._cuda()
    cfg = alg.AlgoConfig(**KW)
    q = obj.make_quadratic(0, N, D, 5.0, 0.001, device=dev)
    draws = alg.ClientDraws(5, range(N), dev)
    x0 = torch.full((D,), 0.5, device=dev)
    rff = alg.rfflib.make_rff(draws, cfg.n_features, cfg.dim, cfg.lengthscale)
    states = alg.init_states(cfg, x0)
    schedule = faults.FaultSchedule(MIX, 10, N, dev)
    chunk = rounds.chunk_fn(cfg, rff, obj.quadratic_query, q, draws,
                            obj.quadratic_global_value, None, 2, 1, 10, faults=schedule)
    offset = torch.zeros((), dtype=torch.int64, device=dev)
    chunk(states, x0, offset)  # first use: the library's handles and the kernels' build
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        states, sx, ys = chunk(states, x0, offset)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    assert ys[0].shape == (2, D) and torch.isfinite(sx).all()
