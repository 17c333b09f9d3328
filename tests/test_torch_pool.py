"""The port's client pool (``repro_torch.core.pool``) against the reference's
(``repro.core.pool``; tests/test_pool.py).

* The cohort sampler is the reference's bit for bit over a grid of (seed,
  round, N, K), N = 256, K = 1 and K = N included: the port hashes the
  reference's threefry permutation itself.
* The pool store: ``init_pool`` is ``init_states`` bit for bit, in one go
  or in slices; a gather followed by a scatter of untouched rows changes
  no bit.
* K = N: the pooled engine is the port's dense engine bit for bit.
* K < N, on the reference's draws: its ``run_pooled_rounds`` is driven
  round by round here (``ref_pooled_run``, each round's draws recorded
  from the cohort's keys, as tests/test_torch_faults.py's ``ref_run``
  records the dense engine's), held once against the reference's own
  ``run_pooled_rounds``; the port draws the same cohorts, its clients end with the
  reference's queries and quarantine flags exactly, and F and x follow the
  engines' bounds through the float64 witness (``assert_tracks``).
* Checkpoints (``pool-v1``): a resume is bitwise, falls back past a
  corrupt step and raises on another identity; a poisoned run without
  tolerance rolls back as the reference's does.

Sizes are tests/test_pool.py's ``quad8``: d=8, a pool of 8, K=4, chunks of
4 (of 2 for the resumes), up to 12 rounds.  The card-only tests (skipped
without one) hold a captured pooled run against its eager chunks with one
capture per chunk length, and the pooled run at K = N against the dense
captured run.
"""

import dataclasses
import functools
import importlib
import importlib.util
import os
import shutil
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import faults as rfaults
from repro.core import algorithms as ralg
from repro.core import objectives as robj
from repro.core import pool as rpool
from repro.core import rounds as rrounds
from repro_torch import convert
from repro_torch import faults
from repro_torch.checkpoint import io
from repro_torch.core import algorithms as alg
from repro_torch.core import graphs
from repro_torch.core import objectives as obj
from repro_torch.core import pool
from repro_torch.core import rounds


def _port_tests(name):
    """Another test file of the port, for its helpers."""
    path = Path(__file__).resolve().parent / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"_{name}_pool_helpers", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


TA = _port_tests("test_torch_algorithms")
TR = _port_tests("test_torch_rounds")
port64 = TA.port64  # the port in float64, the witness of TA.assert_tracks

D, N, K, KEY = 8, 8, 4, 3
KW = dict(name="fzoos", dim=D, n_clients=N, local_steps=3, n_features=32, traj_capacity=32,
          active_per_iter=1, active_candidates=8, active_round_end=1, lengthscale=0.5)
N_ = lambda a: np.asarray(a)


@pytest.fixture(scope="module")
def quads():
    rq = robj.make_quadratic(jax.random.PRNGKey(0), N, D, 2.0, 0.001)
    return rq, convert.quadratic(jax.tree_util.tree_map(np.asarray, rq), "cpu")


def _cfg(**kw):
    return alg.AlgoConfig(**dict(KW, **kw))


def _sim(cfg, q, rounds=8, seed=5, **kw):
    return alg.simulate(cfg, seed, q, obj.quadratic_query, obj.quadratic_global_value, rounds,
                        device="cpu", **kw)


# ---------------------------------------------------------------------------
# The cohort sampler
# ---------------------------------------------------------------------------

SEEDS = (0, 1, 7, 12345, 2**31 - 1)
ROUND_IDS = (0, 1, 5, 37, 1000)


@pytest.mark.parametrize("n,k", [(8, 4), (8, 1), (16, 5), (256, 5), (256, 1), (256, 255),
                                 (256, 256), (2, 1), (100, 99), (1, 1)])
def test_sample_cohort_matches_reference(n, k):
    """Every (seed, round) of the grid: the reference's cohort bit for bit,
    sorted, without repeats; K = N the identity."""
    for seed in SEEDS:
        for r in ROUND_IDS:
            got = pool.sample_cohort(seed, r, n, k)
            np.testing.assert_array_equal(got, rpool.sample_cohort(seed, r, n, k))
            assert got.dtype == np.int64 and got.shape == (k,)
            assert (np.diff(got) > 0).all() and got.min() >= 0 and got.max() < n
    if k == n:
        np.testing.assert_array_equal(pool.sample_cohort(3, 9, n, k), np.arange(n))


def test_permutation_matches_jax():
    """The whole permutation of ``range(N)`` under a folded key is
    ``jax.random.permutation``'s, at sizes on both sides of a second sort
    round (N = 1626 and up sort twice)."""
    for n in (3, 256, 1625, 1626, 5000):
        key = jax.random.fold_in(jax.random.PRNGKey(11), 4)
        words = tuple(int(w) for w in N_(key))
        np.testing.assert_array_equal(pool.permutation(words, n).numpy(),
                                      N_(jax.random.permutation(key, n)))


@pytest.mark.parametrize("k", [0, 9])
def test_sample_cohort_validation(k):
    for mod in (pool, rpool):
        with pytest.raises(ValueError, match="cohort"):
            mod.sample_cohort(0, 0, 8, k)


# ---------------------------------------------------------------------------
# The pool store
# ---------------------------------------------------------------------------


def _leaves(tree):
    return io.tree_flatten(tree)[0]


@pytest.mark.parametrize("kw", [{}, dict(name="scaffold2", q=3)], ids=["fzoos", "scaffold2"])
def test_init_pool_matches_init_states(kw):
    """``batch=None`` is ``init_states`` bit for bit, every leaf's strides
    included; client i's generator state is ``ClientDraws``'s for client
    i; slices of 3 give the same."""
    cfg = _cfg(**kw)
    x0 = torch.full((D,), 0.5)
    dense = alg.init_states(cfg, x0)
    one = pool.init_pool(cfg, x0, seed=5)
    sliced = pool.init_pool(cfg, x0, seed=5, batch=3)
    for p in (one, sliced):
        for a, b in zip(p.leaves, _leaves(dense)):
            assert torch.equal(a, b)
        got = p.gather(np.arange(N), "cpu")
        for a, b in zip(_leaves(got), _leaves(dense)):
            assert torch.equal(a, b) and a.stride() == b.stride()
        for a, b in zip(p.draw_states, alg.ClientDraws(5, range(N), "cpu").state()[1:]):
            assert torch.equal(a, b)
    assert one.nbytes() == sum(t.numel() * t.element_size()
                               for t in (*_leaves(dense), *one.draw_states))


def test_gather_scatter_roundtrip_bitwise():
    cfg = _cfg()
    p = pool.init_pool(cfg, torch.full((D,), 0.5))
    before = [t.clone() for t in p.leaves]
    gens = [s.clone() for s in p.draw_states]
    idx = pool.sample_cohort(0, 0, N, 3)
    p.scatter(idx, p.gather(idx, "cpu"), p.gather_draws(idx))
    for a, b in zip(p.leaves, before):
        assert torch.equal(a, b)
    assert all(torch.equal(a, b) for a, b in zip(p.draw_states, gens))


def test_scatter_validates_structure():
    p = pool.init_pool(_cfg(), torch.full((D,), 0.5))
    with pytest.raises(ValueError, match="structure"):
        p.scatter(np.arange(3), {"not": torch.zeros(3)})


# ---------------------------------------------------------------------------
# K = N: the dense engine
# ---------------------------------------------------------------------------

MIX = dict(seed=KEY, drop_rate=0.2, straggle_rate=0.2, nan_rate=0.15, inf_rate=0.15)


@pytest.mark.parametrize("engine", ["fzoos", "fzoos_faulted", "fedzo"])
def test_full_participation_is_the_dense_engine(quads, engine):
    """cohort = n_clients: the identity cohort, the same init, the same
    round: every history row bit for bit the dense engine's, in chunks of
    4; under faults too (the schedule read by pool id is the dense one's)."""
    _, q = quads
    cfg = _cfg(name="fedzo", q=2) if engine == "fedzo" else _cfg()
    kw = dict(faults=faults.FaultConfig(**MIX)) if engine == "fzoos_faulted" else {}
    TR._assert_bitwise(_sim(cfg, q, chunk=4, **kw), _sim(cfg, q, chunk=4, cohort=N, **kw))


def test_cohort_requires_chunks(quads):
    with pytest.raises(ValueError, match="chunk"):
        _sim(_cfg(), quads[1], chunk=0, cohort=N)


# ---------------------------------------------------------------------------
# K < N: the reference's ``run_pooled_rounds`` on its draws
# ---------------------------------------------------------------------------

_ROUND_FNS = {}


def _ref_round(kw, fcfg, rff):
    """The reference's jitted ``run_round`` of a cohort, its objectives an
    argument; one compile per (config, FaultConfig)."""
    key = (tuple(sorted(kw.items())), fcfg)
    if key not in _ROUND_FNS:
        rcfg = ralg.AlgoConfig(**kw)
        mean_fn = lambda tree: jax.tree_util.tree_map(lambda a: jnp.mean(a, axis=0), tree)
        _ROUND_FNS[key] = jax.jit(lambda st, sx, r, co: ralg.run_round(
            rcfg, rff, robj.quadratic_query, co, st, sx, mean_fn,
            sum_fn=lambda a: jnp.sum(a, axis=0), faults=fcfg, round_idx=r))
    return _ROUND_FNS[key]


def _bank(rcfg, k_rff, rec):
    rff = ralg.rfflib.make_rff(k_rff, rcfg.n_features, rcfg.dim, rcfg.lengthscale)
    kv, kb = jax.random.split(k_rff)
    rec.banks.append((TA.T(jax.random.normal(kv, (rcfg.n_features, rcfg.dim))),
                      TA.T(jax.random.uniform(kb, (rcfg.n_features,), minval=0.0,
                                              maxval=2.0 * np.pi))))
    return rff


def ref_pooled_run(rq, rounds, chunk, cohort_seed=0, fcfg=None):
    """The reference's ``simulate(..., cohort=K)`` on ``PRNGKey(KEY)``, its
    ``run_pooled_rounds`` round by round: each chunk gathers the reference's
    cohort, runs its faulted ``run_round`` (zero-rate when ``fcfg`` is
    None) on the cohort's objectives, then its boundary (repair, the
    quarantine reset under faults), and scatters back.  Returns (history,
    the cohorts, the final pool, the draws recorded from the cohorts'
    keys)."""
    rcfg, kkw = ralg.AlgoConfig(**KW), dict(KW, n_clients=K)
    rcc, ccfg = ralg.AlgoConfig(**kkw), alg.AlgoConfig(**kkw)
    k_init, k_rff, _ = jax.random.split(jax.random.PRNGKey(KEY), 3)
    rec = TA.RecordedDraws(n=K)
    rnd = _ref_round(kkw, fcfg or rfaults.FaultConfig(), _bank(rcfg, k_rff, rec))
    x0 = jnp.full((D,), 0.5, jnp.float32)
    rp = rpool.init_pool(rcfg, k_init, x0)
    host = jax.tree_util.tree_map(np.asarray, rq)
    hist = {f: [] for f in ("xs", "f_values", "queries", "drop_rate", "quarantine_rate")}
    hist["xs"].append(x0)
    hist["f_values"].append(robj.quadratic_global_value(rq, x0))
    sx, cohorts = x0, []
    for start in range(0, rounds, chunk):
        idx = rpool.sample_cohort(cohort_seed, start, N, K)
        cohorts.append(idx)
        st, co = rp.gather(idx), jax.tree_util.tree_map(lambda a: jnp.asarray(a[idx]), host)
        for r in range(start, min(start + chunk, rounds)):
            TA._record_round(ccfg, st.key, rec)
            st, stats = rnd(st, sx, jnp.int32(r), co)
            sx = stats.server_x
            hist["xs"].append(sx)
            hist["f_values"].append(robj.quadratic_global_value(co, sx))
            for f in ("queries", "drop_rate", "quarantine_rate"):
                hist[f].append(getattr(stats, {"queries": "queries_per_client"}.get(f, f)))
        st, _ = rrounds.repair_flagged_clients(st, rcc)
        if fcfg is not None:
            st, _ = rrounds.quarantine_reset_flagged(st, rcc, sx)
        rp.scatter(idx, st)
    return {f: N_(jnp.stack(v)) for f, v in hist.items()}, cohorts, rp, rec


def port_pooled_run(q, rec, rounds, chunk, cohort_seed=0, fcfg=None, module=None,
                    monkeypatch=None):
    """The port's ``run_pooled_rounds`` (``module``'s: the port, or the
    float64 port) on the recorded draws; returns (history, final pool,
    the cohorts it gathered)."""
    pm = module or pool
    m_alg = importlib.import_module(pm.__name__.replace("core.pool", "core.algorithms"))
    m_obj = importlib.import_module(pm.__name__.replace("core.pool", "core.objectives"))
    m_faults = importlib.import_module(pm.__name__.replace("core.pool", "faults"))
    cfg = m_alg.AlgoConfig(**KW)
    x0 = torch.full((D,), 0.5, dtype=rec.banks[0][0].dtype)
    seen = []
    if monkeypatch is not None:
        real = pm.ClientPool.gather
        monkeypatch.setattr(pm.ClientPool, "gather",
                            lambda self, idx, device: seen.append(np.asarray(idx))
                            or real(self, idx, device))
    rff = m_alg.rfflib.make_rff(rec, cfg.n_features, D, cfg.lengthscale)
    p = pm.init_pool(cfg, x0)
    fc = None if fcfg is None else m_faults.FaultConfig(**dataclasses.asdict(fcfg))
    p, hist = pm.run_pooled_rounds(cfg, rff, m_obj.quadratic_query, q, p, x0,
                                   m_obj.quadratic_global_value, rounds, chunk, cohort=K,
                                   cohort_seed=cohort_seed, draws=rec, faults=fc)
    assert rec.exhausted()
    return hist, p, seen


def _pool_field(p, field):
    """A ``ClientState`` field of every pooled client (the port's pool or
    the reference's)."""
    if isinstance(p, rpool.ClientPool):
        return N_(getattr(p.gather(np.arange(N)), field))
    return getattr(p.gather(np.arange(N), "cpu"), field).numpy()


@pytest.fixture(scope="module")
def pooled_runs(quads):
    """The reference's pooled runs, 12 rounds in chunks of 4 (calm, and
    under the mix with tolerance, cohort seed 1), beside its own
    ``run_pooled_rounds``; compiled once for the module."""
    rq, _ = quads
    out = {}
    for name, fcfg, cseed in (("calm", None, 0), ("faulted", rfaults.FaultConfig(**MIX), 1)):
        want, cohorts, rp, rec = ref_pooled_run(rq, 12, 4, cseed, fcfg)
        rcfg = ralg.AlgoConfig(**KW)
        k_init, k_rff, _ = jax.random.split(jax.random.PRNGKey(KEY), 3)
        x0 = jnp.full((D,), 0.5, jnp.float32)
        drv_pool, drv = rpool.run_pooled_rounds(
            rcfg, ralg.rfflib.make_rff(k_rff, rcfg.n_features, D, rcfg.lengthscale),
            robj.quadratic_query, rq, rpool.init_pool(rcfg, k_init, x0), x0,
            robj.quadratic_global_value, 12, 4, cohort=K, cohort_seed=cseed, faults=fcfg)
        out[name] = (fcfg, cseed, want, cohorts, rp, rec, drv_pool, drv)
    return out


@pytest.mark.parametrize("name", ["calm", "faulted"])
def test_ref_pooled_run_is_the_reference(pooled_runs, name):
    """``ref_pooled_run`` against the reference's ``run_pooled_rounds``: the
    same queries, counted clients and final per-client queries and flags;
    F and x within the reference's own scan-vs-loop bounds (tests/
    test_rounds.py ``_assert_bounded``: x 0.1, F 5e-2): its scan fuses the
    round's f32 arithmetic otherwise than one jitted round, and drifts over
    12 rounds (ROADMAP Queue C, "A 12-round drift on injected draws")."""
    _, _, want, _, rp, _, drv_pool, drv = pooled_runs[name]
    np.testing.assert_array_equal(want["queries"], N_(drv.queries))
    for f in ("drop_rate", "quarantine_rate"):
        np.testing.assert_allclose(want[f], N_(getattr(drv, f)), atol=1e-7)
    for f in ("queries", "quarantined"):
        np.testing.assert_array_equal(_pool_field(rp, f), _pool_field(drv_pool, f))
    np.testing.assert_allclose(want["xs"], N_(drv.xs), atol=0.1)
    np.testing.assert_allclose(want["f_values"], N_(drv.f_values), atol=5e-2)


@pytest.mark.parametrize("name", ["calm", "faulted"])
def test_partial_participation_matches_reference(quads, pooled_runs, port64, monkeypatch, name):
    """K=4 of N=8, 12 rounds in chunks of 4, on the reference's draws: the
    same cohort at every chunk; each client's queries and quarantine flag
    at the end exactly, and the queries and the counted clients of every
    round; F and x within the engines' bounds, through the float64
    witness."""
    rq, q = quads
    fcfg, cseed, want, cohorts, rp, rec, _, _ = pooled_runs[name]
    rec64 = rec.widened()
    got, p, seen = port_pooled_run(q, rec, 12, 4, cseed, fcfg, monkeypatch=monkeypatch)
    assert len(seen) == len(cohorts) == 3
    for a, b in zip(seen, cohorts):
        np.testing.assert_array_equal(a, b)
    for f in ("queries", "quarantined"):
        np.testing.assert_array_equal(_pool_field(p, f), _pool_field(rp, f), err_msg=f)
    np.testing.assert_array_equal(got.queries.numpy(), want["queries"])
    for f in ("drop_rate", "quarantine_rate"):
        np.testing.assert_array_equal(np.rint(getattr(got, f).numpy() * K),
                                      np.rint(want[f] * K), err_msg=f)
    if name == "faulted":
        assert want["quarantine_rate"].max() > 0 and want["drop_rate"].max() > 0

    @functools.cache
    def truth():
        m64 = importlib.import_module("repro_torch_f64.core.pool")
        return port_pooled_run(port64.convert.quadratic(TA.wide(rq), "cpu"), rec64, 12, 4,
                               cseed, fcfg, module=m64)[0]

    for f, tol in (("f_values", TA.F_TOL), ("xs", TA.X_TOL)):
        TA.assert_tracks(getattr(got, f).numpy(), want[f],
                         lambda: getattr(truth(), f), tol, f)


def test_partial_participation_optimizes(quads):
    """tests/test_pool.py's scenario on the port's own draws: K=4 of N=8,
    12 rounds in chunks of 4, finite and falling."""
    r = _sim(_cfg(), quads[1], rounds=12, chunk=4, cohort=K)
    f = r.f_values.numpy()
    assert np.isfinite(f).all() and f[-1] < f[0]


def test_one_set_of_buffers_serves_every_cohort(quads, monkeypatch):
    """Every chunk's engine closes over the same objective tensors (the
    cohort's rows are copied into them): what lets one captured graph per
    chunk length serve every cohort on the card."""
    seen = []
    real = rounds.chunk_fn

    def spy(cfg, rff, query_fn, cobjs, *args, **kwargs):
        seen.append([t.data_ptr() for t in graphs.tensors(cobjs)])
        return real(cfg, rff, query_fn, cobjs, *args, **kwargs)

    monkeypatch.setattr(rounds, "chunk_fn", spy)
    _sim(_cfg(), quads[1], rounds=6, chunk=2, cohort=K)
    assert len(seen) == 3 and all(s == seen[0] for s in seen)


# ---------------------------------------------------------------------------
# Checkpoints, resume and rollback
# ---------------------------------------------------------------------------


def test_pooled_resume_bitwise(quads, tmp_path):
    """Killed after round 4 of 8 (chunks of 2), the resumed run is the
    uninterrupted one bit for bit: the cohorts key on the absolute round,
    the pool and its generator states come back from the step."""
    cfg, d = _cfg(local_steps=2), str(tmp_path / "ck")
    full = _sim(cfg, quads[1], chunk=2, cohort=K, checkpoint_dir=d)
    assert io.list_steps(d) == [2, 4, 6, 8]
    meta = io.load_meta(d, 8)
    assert meta["layout"] == "pool-v1" and meta["n_shards"] == 1
    assert meta["pool"]["global_rows"] == N and meta["extra"]["cohort"] == K
    for step in (6, 8):
        shutil.rmtree(os.path.join(d, f"step_{step:08d}"))
    TR._assert_bitwise(full, _sim(cfg, quads[1], chunk=2, cohort=K, checkpoint_dir=d))


@pytest.mark.parametrize("damage", ["flip", "truncate"])
def test_pooled_resume_falls_back_past_corrupt_step(quads, tmp_path, capsys, damage):
    cfg, d = _cfg(local_steps=2), str(tmp_path / "ck")
    full = _sim(cfg, quads[1], chunk=2, cohort=K, checkpoint_dir=d)
    getattr(faults, {"flip": "flip_bytes", "truncate": "truncate_npz"}[damage])(d, 8)
    TR._assert_bitwise(full, _sim(cfg, quads[1], chunk=2, cohort=K, checkpoint_dir=d))
    assert "step 8: corrupt" in capsys.readouterr().out


@pytest.mark.parametrize("change, match", [
    (dict(cohort=2), "cohort"), (dict(cohort_seed=1), "cohort_seed"),
    (dict(n_clients=6), "n_clients=6"), (dict(identity={"seed": 1}), "seed"),
    (dict(identity={"objective": {"het": 3.0}}), "objective")],
    ids=["cohort", "cohort_seed", "pool_size", "seed", "objective"])
def test_pooled_resume_identity(quads, tmp_path, change, match):
    """A pool step refuses a resume under another cohort, cohort seed,
    pool size (its config names it first), seed or objective argument (the
    launcher's identity)."""
    cfg, d = _cfg(local_steps=2), str(tmp_path / "ck")
    ident = {"seed": 0, "objective": {"het": 2.0}}
    _sim(cfg, quads[1], rounds=4, chunk=2, cohort=K, checkpoint_dir=d, identity=ident)
    kw = {"cohort": K, "identity": ident, **change}
    n = kw.pop("n_clients", N)
    q = quads[1] if n == N else obj.make_quadratic(0, n, D, 2.0, 0.001, device="cpu")
    with pytest.raises(ValueError, match=match):
        _sim(dataclasses.replace(cfg, n_clients=n), q, rounds=4, chunk=2, checkpoint_dir=d,
             **kw)


def test_pool_step_is_not_a_round_step(quads, tmp_path):
    """A dense run in a pool's directory, and a pool run in a dense run's,
    raise instead of restoring the other layout."""
    cfg = _cfg(local_steps=2)
    d = str(tmp_path / "pool")
    _sim(cfg, quads[1], rounds=2, chunk=2, cohort=K, checkpoint_dir=d)
    with pytest.raises(ValueError, match="client-pool step"):
        io.restore_round_state(d, {}, {})
    d2 = str(tmp_path / "dense")
    _sim(cfg, quads[1], rounds=2, chunk=2, checkpoint_dir=d2)
    with pytest.raises(ValueError, match="pool-v1"):
        io.restore_pool_state(d2, [], {})


def test_pooled_rollback_matches_reference(quads, tmp_path, capsys):
    """No tolerance, NaN payloads, chunks of 4 with a checkpoint_dir: both
    packages catch the poisoned iterate before it scatters, roll back to
    the same round the same number of times, force tolerance on and finish
    finite (tests/test_pool.py:290)."""
    rq, q = quads
    fcfg = dict(seed=3, nan_rate=0.3, tolerate=False)
    rcfg = ralg.AlgoConfig(**KW)
    r = ralg.simulate(rcfg, jax.random.PRNGKey(5), rq, robj.quadratic_query,
                      robj.quadratic_global_value, 8, chunk=4, cohort=K,
                      checkpoint_dir=str(tmp_path / "ref"), faults=rfaults.FaultConfig(**fcfg))
    ref_lines = [ln.split("] ", 1)[1] for ln in capsys.readouterr().out.splitlines()
                 if "ROLLBACK" in ln or "FORCED ON" in ln]
    got = _sim(_cfg(), q, chunk=4, cohort=K, checkpoint_dir=str(tmp_path / "port"),
               faults=faults.FaultConfig(**fcfg))
    lines = [ln.split("] ", 1)[1] for ln in capsys.readouterr().out.splitlines()
             if "ROLLBACK" in ln or "FORCED ON" in ln]
    assert lines == ref_lines and len(lines) == 2
    assert np.isfinite(got.xs.numpy()).all() and np.isfinite(N_(r.xs)).all()
    np.testing.assert_array_equal(got.queries.numpy(), N_(r.queries))
    assert io.list_steps(str(tmp_path / "port")) == ckpt_steps(str(tmp_path / "ref"))


def test_pooled_rollback_restores_the_generators(quads, tmp_path, monkeypatch, capsys):
    """A pooled rollback to the insurance step past scattered chunks: the
    re-run's first chunk starts from the generator states its first run
    started from (the pool's rows restored from ``pool-v1``, then
    gathered), which the scattered chunks had moved on."""
    root = str(tmp_path / "ck")
    starts = TR.record_chunk_starts(monkeypatch)
    _sim(_cfg(), quads[1], chunk=2, cohort=K, checkpoint_dir=root, checkpoint_every=100,
         faults=faults.FaultConfig(seed=0, nan_rate=0.1, tolerate=False))
    # the chunk of rounds 4-5 is the first whose cohort is poisoned
    assert "ROLLBACK 1/3 at round 6 " in capsys.readouterr().out
    assert TR.restarted_chunks(starts) == [0, 2, 4]
    first, rerun = [s for r, s in starts if r == 0]
    assert TR.same_states(rerun, first)


def ckpt_steps(root):
    return sorted(int(d.split("_")[1]) for d in os.listdir(root) if d.startswith("step_")
                  and not d.endswith(".tmp"))


def test_pooled_quarantine_never_persists(quads):
    """Quarantined members are restarted before they scatter back: no
    pooled client is ever quarantined, and every float leaf is finite."""
    cfg, x0 = _cfg(), torch.full((D,), 0.5)
    draws = alg.ClientDraws(5, range(K), "cpu")
    rff = alg.rfflib.make_rff(draws, cfg.n_features, D, cfg.lengthscale)
    p, hist = pool.run_pooled_rounds(cfg, rff, obj.quadratic_query, quads[1],
                                     pool.init_pool(cfg, x0, 5), x0,
                                     obj.quadratic_global_value, 8, 4, cohort=K, draws=draws,
                                     faults=faults.FaultConfig(seed=3, nan_rate=0.3))
    assert hist.quarantine_rate.max() > 0
    assert not _pool_field(p, "quarantined").any()
    assert all(torch.isfinite(t).all() for t in p.leaves if t.is_floating_point())


def test_pooled_failed_final_write_rolls_back(quads, tmp_path, monkeypatch, capsys):
    """Under faults a failed last write rolls back like any other boundary
    and the run finishes; without faults it fails the run."""
    cfg, d = _cfg(local_steps=2), str(tmp_path / "ck")
    real, calls = io.write_round_state, []

    def flaky(root, step, *args, **kwargs):
        calls.append(step)
        if step == 4 and calls.count(4) == 1:
            raise OSError("disk full")
        return real(root, step, *args, **kwargs)

    monkeypatch.setattr(io, "write_round_state", flaky)
    res = _sim(cfg, quads[1], rounds=4, chunk=2, cohort=K, checkpoint_dir=d,
               async_checkpoint=False, faults=faults.FaultConfig(seed=3, drop_rate=0.2))
    out = capsys.readouterr().out
    assert "checkpoint write failed at round 4" in out and "ROLLBACK 1/3 at round 4" in out
    assert np.isfinite(res.xs.numpy()).all() and io.list_steps(d) == [0, 2, 4]
    calls.clear()
    with pytest.raises(OSError, match="disk full"):
        _sim(cfg, quads[1], rounds=4, chunk=2, cohort=K, checkpoint_dir=str(tmp_path / "b"),
             async_checkpoint=False)


# ---------------------------------------------------------------------------
# On the card (skipped without one)
# ---------------------------------------------------------------------------


def test_cuda_pooled_captured_matches_eager():
    """K=4 of N=8, 8 rounds in chunks of 2, under the mix: one capture, four
    replays whatever the cohort, bit for bit the same chunks run eagerly on
    the same draws, every generator of the pool in the same state."""
    dev = TR._cuda()
    cfg = _cfg()
    q = obj.make_quadratic(0, N, D, 2.0, 0.001, device=dev)
    x0 = torch.full((D,), 0.5, device=dev)

    def run(draws):
        rff = alg.rfflib.make_rff(draws, cfg.n_features, D, cfg.lengthscale)
        return pool.run_pooled_rounds(cfg, rff, obj.quadratic_query, q, pool.init_pool(cfg, x0, 5),
                                      x0, obj.quadratic_global_value, 8, 2, cohort=K,
                                      draws=draws, faults=faults.FaultConfig(**MIX))

    graphs.COUNTS.update(captures=0, replays=0)
    p_cap, captured = run(alg.ClientDraws(5, range(K), dev))
    assert graphs.COUNTS == {"captures": 1, "replays": 4}
    p_eager, eager = run(TR._EagerDraws(5, range(K), dev))
    assert graphs.COUNTS == {"captures": 1, "replays": 4}
    assert eager.repair_rate.abs().max().item() == 0
    assert all(torch.equal(a, b) for a, b in zip(captured, eager))
    assert all(torch.equal(a, b) for a, b in zip(p_cap.leaves, p_eager.leaves))
    assert all(torch.equal(a, b) for a, b in zip(p_cap.draw_states, p_eager.draw_states))


def test_cuda_full_participation_is_the_dense_engine():
    """K = N in captured chunks: the dense captured run bit for bit."""
    dev = TR._cuda()
    cfg = _cfg()
    q = obj.make_quadratic(0, N, D, 2.0, 0.001, device=dev)
    sim = lambda **kw: alg.simulate(cfg, 5, q, obj.quadratic_query, obj.quadratic_global_value,
                                    6, chunk=2, device=dev, **kw)
    assert all(torch.equal(a, b) for a, b in zip(sim(), sim(cohort=N)))
