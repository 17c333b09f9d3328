"""The port's round engines against the reference, end to end.

Torch cannot replay JAX's threefry streams, so the reference's draws are
recorded from its own key schedule and injected into the port through its
draw source: ``simulate``'s split into (init, rff, rounds) keys,
``init_states``' per-client split, the local step's 4-way split (FZooS:
noise of the iterate's query from the 2nd key, candidate deltas from the
3rd, the picks' noise from ``split(fold_in(k_act, 1))``; the FD family:
the 4th key split into the estimate's key and the directions' key, then
``fd_grad``'s split into the base query's key and the Q perturbed ones),
the FZooS round end's 2-way split (``fold_in(k_act, 2)``), scaffold1's
3-way prologue split, and ``normal(key, ())`` for every query's noise.
With the same draws, the same objective and the same bank, the two sides
differ only in f32 reassociation, which can move a near-tied candidate
pick; query accounting must match exactly.

Divergence bound: |F_port - F_ref| <= 1e-3 and |x_port - x_ref| <= 1e-2 per
round.  At these sizes the observed divergence is about 2e-5 in F and 3e-4
in x; the bound leaves a factor ~30 for other BLAS builds and is still
50x tighter than the repo's engine-equivalence bound (F 5e-2, x 0.1,
tests/test_deferred_repair.py).
"""

import functools
import importlib
import sys
from pathlib import Path
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import algorithms as ralg
from repro.core import objectives as robj
from repro_torch import convert
from repro_torch.core import algorithms as alg
from repro_torch.core import objectives as obj

D, N, CAP = 8, 3, 16
KW = dict(name="fzoos", dim=D, n_clients=N, local_steps=3, eta=0.01, n_features=32,
          traj_capacity=CAP, active_candidates=12, active_per_iter=2, active_round_end=2,
          lengthscale=0.5, noise=1e-5)
F_TOL, X_TOL = 1e-3, 1e-2

T = lambda a: torch.from_numpy(np.array(a))
N_ = lambda a: np.asarray(a)


def float64_port(root):
    """The port's package with every float32 made float64 (as
    ``scripts/small_check_f64.py`` makes it), written under ``root`` and
    imported as ``repro_torch_f64`` beside the port: on CPU tensors every
    wrapper runs its plain version in float64.  Returns its algorithms,
    objectives, model objectives and converters."""
    name = "repro_torch_f64"
    if name not in sys.modules:
        src = Path(__file__).resolve().parents[1] / "src" / "repro_torch"
        for f in src.rglob("*.py"):
            out = root / name / f.relative_to(src)
            out.parent.mkdir(parents=True, exist_ok=True)
            text = f.read_text().replace("torch.float32", "torch.float64")
            out.write_text(text.replace("np.float32", "np.float64")
                           .replace("repro_torch", name))
        sys.path.insert(0, str(root))
        try:
            importlib.import_module(name)
        finally:
            sys.path.remove(str(root))
    mod = lambda m: importlib.import_module(f"{name}.{m}")
    return SimpleNamespace(alg=mod("core.algorithms"), obj=mod("core.objectives"),
                           mobj=mod("core.model_objectives"), convert=mod("convert"))


@pytest.fixture(scope="module")
def port64(tmp_path_factory):
    return float64_port(tmp_path_factory.mktemp("f64_port"))


def wide(tree):
    """A tree of numpy arrays (a reference pytree) with its floating arrays
    in float64: the float64 port's inputs."""
    def one(a):
        a = np.asarray(a)
        return a.astype(np.float64) if np.issubdtype(a.dtype, np.floating) else a
    return jax.tree_util.tree_map(one, tree)


def assert_tracks(got, want, truth, atol, what):
    """The port's ``got`` within ``atol`` of the reference's ``want``.  Where
    it is not, the rule of DESIGN.md Sec. 2.4: both are measured against
    ``truth()``, the same quantity from a float64 run of the port on the
    same inputs and draws, and the port must lie within ``atol`` of it and
    no further from it than the reference."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    gap = np.abs(got - want).max()
    if gap <= atol:
        return
    t = truth()
    assert t.dtype == torch.float64, f"the witness ran in {t.dtype}"
    t = t.numpy()
    e_port, e_ref = np.abs(got - t).max(), np.abs(want - t).max()
    print(f"{what}: port vs reference {gap:.3e} > {atol:g}; from float64: port "
          f"{e_port:.3e}, reference {e_ref:.3e}")
    assert e_port <= atol and e_port <= e_ref, (what, gap, e_port, e_ref)


class RecordedDraws:
    """The port's draw source, replaying arrays recorded from the reference
    for ``n`` clients.  ``state()`` is how many arrays of each kind it has
    handed out, and ``load_state`` skips ahead to such a state (a resumed
    run's draws)."""

    def __init__(self, bank=None, n=N):
        self.banks = [] if bank is None else [bank]
        self.n = n
        self.deltas_, self.noise_, self.directions_ = [], [], []
        self.used = [0, 0, 0, 0]  # arrays taken from banks, deltas_, noise_, directions_

    def _take(self, i):
        self.used[i] += 1
        return (self.banks, self.deltas_, self.noise_, self.directions_)[i].pop(0)

    def bank(self, m, d):
        return self._take(0)

    def deltas(self, n, d, radius):
        out = self._take(1)
        assert out.shape == (self.n, n, d)
        return out

    def noise(self, k):
        out = self._take(2)
        assert out.shape == (self.n, k)
        return out

    def directions(self, q, d):
        out = self._take(3)
        assert out.shape == (self.n, q, d)
        return out

    def widened(self):
        """The draws not yet handed out, in float64 (the float64 port's)."""
        out = RecordedDraws(n=self.n)
        out.banks = [tuple(t.double() for t in b) for b in self.banks]
        out.deltas_, out.noise_, out.directions_ = (
            [t.double() for t in ts] for ts in (self.deltas_, self.noise_, self.directions_))
        return out

    def exhausted(self):
        return not (self.banks or self.deltas_ or self.noise_ or self.directions_)

    def state(self):
        return [torch.tensor(self.used, dtype=torch.int64)]

    def load_state(self, states):
        for i, want in enumerate(states[0].tolist()):
            assert want >= self.used[i], "a recorded source only skips ahead"
            for _ in range(want - self.used[i]):
                self._take(i)


_split = lambda keys, n: jax.vmap(lambda k: jax.random.split(k, n))(keys)
_normal = jax.vmap(jax.vmap(lambda k: jax.random.normal(k, ())))


def _record_fd(cfg, kd, kf, rec):
    """One FD estimate's draws: ``sample_directions(kd)`` and ``fd_grad``'s
    split of kf into the base query's key and the Q perturbed queries' keys."""
    rec.directions_.append(T(jax.vmap(lambda k: jax.random.normal(k, (cfg.q, cfg.dim)))(kd)))
    kb = _split(kf, 2)
    rec.noise_.append(T(jnp.concatenate(
        [_normal(kb[:, :1]), _normal(_split(kb[:, 1], cfg.q))], axis=1)))


def _record_round(cfg, keys, rec):
    """Append one round of the reference's draws; return the advanced keys."""
    if not cfg.is_fzoos:
        if cfg.name == "scaffold1":  # the prologue's 3-way split
            ks = _split(keys, 3)
            keys = ks[:, 0]
            _record_fd(cfg, ks[:, 1], ks[:, 2], rec)
        for _ in range(cfg.local_steps):
            ks = _split(keys, 4)
            keys = ks[:, 0]
            k_est = _split(ks[:, 3], 2)  # (key, kd) of _estimate_gradient
            _record_fd(cfg, k_est[:, 1], k_est[:, 0], rec)
        return keys
    unif = jax.vmap(lambda k: jax.random.uniform(
        k, (cfg.active_candidates, cfg.dim), minval=-cfg.active_radius,
        maxval=cfg.active_radius))
    picks = lambda ks, salt, n: jax.vmap(
        lambda k: jax.random.split(jax.random.fold_in(k, salt), n))(ks)
    for _ in range(cfg.local_steps):
        ks = _split(keys, 4)
        keys = ks[:, 0]
        rec.noise_.append(T(_normal(ks[:, 1][:, None])))
        rec.deltas_.append(T(unif(ks[:, 2])))
        rec.noise_.append(T(_normal(picks(ks[:, 2], 1, cfg.active_per_iter))))
    ks = _split(keys, 2)
    rec.deltas_.append(T(unif(ks[:, 1])))
    rec.noise_.append(T(_normal(picks(ks[:, 1], 2, cfg.active_round_end))))
    return ks[:, 0]


def _recorded_simulate_draws(cfg, key, rounds):
    """Every draw of ``simulate(cfg, key, ...)`` on the reference's key schedule."""
    k_init, k_rff, _ = jax.random.split(key, 3)
    rec = RecordedDraws()
    if cfg.is_fzoos:
        kv, kb = jax.random.split(k_rff)
        rec.banks.append((T(jax.random.normal(kv, (cfg.n_features, cfg.dim))),
                          T(jax.random.uniform(kb, (cfg.n_features,), minval=0.0,
                                               maxval=2.0 * np.pi))))
    keys = jax.random.split(k_init, cfg.n_clients)
    for _ in range(rounds):
        keys = _record_round(cfg, keys, rec)
    return rec


@pytest.fixture(scope="module")
def setup():
    rcfg, cfg = ralg.AlgoConfig(**KW), alg.AlgoConfig(**KW)
    rq = robj.make_quadratic(jax.random.PRNGKey(0), N, D, 5.0, 0.001)
    q = convert.quadratic(jax.tree_util.tree_map(np.asarray, rq), "cpu")
    return rcfg, cfg, rq, q


def test_simulate_matches_reference(setup):
    """Three rounds (33 appends: the 16-slot ring wraps) of the deferred
    engine, ``chunk=0`` on the reference side."""
    rcfg, cfg, rq, q = setup
    key, rounds = jax.random.PRNGKey(1), 3
    want = ralg.simulate(rcfg, key, rq, robj.quadratic_query, robj.quadratic_global_value,
                         rounds, chunk=0,
                         diag_global_grad=lambda x: robj.quadratic_global_grad(rq, x))
    rec = _recorded_simulate_draws(cfg, key, rounds)
    diag = lambda xs: torch.stack([obj.quadratic_global_grad(q, x) for x in xs])
    got = alg.simulate(cfg, 0, q, obj.quadratic_query, obj.quadratic_global_value, rounds,
                       draws=rec, diag_global_grad=diag, chunk=0, device="cpu")
    assert rec.exhausted()
    np.testing.assert_array_equal(got.queries.numpy(), N_(want.queries))
    assert got.queries[-1].item() == rounds * cfg.queries_per_round() == 33
    assert cfg.comm_floats_per_round() == rcfg.comm_floats_per_round() == D + 32
    assert np.isfinite(got.f_values.numpy()).all()
    np.testing.assert_allclose(got.f_values.numpy(), N_(want.f_values), atol=F_TOL)
    np.testing.assert_allclose(got.xs.numpy(), N_(want.xs), atol=X_TOL)
    np.testing.assert_array_equal(got.repair_rate.numpy(), N_(want.repair_rate))
    # cos(ghat, grad F) and |ghat - grad F|^2: ghat is the gradient of a
    # nearly singular GP fit and carries that solve's f32 noise (observed:
    # 1.3e-3 in cos, 2.6e-3 relative in the disparity)
    np.testing.assert_allclose(got.mean_cos.numpy(), N_(want.mean_cos), atol=1e-2)
    np.testing.assert_allclose(got.mean_disparity.numpy(), N_(want.mean_disparity),
                               rtol=3e-2)
    assert got.f_values[-1] < got.f_values[0]


def test_run_round_matches_reference(setup, port64):
    """One round from identical states: the reference's states after one
    round (its trajectories are non-empty) carried over with ``convert``.
    x and w are held to the reference with ``assert_tracks``'s float64
    witness: the float64 port's round from the same states and draws."""
    rcfg, cfg, rq, q = setup
    mean_fn = lambda tree: jax.tree_util.tree_map(lambda a: jnp.mean(a, axis=0), tree)
    x0 = jnp.full((D,), 0.5, jnp.float32)
    rbank = ralg.rfflib.make_rff(jax.random.PRNGKey(4), cfg.n_features, D, cfg.lengthscale)
    rnd = jax.jit(lambda st, sx: ralg.run_round(
        rcfg, rbank, robj.quadratic_query, rq, st, sx, mean_fn))
    st, stats = rnd(ralg.init_states(rcfg, jax.random.PRNGKey(5), x0), x0)
    sx = stats.server_x

    pst = convert.client_state(jax.tree_util.tree_map(np.asarray, st), "cpu")
    rec = RecordedDraws()
    _record_round(cfg, st.key, rec)
    rec64 = rec.widened()
    want_st, want = rnd(st, sx)
    got_st, got = alg.run_round(cfg, convert.rff(jax.tree_util.tree_map(np.asarray, rbank),
                                                 "cpu"),
                                obj.quadratic_query, q, pst, T(sx), rec)
    assert rec.exhausted()

    @functools.cache
    def truth():
        c64 = port64.convert
        out = port64.alg.run_round(
            port64.alg.AlgoConfig(**KW), c64.rff(wide(rbank), "cpu"),
            port64.obj.quadratic_query, c64.quadratic(wide(rq), "cpu"),
            c64.client_state(wide(st), "cpu"), T(sx).double(), rec64)
        assert rec64.exhausted()
        return out

    np.testing.assert_array_equal(got_st.queries.numpy(), N_(want_st.queries))
    np.testing.assert_array_equal(got_st.traj.count.numpy(), N_(want_st.traj.count))
    assert float(got.queries_per_client) == float(want.queries_per_client)
    assert_tracks(got.server_x, want.server_x, lambda: truth()[1].server_x, X_TOL, "server x")
    assert_tracks(got_st.traj.xs, want_st.traj.xs, lambda: truth()[0].traj.xs, X_TOL,
                  "ring xs")
    # w solves the RFF Gram of a nearly full ring (cond 1e5-1e6, DESIGN.md
    # Sec. 2.4): 1e-2 of the scale, where 6e-4 is observed.
    scale = 1.0 + np.abs(N_(want_st.w_local)).max()
    assert_tracks(got_st.w_local / scale, N_(want_st.w_local) / scale,
                  lambda: truth()[0].w_local / scale, 1e-2, "w_local / scale")
    np.testing.assert_allclose(got_st.w_global.numpy(), got_st.w_local.numpy().mean(0)[None]
                               .repeat(N, 0), atol=1e-6)
    for f in ("refactor_rate", "repair_rate", "drop_rate", "quarantine_rate"):
        assert float(getattr(got, f)) == float(getattr(want, f)), f


def test_client_draws_are_per_client_and_reproducible():
    a, b = alg.ClientDraws(3, range(2), "cpu"), alg.ClientDraws(3, range(2), "cpu")
    da, db = a.deltas(4, 2, 0.01), b.deltas(4, 2, 0.01)
    torch.testing.assert_close(da, db)
    assert da.shape == (2, 4, 2) and da.abs().max() <= 0.01
    assert not torch.equal(da[0], da[1])  # each client has its own stream
    assert a.noise(3).shape == (2, 3)
    z, ph = a.bank(5, 2)
    assert z.shape == (5, 2) and ph.min() >= 0 and ph.max() < 2 * np.pi
    c = convert.client_draws(3, np.arange(2), "cpu")
    torch.testing.assert_close(c.deltas(4, 2, 0.01), da)


def test_simulate_with_its_own_draws_descends(setup):
    """The port alone, on its generators: finite, descending, exact count."""
    _, cfg, _, q = setup
    res = alg.simulate(cfg, 7, q, obj.quadratic_query, obj.quadratic_global_value, 2,
                       chunk=0, device="cpu", eval_every=2)
    assert np.isnan(res.f_values[1].item()) and np.isfinite(res.f_values[2].item())
    assert res.f_values[2] < res.f_values[0]
    assert res.queries.tolist() == [11.0, 22.0]


# The other engines of ``simulate``, each against the reference's own.  The
# FZooS engines keep the bounds above.  The FD family runs no solve: F and x
# follow the same f32 arithmetic up to summation order, and are held to
# 1e-5, the reference's own loop-vs-scan bound (tests/test_rounds.py).
FD_KW = dict(dim=D, n_clients=N, local_steps=3, eta=0.01, q=4)
ENGINES = [
    pytest.param(dict(KW, defer_repair=False), F_TOL, X_TOL, id="fzoos_per_client"),
    pytest.param(dict(KW, use_factor_cache=False), F_TOL, X_TOL, id="fzoos_seed"),
    pytest.param(dict(KW, rff_fit_exact=True), F_TOL, X_TOL, id="fzoos_fit_exact"),
    pytest.param(dict(KW, rff_fit_exact=True, defer_repair=False), F_TOL, X_TOL,
                 id="fzoos_per_client_fit_exact"),
    *(pytest.param(dict(FD_KW, name=name), 1e-5, 1e-5, id=name)
      for name in ("fedzo", "fedprox", "scaffold1", "scaffold2")),
]


@pytest.mark.parametrize("kw,f_tol,x_tol", ENGINES)
def test_engine_matches_reference(setup, kw, f_tol, x_tol):
    """Three rounds of each engine on the reference's injected draws; for
    FZooS the 16-slot ring wraps as in ``test_simulate_matches_reference``."""
    _, _, rq, q = setup
    rcfg, cfg = ralg.AlgoConfig(**kw), alg.AlgoConfig(**kw)
    key, rounds = jax.random.PRNGKey(3), 3
    want = ralg.simulate(rcfg, key, rq, robj.quadratic_query, robj.quadratic_global_value,
                         rounds, chunk=0)
    rec = _recorded_simulate_draws(cfg, key, rounds)
    got = alg.simulate(cfg, 0, q, obj.quadratic_query, obj.quadratic_global_value, rounds,
                       draws=rec, chunk=0, device="cpu")
    assert rec.exhausted()
    np.testing.assert_array_equal(got.queries.numpy(), N_(want.queries))
    assert got.queries[-1].item() == rounds * cfg.queries_per_round()
    assert cfg.queries_per_round() == rcfg.queries_per_round()
    assert cfg.comm_floats_per_round() == rcfg.comm_floats_per_round()
    assert np.isfinite(got.f_values.numpy()).all()
    np.testing.assert_allclose(got.f_values.numpy(), N_(want.f_values), atol=f_tol)
    np.testing.assert_allclose(got.xs.numpy(), N_(want.xs), atol=x_tol)
    np.testing.assert_array_equal(got.repair_rate.numpy(), N_(want.repair_rate))
    np.testing.assert_allclose(got.refactor_rate.numpy(), N_(want.refactor_rate), atol=1e-6)


@pytest.mark.parametrize("kw", [dict(defer_repair=False), dict(use_factor_cache=False)],
                         ids=["per_client", "seed"])
def test_non_deferred_engines_never_flag_a_repair(setup, kw):
    """Only the deferred engine defers repairs: the per-client engine falls
    back to the eigh inline and the seed engine keeps no factor, so their
    repair rate is 0 in every round, on the port's own draws."""
    _, cfg, _, q = setup
    import dataclasses
    c = dataclasses.replace(cfg, traj_capacity=8, **kw)  # the ring wraps in round 1
    res = alg.simulate(c, 5, q, obj.quadratic_query, obj.quadratic_global_value, 2,
                       chunk=0, device="cpu")
    assert res.repair_rate.tolist() == [0.0, 0.0]
    assert np.isfinite(res.f_values.numpy()).all()
    assert res.queries.tolist() == [11.0, 22.0]


@pytest.mark.parametrize("kw", [
    dict(KW), dict(KW, defer_repair=False), dict(KW, rff_fit_exact=True),
    dict(KW, use_factor_cache=False), dict(FD_KW, name="fedzo"), dict(FD_KW, name="scaffold1"),
], ids=["deferred", "per_client", "fit_exact", "seed", "fedzo", "scaffold1"])
def test_engines_run_rff_and_gram_through_ops(setup, monkeypatch, kw):
    """Where every engine computes B5's, B6's and B9's functions, counted on
    the CPU through the ``ops`` calls that launch them on the card (the
    launch counts ``chip_smoke.py`` expects): per round of a cached FZooS
    engine two per-row RFF gradients per local step (w_global and
    w_local), one RFF fit, an SE Gram per append event (2T + 1), plus one
    at factor_init; the seed engine's Gram is rebuilt per client at every
    scoring and gradient; an FD run only builds factor_init's Gram."""
    from repro_torch.kernels import ops

    _, _, _, q = setup
    calls = {name: 0 for name in ("rff_features", "rff_grad", "rff_grad_rows", "sqexp")}
    for name in calls:
        def spy(*a, _n=name, _f=getattr(ops, name), **k):
            calls[_n] += 1
            return _f(*a, **k)
        monkeypatch.setattr(ops, name, spy)
    cfg, rounds = alg.AlgoConfig(**kw), 2
    res = alg.simulate(cfg, 4, q, obj.quadratic_query, obj.quadratic_global_value, rounds,
                       chunk=0, device="cpu")
    assert np.isfinite(res.f_values.numpy()).all()
    t = cfg.local_steps
    if not cfg.is_fzoos:
        want = dict(rff_features=0, rff_grad=0, rff_grad_rows=0, sqexp=1)
    elif cfg.use_factor_cache:
        want = dict(rff_features=rounds, rff_grad=0, rff_grad_rows=2 * t * rounds,
                    sqexp=1 + (2 * t + 1) * rounds)
    else:  # per client: a Gram for each step's scoring and gradient, and the round end's
        want = dict(rff_features=rounds, rff_grad=0, rff_grad_rows=2 * t * rounds,
                    sqexp=1 + (2 * t + 1) * N * rounds)
    assert calls == want
