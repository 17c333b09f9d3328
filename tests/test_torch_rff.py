"""Port parity of the random Fourier features (``core/rff.py``), and of the
leaf modules of the engines: the objectives, ``fd_grad`` and the optimizers.

The reference's feature bank (``make_rff`` from a JAX key) is carried over
with ``repro_torch.convert.rff``, so both sides compute on the same bank.
``features`` and ``grad_features_t_w_rows`` are single f32 products:
agreement to 1e-5 of max(|reference|, 1), a few f32 ulps of sums over M
terms.  ``fit_w_chol`` solves the RFF Gram (near singular once the ring
fills): 1e-4 of the scale where it is well posed (cond < 1e3,
DESIGN.md Sec. 2.4), and otherwise no less accurate than the reference
against a float64 solve of the same system (slack 3, floor 1e-4).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import optim as roptim
from repro.core import gp_surrogate as rgp
from repro.core import objectives as robj
from repro.core import rff as rrff
from repro_torch import convert
from repro_torch.core import algorithms as alg
from repro_torch.core import gp_surrogate as gp
from repro_torch.core import objectives as obj
from repro_torch.core import rff
from repro_torch.optim import optimizers

T = lambda a: torch.from_numpy(np.array(a))
N_ = lambda a: np.asarray(a)
LS = 0.6


def _bank(m=48, d=5, seed=3):
    rb = rrff.make_rff(jax.random.PRNGKey(seed), m, d, LS)
    return rb, convert.rff(jax.tree_util.tree_map(np.asarray, rb), "cpu")


def _close(got, want, atol=1e-5):
    want = np.asarray(want)
    scale = max(float(np.abs(want).max()), 1.0)
    np.testing.assert_allclose(np.asarray(got) / scale, want / scale, atol=atol)


def test_features_and_rows_gradient_match_reference():
    rb, pb = _bank()
    rng = np.random.default_rng(0)
    xs = rng.uniform(size=(6, 5)).astype(np.float32)
    ws = rng.standard_normal((6, 48)).astype(np.float32)
    _close(rff.features(pb, T(xs)), rrff.features(rb, jnp.asarray(xs)))
    _close(rff.grad_features_t_w_rows(pb, T(xs), T(ws)),
           rrff.grad_features_t_w_rows(rb, jnp.asarray(xs), jnp.asarray(ws)))


def test_single_point_and_batch_gradient_match_reference():
    """``grad_features_t_w`` (one point) and ``_batch`` (one w for all rows)."""
    rb, pb = _bank()
    rng = np.random.default_rng(1)
    xs = rng.uniform(size=(4, 5)).astype(np.float32)
    w = rng.standard_normal(48).astype(np.float32)
    _close(rff.grad_features_t_w(pb, T(xs[0]), T(w)),
           rrff.grad_features_t_w(rb, jnp.asarray(xs[0]), jnp.asarray(w)))
    _close(rff.grad_features_t_w_batch(pb, T(xs), T(w)),
           rrff.grad_features_t_w_batch(rb, jnp.asarray(xs), jnp.asarray(w)))


def test_features_and_gradients_route_through_ops(monkeypatch):
    """``features`` is one ``ops.rff_features`` call (B6 on the card) for a
    client-batched (N, cap, d) input, and the three gradient forms are one
    ``ops.rff_grad`` / ``ops.rff_grad_rows`` call each (B5), all still
    matching the reference at 1e-5 of the scale."""
    from repro_torch.kernels import ops

    calls = {}
    for name in ("rff_features", "rff_grad", "rff_grad_rows"):
        real = getattr(ops, name)
        calls[name] = []
        monkeypatch.setattr(ops, name, lambda *a, _n=name, _f=real: calls[_n].append(1) or _f(*a))
    rb, pb = _bank()
    rng = np.random.default_rng(8)
    xs = rng.uniform(size=(3, 4, 5)).astype(np.float32)
    ws = rng.standard_normal((4, 48)).astype(np.float32)
    phi = rff.features(pb, T(xs))
    assert phi.shape == (3, 4, 48)
    for c in range(3):
        _close(phi[c], rrff.features(rb, jnp.asarray(xs[c])))
    x, j = xs[0], jnp.asarray
    _close(rff.grad_features_t_w(pb, T(x[1]), T(ws[0])),
           rrff.grad_features_t_w(rb, j(x[1]), j(ws[0])))
    _close(rff.grad_features_t_w_batch(pb, T(x), T(ws[1])),
           rrff.grad_features_t_w_batch(rb, j(x), j(ws[1])))
    _close(rff.grad_features_t_w_rows(pb, T(x), T(ws)),
           rrff.grad_features_t_w_rows(rb, j(x), j(ws)))
    assert {k: len(v) for k, v in calls.items()} == {
        "rff_features": 1, "rff_grad": 2, "rff_grad_rows": 1}


def test_make_rff_from_bank_draws_matches_reference():
    """The port's make_rff, fed the reference's raw draws, gives its bank."""
    key = jax.random.PRNGKey(7)
    kv, kb = jax.random.split(key)
    z = jax.random.normal(kv, (16, 3))
    b = jax.random.uniform(kb, (16,), minval=0.0, maxval=2.0 * np.pi)

    class Bank:
        def bank(self, m, d):
            assert (m, d) == (16, 3)
            return T(z), T(b)

    got = rff.make_rff(Bank(), 16, 3, LS)
    want = rrff.make_rff(key, 16, 3, LS)
    np.testing.assert_allclose(got.v.numpy(), N_(want.v), rtol=1e-6)
    np.testing.assert_array_equal(got.b.numpy(), N_(want.b))


@pytest.mark.parametrize("n_events,spread,well_posed", [(2, 3.0, True), (6, 0.3, False)],
                         ids=["well_posed", "near_singular"])
def test_fit_w_chol_matches_reference(n_events, spread, well_posed):
    rb, pb = _bank()
    cap, d, nb = 10, 5, 2
    rhyper = rgp.default_hyper(LS, 1e-4)
    hyper = gp.GPHyper(LS, 1e-4)
    rtr = jax.vmap(lambda _: rgp.traj_init(cap, d))(jnp.arange(nb))
    rfa = jax.vmap(lambda tr: rgp.factor_init(tr, rhyper))(rtr)
    tr = gp.traj_init(nb, cap, d, "cpu")
    fa = gp.factor_init(tr, hyper)
    rng = np.random.default_rng(1)
    for _ in range(n_events):
        xs = (spread * rng.uniform(size=(nb, 2, d))).astype(np.float32)
        ys = np.cos(xs.sum(-1)).astype(np.float32)
        rtr, rfa = rgp.traj_extend_clients(rtr, rfa, jnp.asarray(xs), jnp.asarray(ys), rhyper,
                                           deferred=True)
        tr, fa = gp.traj_extend_clients(tr, fa, T(xs), T(ys), hyper)
    want = jax.vmap(lambda t, f: rrff.fit_w_chol(rb, t, rhyper, f))(rtr, rfa)
    got = rff.fit_w_chol(pb, tr, hyper, fa)
    assert got.shape == (nb, 48)
    for c in range(nb):
        mask = tr.valid_mask()[c].double().numpy()
        phi = np.sqrt(2.0 / 48) * np.cos(tr.xs[c].double().numpy() @ pb.v.double().numpy().T
                                         + pb.b.double().numpy()) * mask[:, None]
        gram = phi @ phi.T + np.diag(1e-4 * mask + (1 - mask))
        truth = phi.T @ np.linalg.solve(gram, tr.ys[c].double().numpy() * mask)
        scale = 1.0 + np.abs(truth).max()
        assert (np.linalg.cond(gram) < 1e3) == well_posed
        if well_posed:
            _close(got[c], want[c], atol=1e-4)
        err_p = np.abs(got[c].double().numpy() - truth).max()
        err_r = np.abs(np.asarray(want[c], np.float64) - truth).max()
        assert err_p <= max(3.0 * err_r, 1e-4 * scale), (err_p, err_r)


@pytest.mark.parametrize("n_events,spread,well_posed", [(2, 3.0, True), (6, 0.3, False)],
                         ids=["well_posed", "near_singular"])
def test_fit_w_and_fit_from_factor_match_reference(n_events, spread, well_posed):
    """The per-client engines' eq. 6 fit (``fit_w``, clamped eigh of the RFF
    Gram) and the ``rff_fit_exact`` fit through the inline-updated exact-GP
    factor, per client against the reference; the Sec. 2.4 rule against
    float64 solves of the same systems."""
    rb, pb = _bank()
    cap, d, nb = 10, 5, 2
    rhyper = rgp.default_hyper(LS, 1e-4)
    hyper = gp.GPHyper(LS, 1e-4)
    rtr = jax.vmap(lambda _: rgp.traj_init(cap, d))(jnp.arange(nb))
    rfa = jax.vmap(lambda tr: rgp.factor_init(tr, rhyper))(rtr)
    tr = gp.traj_init(nb, cap, d, "cpu")
    fa = gp.factor_init(tr, hyper)
    rng = np.random.default_rng(2)
    for _ in range(n_events):
        xs = (spread * rng.uniform(size=(nb, 2, d))).astype(np.float32)
        ys = np.cos(xs.sum(-1)).astype(np.float32)
        rtr, rfa = rgp.traj_extend_clients(rtr, rfa, jnp.asarray(xs), jnp.asarray(ys), rhyper)
        tr, fa = gp.traj_extend_clients(tr, fa, T(xs), T(ys), hyper, deferred=False)
    got_w, got_x = rff.fit_w(pb, tr, hyper), rff.fit_w_from_factor(pb, tr, fa)
    want_w = jax.vmap(lambda t: rrff.fit_w(rb, t, rhyper))(rtr)
    want_x = jax.vmap(lambda t, f: rrff.fit_w_from_factor(rb, t, f))(rtr, rfa)
    assert got_w.shape == got_x.shape == (nb, 48)
    for c in range(nb):
        mask = tr.valid_mask()[c].double().numpy()
        xs64, ys64 = tr.xs[c].double().numpy(), tr.ys[c].double().numpy() * mask
        phi = np.sqrt(2.0 / 48) * np.cos(xs64 @ pb.v.double().numpy().T
                                         + pb.b.double().numpy()) * mask[:, None]
        reg = np.diag(1e-4 * mask + (1 - mask))
        k = np.exp(-0.5 * ((xs64[:, None] - xs64[None]) ** 2).sum(-1) / LS**2)
        for got, want, gram in ((got_w, want_w, phi @ phi.T + reg),
                                (got_x, want_x, k * np.outer(mask, mask) + reg)):
            truth = phi.T @ np.linalg.solve(gram, ys64)
            scale = 1.0 + np.abs(truth).max()
            assert (np.linalg.cond(gram) < 1e3) == well_posed
            if well_posed:
                _close(got[c], want[c], atol=1e-4)
            err_p = np.abs(got[c].double().numpy() - truth).max()
            err_r = np.abs(np.asarray(want[c], np.float64) - truth).max()
            assert err_p <= max(3.0 * err_r, 1e-4 * scale), (err_p, err_r)


def test_fd_grad_matches_reference_with_injected_draws():
    """``fd_grad`` on the quadratic: the reference's directions and its
    query noise (``split(key)`` into the base and the Q perturbed queries)
    handed to the port."""
    from repro.core import fd as rfd
    from repro_torch.core import fd

    n, d, q, lam = 3, 6, 5, 5e-3
    rq = robj.make_quadratic(jax.random.PRNGKey(1), n, d, 5.0, 0.01)
    cq = convert.quadratic(jax.tree_util.tree_map(np.asarray, rq), "cpu")
    rng = np.random.default_rng(3)
    x = rng.uniform(size=(n, d)).astype(np.float32)
    keys = jax.random.split(jax.random.PRNGKey(4), n)
    dirs = jax.vmap(lambda k: rfd.sample_directions(k, q, d))(jax.random.split(keys[0], n))
    want = jax.vmap(lambda cp, xx, k, u: rfd.fd_grad(robj.quadratic_query, cp, xx, k, u, lam))(
        rq, jnp.asarray(x), keys, dirs)
    kb = jax.vmap(jax.random.split)(keys)
    normal = jax.vmap(jax.vmap(lambda k: jax.random.normal(k, ())))
    noise = jnp.concatenate([normal(kb[:, :1]),
                             normal(jax.vmap(lambda k: jax.random.split(k, q))(kb[:, 1]))], 1)
    got = fd.fd_grad(obj.quadratic_query, cq, T(x), T(noise), T(dirs), lam)
    # (y - y0) / lam amplifies the queries' f32 rounding by 1/lam = 200
    _close(got, want, atol=1e-4)
    assert fd.fd_queries(q) == rfd.fd_queries(q) == q + 1


def test_sinquad_objective_matches_reference():
    """The non-convex sinquad: value, gradient (checked against jax.grad
    through the reference's ``sinquad_grad``), noisy query, global value
    and gradient."""
    rs = robj.make_sinquad(jax.random.PRNGKey(5), 3, 6, 2.0, 0.01)
    s_ = convert.sinquad(jax.tree_util.tree_map(np.asarray, rs), "cpu")
    rng = np.random.default_rng(6)
    xs = rng.uniform(size=(3, 2, 6)).astype(np.float32)
    z = rng.standard_normal((3, 2)).astype(np.float32)
    rv = jax.vmap(jax.vmap(robj.sinquad_value, in_axes=(None, 0)))(rs, jnp.asarray(xs))
    _close(obj.sinquad_value(s_, T(xs)), rv, atol=1e-6)
    rg = jax.vmap(jax.vmap(robj.sinquad_grad, in_axes=(None, 0)))(rs, jnp.asarray(xs))
    _close(obj.sinquad_grad(s_, T(xs)), rg, atol=1e-6)
    _close(obj.sinquad_query(s_, T(xs), T(z)), N_(rv) + 0.01 * z, atol=1e-6)
    x = T(xs[1, 0])
    _close(obj.sinquad_global_value(s_, x), robj.sinquad_global_value(rs, jnp.asarray(x)),
           atol=1e-6)
    _close(obj.sinquad_global_grad(s_, x), robj.sinquad_global_grad(rs, jnp.asarray(x)),
           atol=1e-6)
    fresh = obj.make_sinquad(0, 3, 6, 2.0, device="cpu")
    assert fresh.phase.shape == (3, 6) and torch.allclose(fresh.a.sum(0), torch.ones(6))


def test_quadratic_objective_matches_reference():
    """The Appx. E.1 quadratic: value, grad, noisy query, global value."""
    rq = robj.make_quadratic(jax.random.PRNGKey(2), 3, 6, 5.0, 0.01)
    q = convert.quadratic(jax.tree_util.tree_map(np.asarray, rq), "cpu")
    rng = np.random.default_rng(4)
    xs = rng.uniform(size=(3, 2, 6)).astype(np.float32)
    z = rng.standard_normal((3, 2)).astype(np.float32)
    rv = jax.vmap(jax.vmap(robj.quadratic_value, in_axes=(None, 0)))(rq, jnp.asarray(xs))
    _close(obj.quadratic_value(q, T(xs)), rv, atol=1e-6)
    rg = jax.vmap(jax.vmap(robj.quadratic_grad, in_axes=(None, 0)))(rq, jnp.asarray(xs))
    _close(obj.quadratic_grad(q, T(xs)), rg, atol=1e-6)
    _close(obj.quadratic_query(q, T(xs), T(z)), N_(rv) + 0.01 * z, atol=1e-6)
    x = T(xs[0, 0])
    _close(obj.quadratic_global_value(q, x), robj.quadratic_global_value(rq, jnp.asarray(x)),
           atol=1e-6)
    assert obj.quadratic_fstar(6) == robj.quadratic_fstar(6)
    fresh = obj.make_quadratic(0, 3, 6, 5.0, device="cpu")
    assert fresh.a.shape == (3, 6) and torch.allclose(fresh.a.sum(0), torch.ones(6))


@pytest.mark.parametrize("name", ["sgd", "adam", "adamw"])
def test_optimizers_match_reference(name):
    """Three steps of each optimizer on stacked (N, d) parameters."""
    rng = np.random.default_rng(5)
    p = rng.standard_normal((3, 4)).astype(np.float32)
    r_init, r_upd = roptim.make_optimizer(name)
    init, upd = optimizers.make_optimizer(name)
    rs, s = r_init(jnp.asarray(p)), init(T(p))
    rp, tp = jnp.asarray(p), T(p)
    for _ in range(3):
        g = rng.standard_normal((3, 4)).astype(np.float32)
        rp, rs = r_upd(rs, jnp.asarray(g), rp, 0.01)
        tp, s = upd(s, T(g), tp, 0.01)
    np.testing.assert_allclose(tp.numpy(), N_(rp), rtol=1e-6, atol=1e-7)
    bf = torch.ones(2, dtype=torch.bfloat16)
    assert upd(init(bf), torch.ones(2), bf, 0.01)[0].dtype == torch.bfloat16  # _keep_dtype


def test_config_accounting_matches_reference():
    from repro.core import algorithms as ralg
    for name in ("fzoos", "fedzo", "scaffold1"):
        kw = dict(name=name, dim=7, n_clients=3, local_steps=4, active_per_iter=3,
                  active_round_end=2, n_features=40, q=6)
        r, p = ralg.AlgoConfig(**kw), alg.AlgoConfig(**kw)
        assert p.queries_per_round() == r.queries_per_round()
        assert p.comm_floats_per_round() == r.comm_floats_per_round()
        assert p.deferred == r.deferred
    with pytest.raises(ValueError):
        alg.AlgoConfig(name="nope", dim=2, n_clients=1)
    with pytest.raises(ValueError):
        alg.AlgoConfig(name="fzoos", dim=2, n_clients=1, rff_fit_exact=True,
                       use_factor_cache=False)
