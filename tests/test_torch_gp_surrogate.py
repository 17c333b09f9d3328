"""Port parity of the trajectory GP surrogate and its Gram-factor cache.

The reference runs per client (its client-batched functions vmap it); the
port runs a stacked batch of clients.  Both get the same numpy inputs.

Tolerances follow DESIGN.md Sec. 2.4.  The padded Gram of a filled ring
reaches cond 1e5-1e6, where any two backward-stable f32 solvers disagree by
O(cond * eps).  So port and reference must agree to 1e-4 (scaled) only
where the system is well posed (cond <~ 1e3); everywhere the port must be
no less accurate than the reference against a float64 truth computed with
numpy (slack 3, floor 1e-4 of the scale: the bound of
tests/test_factor_cache.py).  The cached Gram is built by the same f32
row replacement on both sides and must agree to 1e-5: its squared
distances are formed as |x|^2 + |y|^2 - 2 x.y, whose f32 rounding is about
eps (|x|^2 + |y|^2), ~1e-6 for points in [0, 3]^3, summed in different
orders by the two sides.
"""

from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import gp_surrogate as rgp
from repro_torch.core import gp_surrogate as gp
from repro_torch.core import rounds
from repro_torch.kernels import ops

LS, NOISE = 0.7, 1e-4
RHYPER = rgp.default_hyper(LS, NOISE)
HYPER = gp.GPHyper(LS, NOISE)

T = lambda a: torch.from_numpy(np.array(a))
N_ = lambda a: np.asarray(a)


def _events(seed, n_clients, n_events, batch, d, clustered=False):
    rng = np.random.default_rng(seed)
    for _ in range(n_events):
        u = rng.uniform(size=(n_clients, batch, d))
        # spread over [0, 3]^d the points are well separated at l=0.7
        # (cond < 1e3); clustered in a 0.005 box the Gram is near singular
        xs = (0.4 + 0.005 * u if clustered else 3.0 * u).astype(np.float32)
        yield xs, np.sin(3.0 * xs.sum(-1)).astype(np.float32)


_ref_extend = jax.jit(
    lambda tr, fa, xs, ys: rgp.traj_extend_clients(tr, fa, xs, ys, RHYPER, deferred=True))
_ref_extend_inline = jax.jit(
    lambda tr, fa, xs, ys: rgp.traj_extend_clients(tr, fa, xs, ys, RHYPER, deferred=False))


def _drive_both(seed, n_clients, cap, d, n_events, batch, clustered=False, deferred=True):
    """The same append events through the reference (vmapped) and the
    port, both with the deferred or both with the inline factor update;
    returns both final (traj, factor) pairs."""
    rtraj = jax.vmap(lambda _: rgp.traj_init(cap, d))(jnp.arange(n_clients))
    rfac = jax.vmap(lambda tr: rgp.factor_init(tr, RHYPER))(rtraj)
    traj = gp.traj_init(n_clients, cap, d, "cpu")
    fac = gp.factor_init(traj, HYPER)
    ref_extend = _ref_extend if deferred else _ref_extend_inline
    for xs, ys in _events(seed, n_clients, n_events, batch, d, clustered):
        rtraj, rfac = ref_extend(rtraj, rfac, jnp.asarray(xs), jnp.asarray(ys))
        traj, fac = gp.traj_extend_clients(traj, fac, T(xs), T(ys), HYPER, deferred=deferred)
    return (rtraj, rfac), (traj, fac)


def _f64(traj_np_xs, traj_np_ys, mask, xq):
    """float64 truth of alpha, grad mu and the uncertainty score per client."""
    out = []
    for b in range(traj_np_xs.shape[0]):
        xs = traj_np_xs[b].astype(np.float64)
        m = mask[b].astype(np.float64)
        diff2 = ((xs[:, None] - xs[None]) ** 2).sum(-1)
        g = np.exp(-0.5 * diff2 / LS**2) * np.outer(m, m) + np.diag(
            max(NOISE, 1e-4) * m + (1 - m))
        a = np.linalg.solve(g, traj_np_ys[b].astype(np.float64) * m)
        gs, us = [], []
        for x in xq[b].astype(np.float64):
            diff = x[None] - xs
            k = np.exp(-0.5 * (diff**2).sum(-1) / LS**2)
            jac = (-diff / LS**2) * (k * m)[:, None]
            gs.append(jac.T @ a)
            us.append(max(xs.shape[1] / LS**2 - (jac * np.linalg.solve(g, jac)).sum(), 0.0))
        out.append((a, np.stack(gs), np.array(us), np.linalg.cond(g)))
    return out


def _dual(got, want, truth, scale, well_posed):
    """Strict where well posed; else no less accurate than the reference."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    if well_posed:
        np.testing.assert_allclose(got, want, atol=1e-4 * scale)
    err_p, err_r = np.abs(got - truth).max(), np.abs(want - truth).max()
    assert err_p <= max(3.0 * err_r, 1e-4 * scale), (err_p, err_r, scale)


def test_traj_append_batch_matches_reference_across_wraps():
    cap, d = 5, 3
    rtr = jax.vmap(lambda _: rgp.traj_init(cap, d))(jnp.arange(2))
    tr = gp.traj_init(2, cap, d, "cpu")
    rng = np.random.default_rng(0)
    for k in (2, 4, 7, 1, 5):  # the 7-row batch wraps the ring by itself
        xs = rng.standard_normal((2, k, d)).astype(np.float32)
        ys = rng.standard_normal((2, k)).astype(np.float32)
        rtr = jax.vmap(rgp.traj_append_batch)(rtr, jnp.asarray(xs), jnp.asarray(ys))
        tr = gp.traj_append_batch(tr, T(xs), T(ys))
        np.testing.assert_array_equal(tr.xs.numpy(), N_(rtr.xs))
        np.testing.assert_array_equal(tr.ys.numpy(), N_(rtr.ys))
        np.testing.assert_array_equal(tr.count.numpy(), N_(rtr.count))
        np.testing.assert_array_equal(tr.valid_mask().numpy(),
                                      N_(jax.vmap(rgp.Trajectory.valid_mask)(rtr)))


@pytest.mark.parametrize("clustered", [False, True], ids=["well_posed", "clustered"])
@pytest.mark.parametrize("cap,batch,n_events", [(12, 3, 9), (12, 3, 3)],
                         ids=["wraps", "filling"])
def test_deferred_updates_match_reference(clustered, cap, batch, n_events):
    """Border extension while the ring fills, refresh after it wraps: the
    cached Grams, flags and counters match; the factors and everything
    solved through them obey the Sec. 2.4 rule."""
    d, nb = 3, 2
    (rtr, rfa), (tr, fa) = _drive_both(4, nb, cap, d, n_events, batch, clustered)
    np.testing.assert_allclose(fa.gram.numpy(), N_(rfa.gram), atol=1e-5)
    for f in ("exact", "n_updates", "n_refactors", "needs_repair"):
        np.testing.assert_array_equal(getattr(fa, f).numpy(), N_(getattr(rfa, f)), err_msg=f)

    rng = np.random.default_rng(9)
    u = rng.uniform(size=(nb, 4, d))
    xq = (0.4 + 0.005 * u if clustered else 3.0 * u).astype(np.float32)
    truth = _f64(tr.xs.numpy(), tr.ys.numpy(), tr.valid_mask().numpy(), xq)
    r_alpha = rgp.gp_alpha_cached_clients(rtr, rfa)
    r_grad = jax.vmap(lambda q: rgp.grad_mean_cached_clients(rtr, rfa, RHYPER, q),
                      in_axes=1, out_axes=1)(jnp.asarray(xq))
    r_unc = rgp.grad_uncertainty_batch_cached_clients(rtr, rfa, RHYPER, jnp.asarray(xq))
    p_alpha = gp.gp_alpha_cached_clients(tr, fa)
    p_grad = torch.stack([gp.grad_mean_cached_clients(tr, fa, HYPER, T(xq[:, j]))
                          for j in range(xq.shape[1])], dim=1)
    p_unc = gp.grad_uncertainty_batch_cached_clients(tr, fa, HYPER, T(xq))
    prior = d / LS**2
    for b, (a64, g64, u64, cond) in enumerate(truth):
        well = cond < 1e3
        _dual(p_alpha[b], r_alpha[b], a64, 1.0 + np.abs(a64).max(), well)
        _dual(p_grad[b], r_grad[b], g64, 1.0 + np.abs(g64).max(), well)
        _dual(p_unc[b], r_unc[b], u64, prior, well)
    if not clustered:
        assert all(t[3] < 1e3 for t in truth)  # the strict branch really ran


@pytest.mark.parametrize("clustered", [False, True], ids=["well_posed", "clustered"])
@pytest.mark.parametrize("cap,batch,n_events", [(12, 3, 9), (12, 3, 3)],
                         ids=["wraps", "filling"])
def test_inline_updates_match_reference(clustered, cap, batch, n_events):
    """The per-client engine's inline update (``deferred=False``) against the
    reference's: the same Grams, flags and counters, where the clustered
    ring makes the clamped-eigh fallback fire; then the single-client
    cached functions of every client under the Sec. 2.4 rule."""
    d, nb = 3, 2
    (rtr, rfa), (tr, fa) = _drive_both(4, nb, cap, d, n_events, batch, clustered,
                                       deferred=False)
    np.testing.assert_allclose(fa.gram.numpy(), N_(rfa.gram), atol=1e-5)
    for f in ("exact", "n_updates", "n_refactors", "needs_repair"):
        np.testing.assert_array_equal(getattr(fa, f).numpy(), N_(getattr(rfa, f)), err_msg=f)
    assert not fa.needs_repair.any()

    rng = np.random.default_rng(9)
    u = rng.uniform(size=(nb, 4, d))
    xq = (0.4 + 0.005 * u if clustered else 3.0 * u).astype(np.float32)
    truth = _f64(tr.xs.numpy(), tr.ys.numpy(), tr.valid_mask().numpy(), xq)
    prior = d / LS**2
    for b, (a64, g64, u64, cond) in enumerate(truth):
        rt, rf = (jax.tree_util.tree_map(lambda a: a[b], t) for t in (rtr, rfa))
        pt, pf = gp.client(tr, b), gp.client(fa, b)
        alpha = gp.gp_alpha_cached(pt, pf, HYPER)
        grad = torch.stack([gp.grad_mean_cached(pt, pf, HYPER, T(x)) for x in xq[b]])
        unc = gp.grad_uncertainty_batch_cached(pt, pf, HYPER, T(xq[b]))
        r_grad = jnp.stack([rgp.grad_mean_cached(rt, rf, RHYPER, jnp.asarray(x))
                            for x in xq[b]])
        well = cond < 1e3
        _dual(alpha, rgp.gp_alpha_cached(rt, rf, RHYPER), a64, 1.0 + np.abs(a64).max(), well)
        _dual(grad, r_grad, g64, 1.0 + np.abs(g64).max(), well)
        _dual(unc, rgp.grad_uncertainty_batch_cached(rt, rf, RHYPER, jnp.asarray(xq[b])), u64,
              prior, well)


@pytest.mark.parametrize("clustered", [False, True], ids=["well_posed", "clustered"])
def test_seed_eigh_path_matches_reference(clustered):
    """The from-scratch eigh path of ``use_factor_cache=False`` on six
    wrapped rings: alpha, the gradient mean (one point and a batch), the
    scores and the posterior mean; the active-query picks where well posed.
    On the clustered rings (cond ~1e5) each side's f32 error is noise of
    either sign from ring to ring, so the Sec. 2.4 rule is applied to the
    largest error over all six rings, not ring by ring."""
    d, cap, rings = 3, 10, 6
    rng = np.random.default_rng(3)
    got, want, truth, conds = {}, {}, {}, []
    for _ in range(rings):
        xs = rng.uniform(size=(cap, d))
        xs = (0.4 + 0.005 * xs if clustered else 3.0 * xs).astype(np.float32)
        ys = np.sin(3.0 * xs.sum(-1)).astype(np.float32)
        rtr = rgp.Trajectory(jnp.asarray(xs), jnp.asarray(ys), jnp.asarray(13, jnp.int32))
        tr = gp.Trajectory(T(xs), T(ys), torch.tensor(13, dtype=torch.int32))
        xq = (xs[:6] + 0.003 * rng.standard_normal((6, d))).astype(np.float32)
        rq = jnp.asarray(xq)
        a64, g64, u64, cond = _f64(xs[None], ys[None], np.ones((1, cap), np.float32), xq[None])[0]
        k = np.exp(-0.5 * ((xq[2].astype(np.float64) - xs) ** 2).sum(-1) / LS**2)
        conds.append(cond)
        for name, p_, r_, t_ in (
                ("alpha", gp.gp_alpha(tr, HYPER), rgp.gp_alpha(rtr, RHYPER), a64),
                ("grad", gp.grad_mean(tr, HYPER, T(xq[0])), rgp.grad_mean(rtr, RHYPER, rq[0]),
                 g64[0]),
                ("grad_batch", gp.grad_mean_batch(tr, HYPER, T(xq)),
                 rgp.grad_mean_batch(rtr, RHYPER, rq), g64),
                ("trace", gp.grad_uncertainty_trace(tr, HYPER, T(xq[1])),
                 rgp.grad_uncertainty_trace(rtr, RHYPER, rq[1]), u64[1]),
                ("scores", gp.grad_uncertainty_batch(tr, HYPER, T(xq)),
                 rgp.grad_uncertainty_batch(rtr, RHYPER, rq), u64),
                ("mean", gp.mean_value(tr, HYPER, T(xq[2])), rgp.mean_value(rtr, RHYPER, rq[2]),
                 k @ a64)):
            got.setdefault(name, []).append(np.ravel(N_(p_)))
            want.setdefault(name, []).append(np.ravel(N_(r_)))
            truth.setdefault(name, []).append(np.ravel(t_))
        if not clustered:  # the picks follow the scores; near-ties make them fragile otherwise
            key = jax.random.PRNGKey(8)
            deltas = jax.random.uniform(key, (12, d), minval=-0.5, maxval=0.5)
            r_pick = rgp.select_active_queries(key, rtr, RHYPER, jnp.asarray(xs[0]), 12, 3, 0.5)
            p_pick = gp.select_active_queries(T(deltas), tr, HYPER, T(xs[0]), 3)
            np.testing.assert_allclose(p_pick.numpy(), N_(r_pick), atol=1e-6)
    well = max(conds) < 1e3
    assert well != clustered
    for name in got:
        t_ = np.concatenate(truth[name])
        scale = d / LS**2 if name in ("trace", "scores") else 1.0 + np.abs(t_).max()
        _dual(np.concatenate(got[name]), np.concatenate(want[name]), t_, scale, well)


def test_inline_fallback_matches_reference():
    """The inline update's clamped-eigh fallback, event by event, against
    the reference's.  Client 0's cached Gram is poisoned indefinite (one
    off-diagonal pair set to 5), so every refresh fails the health check on
    both sides until the ring wraps and overwrites the poisoned rows; the
    f32 Gram of a real clustered ring at these sizes stays above the pivot
    floor, where a far-off cluster puts it below only by rounding (the
    firing events then differ between any two f32 implementations).
    Client 1 keeps bordering, then refreshes after the wrap."""
    cap, d = 12, 3
    (rtr, rfa), (tr, fa) = _drive_both(5, 2, cap, d, 3, 2, deferred=False)
    bad = fa.gram.clone()
    bad[0, 0, 1] = bad[0, 1, 0] = 5.0
    exact = torch.tensor([False, True])
    fa = fa._replace(gram=bad, exact=exact)
    rfa = rfa._replace(gram=jnp.asarray(bad.numpy()), exact=jnp.asarray(exact.numpy()))
    rng = np.random.default_rng(6)
    fired = []
    for step in range(8):  # counts 6 -> 14: the ring wraps at the 7th event
        xs = rng.uniform(size=(2, 1, d)).astype(np.float32)
        ys = xs.sum(-1)
        rtr, rfa = _ref_extend_inline(rtr, rfa, jnp.asarray(xs), jnp.asarray(ys))
        tr, fa = gp.traj_extend_clients(tr, fa, T(xs), T(ys), HYPER, deferred=False)
        for f in ("exact", "n_updates", "n_refactors", "needs_repair"):
            np.testing.assert_array_equal(getattr(fa, f).numpy(), N_(getattr(rfa, f)),
                                          err_msg=f"{f} at step {step}")
        np.testing.assert_allclose(fa.gram.numpy(), N_(rfa.gram), atol=1e-5)
        # the solves, against a float64 clamped-eigh solve of the same Gram
        b = (tr.ys * tr.valid_mask()).numpy()
        got = gp.factor_solve(fa, T(b)).numpy()
        want = N_(jax.vmap(rgp.factor_solve)(rfa, jnp.asarray(b)))
        for c in range(2):
            w, v = np.linalg.eigh(fa.gram[c].double().numpy())
            truth = v @ ((v.T @ b[c]) / np.maximum(w, max(NOISE, 1e-4)))
            _dual(got[c], want[c], truth, 1.0 + np.abs(truth).max(),
                  well_posed=np.abs(w).max() / np.maximum(np.abs(w).min(), 1e-4) < 1e3)
        fired.append(fa.exact.tolist())
    assert fired[0] == [False, True] and fired[-1] == [True, True]
    assert fa.n_refactors.tolist()[1] == 0 and fa.n_refactors.tolist()[0] >= 6


def test_single_client_selection_matches_reference():
    """``select_active_queries_cached`` of one client, deltas from the
    reference's key, on the resident and a pinned tiled route."""
    cap, d = 12, 3
    (rtr, rfa), (tr, fa) = _drive_both(2, 1, cap, d, 3, 3, deferred=False)
    rt, rf = (jax.tree_util.tree_map(lambda a: a[0], t) for t in (rtr, rfa))
    key = jax.random.PRNGKey(6)
    center = jnp.asarray(rt.xs[4])
    want = rgp.select_active_queries_cached(key, rt, rf, RHYPER, center, 16, 4, 0.5)
    deltas = T(jax.random.uniform(key, (16, d), minval=-0.5, maxval=0.5))
    for pins in (dict(), dict(block_n=4, block_cap=8)):
        got = gp.select_active_queries_cached(deltas, gp.client(tr, 0), gp.client(fa, 0), HYPER,
                                              T(center), 4, **pins)
        np.testing.assert_allclose(got.numpy(), N_(want), atol=1e-6)


class _States(NamedTuple):
    factor: gp.GramFactor


class _Cfg(NamedTuple):
    deferred: bool = True
    noise: float = NOISE


def test_repair_sequence_matches_reference():
    """An indefinite cached Gram flags its client and freezes its factor
    through later updates; the repair pass gives it the clamped-eigh
    factors, as the reference's does; the other client is untouched."""
    cap, d = 12, 3
    (rtr, rfa), (tr, fa) = _drive_both(5, 2, cap, d, 3, 2)
    bad = fa.gram.clone()
    bad[0, 0, 1] = bad[0, 1, 0] = 5.0
    exact = torch.tensor([False, True])  # client 0 takes the refresh route
    fa = fa._replace(gram=bad, exact=exact)
    rfa = rfa._replace(gram=jnp.asarray(bad.numpy()), exact=jnp.asarray(exact.numpy()))
    frozen = fa.chol[0].clone()
    rng = np.random.default_rng(6)
    for step in range(4):
        xs = rng.uniform(size=(2, 1, d)).astype(np.float32)
        ys = xs.sum(-1)
        rtr, rfa = _ref_extend(rtr, rfa, jnp.asarray(xs), jnp.asarray(ys))
        tr, fa = gp.traj_extend_clients(tr, fa, T(xs), T(ys), HYPER)
        if step == 2:  # the between-rounds repair pass
            rfa = rgp.factor_repair_gated(rfa, jnp.float32(max(NOISE, 1e-4)))
            states, n_rep = rounds.repair_flagged_clients(_States(fa), _Cfg())
            fa = states.factor
            assert n_rep == 1
            b = tr.ys * tr.valid_mask()
            np.testing.assert_allclose(
                gp.factor_solve(fa, b).numpy(),
                N_(jax.vmap(rgp.factor_solve)(rfa, jnp.asarray(b.numpy()))),
                rtol=1e-4, atol=1e-4)
        else:
            assert fa.needs_repair.tolist() == [True, False]
            if step < 2:
                np.testing.assert_array_equal(fa.chol[0].numpy(), frozen.numpy())
        for f in ("exact", "n_updates", "n_refactors", "needs_repair"):
            np.testing.assert_array_equal(getattr(fa, f).numpy(), N_(getattr(rfa, f)),
                                          err_msg=f"{f} at step {step}")
        np.testing.assert_allclose(fa.gram.numpy(), N_(rfa.gram), atol=1e-5)
    gram, _ = gp._padded_gram(tr, HYPER)
    np.testing.assert_allclose(fa.chol[1].numpy(), torch.linalg.cholesky(gram[1]).numpy(),
                               atol=2e-5)


@pytest.mark.parametrize("cap,batch,n_events,seed", [(29, 5, 13, 1649630309)])
def test_recorded_factor_cache_case_against_float64(cap, batch, n_events, seed):
    """The Hypothesis example recorded for test_factor_cache.py
    (cap=29, batch=5, n_events=13, seed=1649630309), where the reference's
    cached alpha misses its own bound.  The port, held to the float64
    truth, must meet the bound the reference is held to there: within 3x
    the clamped-eigh oracle's error (floor 1e-4 of the scale) for alpha,
    grad mu and the scores."""
    d = 4
    key = jax.random.PRNGKey(seed)
    tr = gp.traj_init(1, cap, d, "cpu")
    fa = gp.factor_init(tr, HYPER)
    rtr = rgp.traj_init(cap, d)
    for i in range(n_events):  # the data of test_factor_cache._random_walk_traj
        xs = jax.random.uniform(jax.random.fold_in(key, i), (batch, d))
        ys = jnp.sin(3.0 * xs.sum(-1))
        rtr = rgp.traj_append_batch(rtr, xs, ys)
        tr, fa = gp.traj_extend_clients(tr, fa, T(xs)[None], T(ys)[None], HYPER)
        fa = gp.factor_repair_gated(fa, max(NOISE, 1e-4))
    np.testing.assert_array_equal(tr.xs[0].numpy(), N_(rtr.xs))
    xq = N_(jax.random.uniform(jax.random.fold_in(key, 777), (5, d)))
    a64, g64, u64, _ = _f64(tr.xs.numpy(), tr.ys.numpy(), tr.valid_mask().numpy(), xq[None])[0]

    def within(got, oracle, truth, scale):
        err_p = np.abs(np.asarray(got, np.float64) - truth).max()
        err_o = np.abs(np.asarray(oracle, np.float64) - truth).max()
        assert err_p <= max(3.0 * err_o, 1e-4 * scale), (err_p, err_o)

    alpha = gp.gp_alpha_cached_clients(tr, fa)
    within(alpha[0], rgp.gp_alpha(rtr, RHYPER), a64, 1.0 + np.abs(a64).max())
    grad = ops.grad_mean_clients(T(xq)[None], tr.xs, alpha, lengthscale=LS)[0]
    within(grad, rgp.grad_mean_batch(rtr, RHYPER, jnp.asarray(xq)), g64,
           1.0 + np.abs(g64).max())
    unc = gp.grad_uncertainty_batch_cached_clients(tr, fa, HYPER, T(xq)[None])[0]
    within(unc, rgp.grad_uncertainty_batch(rtr, RHYPER, jnp.asarray(xq)), u64, d / LS**2)


def test_factor_init_fallback_matches_reference(monkeypatch):
    """``factor_init`` on a ring of repeated points: its live pivots sit at
    sqrt(jitter), which a pivot floor raised to 1.5 sqrt(jitter) (patched
    on both sides for this test) declares unhealthy, so that client starts
    on the clamped-eigh factors while the spread-out client keeps Cholesky."""
    monkeypatch.setattr(rgp, "PIVOT_FLOOR_SCALE", 1.5)
    monkeypatch.setattr(gp, "PIVOT_FLOOR_SCALE", 1.5)
    rng = np.random.default_rng(2)
    xs = rng.uniform(size=(2, 10, 3)).astype(np.float32)
    xs[0] = 0.5  # client 0: one point repeated
    xs[1] *= 3.0
    ys = rng.standard_normal((2, 10)).astype(np.float32)
    count = np.array([10, 6], np.int32)
    rfa = jax.vmap(lambda t: rgp.factor_init(t, RHYPER))(
        rgp.Trajectory(jnp.asarray(xs), jnp.asarray(ys), jnp.asarray(count)))
    tr = gp.Trajectory(T(xs), T(ys), T(count))
    fa = gp.factor_init(tr, HYPER)
    assert fa.exact.tolist() == [False, True] == N_(rfa.exact).tolist()
    np.testing.assert_array_equal(fa.n_refactors.numpy(), N_(rfa.n_refactors))
    np.testing.assert_allclose(fa.eigvals.numpy(), N_(rfa.eigvals), atol=1e-5)
    # The repeated points make client 0's Gram rank one plus jitter (cond
    # 1e4): its clamped-eigh solve is compared under the Sec. 2.4 rule with
    # a float64 clamped-eigh solve of the same Gram as the truth.
    b = (tr.ys * tr.valid_mask()).numpy()
    got = gp.factor_solve(fa, T(b)).numpy()
    want = N_(jax.vmap(rgp.factor_solve)(rfa, jnp.asarray(b)))
    for c in range(2):
        w, v = np.linalg.eigh(fa.gram[c].double().numpy())
        truth = v @ ((v.T @ b[c]) / np.maximum(w, max(NOISE, 1e-4)))
        _dual(got[c], want[c], truth, 1.0 + np.abs(truth).max(), well_posed=c == 1)


def _spy(monkeypatch, module, name):
    """Count the calls of ``module.name`` for the length of one test."""
    calls = []
    real = getattr(module, name)
    monkeypatch.setattr(module, name, lambda *a, **k: calls.append(1) or real(*a, **k))
    return calls


@pytest.mark.parametrize("clustered", [False, True], ids=["well_posed", "clustered"])
def test_sqexp_routes_through_ops_and_matches_reference(monkeypatch, clustered):
    """``gp.sqexp`` is one ``ops.sqexp`` call (B9 on the card), client-batched
    and 2-D, and agrees with the reference's ``sqexp`` per client to 1e-5,
    the cached Gram's bound (module docstring); so do the Gram rows an
    append event writes and ``mean_value``, which go through it."""
    calls = _spy(monkeypatch, ops, "sqexp")
    (x1, _), (x2, _) = _events(4, 3, 2, 6, 3, clustered)
    got = gp.sqexp(T(x1), T(x2), LS)
    assert got.shape == (3, 6, 6) and len(calls) == 1
    for c in range(3):
        want = N_(rgp.sqexp(jnp.asarray(x1[c]), jnp.asarray(x2[c]), LS))
        np.testing.assert_allclose(got[c].numpy(), want, atol=1e-5)
        np.testing.assert_allclose(gp.sqexp(T(x1[c]), T(x2[c]), LS).numpy(), want, atol=1e-5)
    assert len(calls) == 4
    (rtr, rfa), (tr, fa) = _drive_both(5, 2, 8, 3, 2, 3, clustered)
    assert len(calls) == 4 + 1 + 2  # then factor_init and one per append event
    np.testing.assert_allclose(fa.gram.numpy(), N_(rfa.gram), atol=1e-5)
    xq = x1[0, 0]
    got_m = gp.mean_value(gp.client(tr, 0), HYPER, T(xq)).numpy()
    want_m = N_(rgp.mean_value(jax.tree_util.tree_map(lambda a: a[0], rtr), RHYPER,
                               jnp.asarray(xq)))
    a, _, _, cond = _f64(tr.xs.numpy()[:1], tr.ys.numpy()[:1], tr.valid_mask().numpy()[:1],
                         xq[None, None])[0]
    xs64 = tr.xs[0].double().numpy()
    truth = np.exp(-0.5 * ((xq - xs64) ** 2).sum(-1) / LS**2) * tr.valid_mask()[0].numpy() @ a
    _dual(got_m, want_m, truth, 1.0 + abs(truth), well_posed=cond < 1e3)
