"""Port parity of the GP kernels, client-batched (B1-B4) and single-client
(B7, B8), of the RFF feature and gradient kernels (B6, B5) and the SE Gram
(B9), of their wrappers, and of the cluster kernels' launch geometry.

The same numpy inputs go through the reference ``repro.kernels.ops`` (its
Pallas kernels in interpret mode via ``force_pallas=True``, and its jnp
oracles) and through ``repro_torch.kernels.ops`` on CPU tensors, which runs
the plain torch versions after the same padding and resident/tiled routing
the CUDA kernels get.  On CUDA tensors the wrappers launch the kernels:
those tests skip without a card.

Tolerance: scores and gradients are compared after scaling by
max(|reference|, 1) with atol 5e-5, the bound the reference's own kernel
tests use (tests/test_kernels.py): both sides are f32 contractions over cap
terms in different orders, so they agree to a few f32 ulps of the largest
partial sum, far inside 5e-5.  The RFF features, the RFF gradient and the
SE Gram are held to 2e-5 absolute (after scaling by max(|reference|, 1)),
the bound the reference's own RFF tests use (tests/test_kernels.py): single
f32 products over d, then over M, in different orders.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as rops
from repro.kernels import ref as rref
from repro.core import rff as rrff
from repro_torch.kernels import autotune, gp_grad, gp_score, ops, ref
from repro_torch.kernels import rff_features as krff_features
from repro_torch.kernels import rff_grad as krff_grad
from repro_torch.kernels import sqexp as ksqexp

ATOL = 5e-5
LS = 0.7


def _inputs(nb, n, d, cap, seed):
    """Candidates near the trajectory (so h is far from 0 and 1) and a
    well-conditioned masked inverse B with P = B o XX^T."""
    rng = np.random.default_rng(seed)
    xs = (0.5 + 0.1 * rng.standard_normal((nb, cap, d))).astype(np.float32)
    cands = (0.5 + 0.1 * rng.standard_normal((nb, n, d))).astype(np.float32)
    a = rng.standard_normal((nb, cap, cap)) / np.sqrt(cap)
    binv = (a @ a.transpose(0, 2, 1) + 0.1 * np.eye(cap)).astype(np.float32)
    pmat = (binv * (xs @ xs.transpose(0, 2, 1))).astype(np.float32)
    alpha = rng.standard_normal((nb, cap)).astype(np.float32)
    return cands, xs, binv, pmat, alpha


def _close(got, want, atol=ATOL):
    want = np.asarray(want)
    scale = max(float(np.abs(want).max()), 1.0)
    np.testing.assert_allclose(np.asarray(got) / scale, want / scale, atol=atol)


T = lambda a: torch.from_numpy(np.array(a))

# (N, n, d, cap, block_cap): block_cap None takes the tuner's choice, which
# at these sizes is the resident route; 8 and 12 force the tiled route (12
# does not divide cap=20, so the trajectory axis is zero-padded).
ROUTES = [
    pytest.param(2, 5, 4, 16, None, id="resident"),
    pytest.param(2, 5, 4, 16, 8, id="tiled"),
    pytest.param(3, 6, 3, 20, 12, id="tiled_padded_cap"),
]


@pytest.mark.parametrize("nb,n,d,cap,block_cap", ROUTES)
def test_scores_match_reference(nb, n, d, cap, block_cap):
    cands, xs, binv, pmat, _ = _inputs(nb, n, d, cap, seed=cap + n)
    prior = d / LS**2
    bn = None if block_cap is None else 4
    got = ops.uncertainty_scores_clients(T(cands), T(xs), T(binv), T(pmat), lengthscale=LS,
                                         prior=prior, block_n=bn, block_cap=block_cap)
    assert got.shape == (nb, n)
    pallas = rops.uncertainty_scores_clients(
        jnp.asarray(cands), jnp.asarray(xs), jnp.asarray(binv), jnp.asarray(pmat),
        lengthscale=LS, prior=prior, block_n=8, block_cap=block_cap, force_pallas=True)
    oracle = rref.uncertainty_scores_clients(cands, xs, binv, pmat, LS, prior)
    _close(got, pallas)
    _close(got, oracle)


@pytest.mark.parametrize("nb,n,d,cap,block_cap", ROUTES)
def test_grad_mean_matches_reference(nb, n, d, cap, block_cap):
    cands, xs, _, _, alpha = _inputs(nb, n, d, cap, seed=cap + 2 * n)
    bn = None if block_cap is None else 2
    got = ops.grad_mean_clients(T(cands), T(xs), T(alpha), lengthscale=LS, block_n=bn,
                                block_cap=block_cap)
    assert got.shape == (nb, n, d)
    pallas = rops.grad_mean_clients(jnp.asarray(cands), jnp.asarray(xs), jnp.asarray(alpha),
                                    lengthscale=LS, block_n=8, block_cap=block_cap,
                                    force_pallas=True)
    oracle = rref.grad_mean_clients(cands, xs, alpha, LS)
    _close(got, pallas)
    _close(got, oracle)


@pytest.mark.parametrize("nb,n,d,cap,block_cap", ROUTES)
def test_single_client_scores_match_reference(nb, n, d, cap, block_cap):
    """``ops.uncertainty_scores`` (B7a resident, B7b tiled) for one client."""
    cands, xs, binv, pmat, _ = (a[0] for a in _inputs(1, n, d, cap, seed=cap + 3 * n))
    prior = d / LS**2
    bn = None if block_cap is None else 4
    got = ops.uncertainty_scores(T(cands), T(xs), T(binv), T(pmat), lengthscale=LS,
                                 prior=prior, block_n=bn, block_cap=block_cap)
    assert got.shape == (n,)
    pallas = rops.uncertainty_scores(
        jnp.asarray(cands), jnp.asarray(xs), jnp.asarray(binv), jnp.asarray(pmat),
        lengthscale=LS, prior=prior, block_n=8, block_cap=block_cap, force_pallas=True)
    _close(got, pallas)
    _close(got, rref.uncertainty_scores(cands, xs, binv, pmat, LS, prior))


@pytest.mark.parametrize("nb,n,d,cap,block_cap", ROUTES)
def test_single_client_grad_mean_matches_reference(nb, n, d, cap, block_cap):
    """``ops.grad_mean_batch`` (B8a resident, B8b tiled) for one client."""
    cands, xs, _, _, alpha = (a[0] for a in _inputs(1, n, d, cap, seed=cap + 4 * n))
    bn = None if block_cap is None else 2
    got = ops.grad_mean_batch(T(cands), T(xs), T(alpha), lengthscale=LS, block_n=bn,
                              block_cap=block_cap)
    assert got.shape == (n, d)
    pallas = rops.grad_mean_batch(jnp.asarray(cands), jnp.asarray(xs), jnp.asarray(alpha),
                                  lengthscale=LS, block_n=8, block_cap=block_cap,
                                  force_pallas=True)
    _close(got, pallas)
    _close(got, rref.grad_mean_batch(cands, xs, alpha, LS))


def test_torch_oracles_match_reference_oracles():
    """ref.py: textbook and fused scores and the gradient mean, torch vs jnp."""
    cands, xs, binv, pmat, alpha = _inputs(3, 7, 5, 24, seed=11)
    prior = 5 / LS**2
    _close(ref.uncertainty_scores_clients(T(cands), T(xs), T(binv), T(pmat), LS, prior),
           rref.uncertainty_scores_clients(cands, xs, binv, pmat, LS, prior))
    _close(ref.uncertainty_scores_clients_fused(T(cands), T(xs), T(binv), T(pmat), LS, prior),
           rref.uncertainty_scores_clients_fused(cands, xs, binv, pmat, LS, prior))
    _close(ref.grad_mean_clients(T(cands), T(xs), T(alpha), LS),
           rref.grad_mean_clients(cands, xs, alpha, LS))
    _close(ref.uncertainty_scores(T(cands[1]), T(xs[1]), T(binv[1]), T(pmat[1]), LS, prior),
           rref.uncertainty_scores(cands[1], xs[1], binv[1], pmat[1], LS, prior))
    _close(ref.grad_mean_batch(T(cands[2]), T(xs[2]), T(alpha[2]), LS),
           rref.grad_mean_batch(cands[2], xs[2], alpha[2], LS))


def test_padded_slots_contribute_zero():
    """Zero-padding the trajectory axis (zero B/P rows and columns, zero
    alpha) leaves the tiled plain versions unchanged."""
    cands, xs, binv, pmat, alpha = _inputs(2, 4, 3, 12, seed=5)
    args = (T(cands), T(xs), T(binv), T(pmat))
    base = gp_score.scores_tiled_plain(*args, LS, 3 / LS**2, 12)
    padded = gp_score.scores_tiled_plain(
        T(cands), ops._pad_axis(T(xs), 1, 16), ops._pad_gram(T(binv), 16),
        ops._pad_gram(T(pmat), 16), LS, 3 / LS**2, 8)
    _close(padded, base)
    g = gp_grad.grad_mean_tiled_plain(T(cands), T(xs), T(alpha), LS, 12)
    gp_ = gp_grad.grad_mean_tiled_plain(T(cands), ops._pad_axis(T(xs), 1, 16),
                                        ops._pad_axis(T(alpha), 1, 16), LS, 8)
    _close(gp_, g)


def test_single_client_padded_slots_contribute_zero():
    """Zero-padding one client's trajectory axis leaves the single-client
    tiled wrappers' results unchanged."""
    cands, xs, binv, pmat, alpha = (T(a[0]) for a in _inputs(1, 4, 3, 12, seed=7))
    kw = dict(lengthscale=LS, prior=3 / LS**2, block_n=4)
    base = gp_score.uncertainty_scores_single_tiled(cands, xs, binv, pmat, block_cap=12, **kw)
    padded = gp_score.uncertainty_scores_single_tiled(
        cands, ops._pad_axis(xs, 0, 16), ops._pad_gram(binv, 16), ops._pad_gram(pmat, 16),
        block_cap=8, **kw)
    _close(padded, base)
    g = gp_grad.grad_mean_single_tiled(cands, xs, alpha, lengthscale=LS, block_n=2,
                                       block_cap=12)
    g_pad = gp_grad.grad_mean_single_tiled(cands, ops._pad_axis(xs, 0, 16),
                                           ops._pad_axis(alpha, 0, 16), lengthscale=LS,
                                           block_n=2, block_cap=8)
    _close(g_pad, g)


# The RFF and SE Gram inputs as the engines build them: points in [0,1]^d
# (iterates and ring slots near 0.5 for the Gram, so K is far from 0 and
# 1), the bank v ~ N(0, I/l^2) at l=0.5 (projections of 20-60 at d=300),
# phases in [0, 2 pi), weights ~ N(0, 1).
RFF_LS = 0.5
RFF_ATOL = 2e-5


def _rff_inputs(n, d, m, seed):
    rng = np.random.default_rng(seed)
    x = rng.uniform(size=(n, d)).astype(np.float32)
    v = (rng.standard_normal((m, d)) / RFF_LS).astype(np.float32)
    b = rng.uniform(0.0, 2.0 * np.pi, size=m).astype(np.float32)
    ws = rng.standard_normal((n, m)).astype(np.float32)
    return x, v, b, ws


def _gram_inputs(nb, a, c, d, seed, center=0.5):
    rng = np.random.default_rng(seed)
    x1 = (center + 0.02 * rng.standard_normal((nb, a, d))).astype(np.float32)
    x2 = (center + 0.02 * rng.standard_normal((nb, c, d))).astype(np.float32)
    return x1, x2


def _gram_truth(x1, x2):
    a, b = x1.astype(np.float64), x2.astype(np.float64)
    return np.exp(-0.5 * ((a[:, None, :] - b[None, :, :]) ** 2).sum(-1) / RFF_LS**2)


def _close_gram(got, refs, truth):
    """The expanded distance cancels in f32 where |x|^2 >> |x1 - x2|^2: with
    points near 0.5 at d=300 (|x|^2 ~ 75, the append events' shape) every
    f32 Gram sits up to ~2e-4 from the float64 one, by its summation order
    alone, the reference's Pallas kernel and oracle included.  There the
    port must be no less accurate than the reference against float64
    (DESIGN.md Sec. 2.4): within 3x the larger error of the reference's
    implementations ``refs``, floor 2e-5."""
    ref_err = max(float(np.abs(np.asarray(r) - truth).max()) for r in refs)
    assert float(np.abs(np.asarray(got) - truth).max()) <= max(2e-5, 3.0 * ref_err)


# (n, d, M): the main path's B5 shape (n=N=5, d=300, M=512), a ragged one
# with the launcher's M=1000, and a degenerate one.
RFF_SHAPES = [(5, 300, 512), (7, 33, 1000), (1, 4, 3)]


@pytest.mark.parametrize("n,d,m", RFF_SHAPES)
def test_rff_features_match_reference(n, d, m):
    """``ops.rff_features`` (B6's plain version) against the reference's
    Pallas kernel in interpret mode and its jnp oracle, 2-D and with a
    leading client axis flattened into rows."""
    x, v, b, _ = _rff_inputs(n, d, m, seed=n + d)
    got = ops.rff_features(T(x), T(v), T(b))
    assert got.shape == (n, m)
    pallas = rops.rff_features(jnp.asarray(x), jnp.asarray(v), jnp.asarray(b), block_n=8,
                               block_m=128, force_pallas=True)
    _close(got, pallas, RFF_ATOL)
    _close(got, rref.rff_features(x, v, b), RFF_ATOL)
    x3 = np.stack([x, x[::-1]])  # (2, n, d): one launch for both clients' rows
    got3 = ops.rff_features(T(x3), T(v), T(b))
    assert got3.shape == (2, n, m)
    _close(got3[1], rref.rff_features(x[::-1], v, b), RFF_ATOL)


@pytest.mark.parametrize("n,d,m", RFF_SHAPES)
def test_rff_grad_matches_reference(n, d, m):
    """``ops.rff_grad`` (one w) against the reference's Pallas kernel in
    interpret mode and its oracle; ``ops.rff_grad_rows`` (one w per row,
    the engine's form) row by row against the same, and against the
    reference's ``grad_features_t_w_rows``."""
    x, v, b, ws = _rff_inputs(n, d, m, seed=2 * n + d)
    got = ops.rff_grad(T(x), T(v), T(b), T(ws[0]))
    assert got.shape == (n, d)
    j = lambda a: jnp.asarray(a)
    pallas = rops.rff_grad(j(x), j(v), j(b), j(ws[0]), block_n=8, block_m=128,
                           force_pallas=True)
    _close(got, pallas, RFF_ATOL)
    _close(got, rref.rff_grad(x, v, b, ws[0]), RFF_ATOL)
    rows = ops.rff_grad_rows(T(x), T(v), T(b), T(ws))
    assert rows.shape == (n, d)
    bank = rrff.RFFParams(v=j(v), b=j(b))
    _close(rows, rrff.grad_features_t_w_rows(bank, j(x), j(ws)), RFF_ATOL)
    for i in range(n):
        _close(rows[i:i + 1], rops.rff_grad(j(x[i:i + 1]), j(v), j(b), j(ws[i]), block_n=8,
                                            block_m=128, force_pallas=True), RFF_ATOL)


@pytest.mark.parametrize("nb,a,c,d", [(5, 5, 192, 300), (3, 7, 33, 20), (2, 1, 3, 4)],
                         ids=["append_event", "ragged", "degenerate"])
def test_sqexp_matches_reference(nb, a, c, d):
    """``ops.sqexp`` (B9's plain version), client-batched and 2-D, against
    the reference's Pallas kernel in interpret mode and its oracle, per
    client: within 2e-5 on points near 0 (no cancellation), and no less
    accurate than the reference on points near 0.5 (``_close_gram``)."""
    for center in (0.0, 0.5):
        x1, x2 = _gram_inputs(nb, a, c, d, seed=a + c + d, center=center)
        got = ops.sqexp(T(x1), T(x2), RFF_LS)
        assert got.shape == (nb, a, c)
        for i in range(nb + 1):  # client i of the batch; then client 0 as a 2-D call
            g = got[i] if i < nb else ops.sqexp(T(x1[0]), T(x2[0]), RFF_LS)
            i %= nb
            pallas = rops.sqexp(jnp.asarray(x1[i]), jnp.asarray(x2[i]), RFF_LS, block_n=8,
                                block_m=128, force_pallas=True)
            oracle = rref.sqexp(x1[i], x2[i], RFF_LS)
            assert g.shape == (a, c)
            if center == 0.0:
                _close(g, pallas, RFF_ATOL)
                _close(g, oracle, RFF_ATOL)
            else:
                _close_gram(g, (pallas, oracle), _gram_truth(x1[i], x2[i]))


@pytest.mark.parametrize("nb,a,c,d", [(5, 5, 192, 300), (3, 2, 16, 16)],
                         ids=["append_event", "small_attack"])
def test_cpu_sqexp_is_the_float64_gram_rounded(nb, a, c, d):
    """On CPU tensors ``ops.sqexp`` takes its distances in float64
    (``ref.sqexp_f64``): on points near 0.5, where the f32 expanded distance
    cancels, it is the float64 Gram rounded to f32 (within 1e-7 on values
    in (0, 1]), while the reference's f32 oracle is further off."""
    x1, x2 = _gram_inputs(nb, a, c, d, seed=a + c + d)
    got = ops.sqexp(T(x1), T(x2), RFF_LS).numpy()
    for i in range(nb):
        truth = _gram_truth(x1[i], x2[i])
        err = float(np.abs(got[i] - truth).max())
        ref_err = float(np.abs(np.asarray(rref.sqexp(x1[i], x2[i], RFF_LS)) - truth).max())
        assert err <= 1e-7 and err < ref_err, (err, ref_err)


def test_rff_and_gram_oracles_match_reference_oracles():
    """ref.py's rff_features, rff_grad, rff_grad_rows and sqexp against
    repro.kernels.ref (and the reference core's per-row form)."""
    x, v, b, ws = _rff_inputs(6, 9, 40, seed=4)
    _close(ref.rff_features(T(x), T(v), T(b)), rref.rff_features(x, v, b), RFF_ATOL)
    _close(ref.rff_grad(T(x), T(v), T(b), T(ws[2])), rref.rff_grad(x, v, b, ws[2]), RFF_ATOL)
    bank = rrff.RFFParams(v=jnp.asarray(v), b=jnp.asarray(b))
    _close(ref.rff_grad_rows(T(x), T(v), T(b), T(ws)),
           rrff.grad_features_t_w_rows(bank, jnp.asarray(x), jnp.asarray(ws)), RFF_ATOL)
    x1, x2 = _gram_inputs(2, 4, 6, 5, seed=8, center=0.0)
    _close(ref.sqexp(T(x1[1]), T(x2[1]), RFF_LS), rref.sqexp(x1[1], x2[1], RFF_LS), RFF_ATOL)
    batched = ref.sqexp(T(x1), T(x2), RFF_LS)
    for i in range(2):
        _close(batched[i], rref.sqexp(x1[i], x2[i], RFF_LS), RFF_ATOL)


def _all_launches():
    return {**gp_score.LAUNCHES, **gp_grad.LAUNCHES, **krff_features.LAUNCHES,
            **krff_grad.LAUNCHES, **ksqexp.LAUNCHES}


def test_cpu_tensors_launch_nothing():
    cands, xs, binv, pmat, alpha = _inputs(2, 3, 3, 8, seed=1)
    before = _all_launches()
    ops.uncertainty_scores_clients(T(cands), T(xs), T(binv), T(pmat), lengthscale=LS, prior=4.0)
    ops.grad_mean_clients(T(cands), T(xs), T(alpha), lengthscale=LS, block_cap=4, block_n=1)
    ops.uncertainty_scores(T(cands[0]), T(xs[0]), T(binv[0]), T(pmat[0]), lengthscale=LS,
                           prior=4.0, block_cap=4, block_n=1)
    ops.grad_mean_batch(T(cands[1]), T(xs[1]), T(alpha[1]), lengthscale=LS)
    x, v, b, ws = (T(a) for a in _rff_inputs(3, 4, 10, seed=1))
    ops.rff_features(x, v, b)
    ops.rff_grad(x, v, b, ws[0])
    ops.rff_grad_rows(x, v, b, ws)
    ops.sqexp(T(xs), T(xs), LS)
    ops.sqexp(T(cands[0]), T(xs[0]), LS)
    assert _all_launches() == before


def test_wrappers_check_arguments():
    cands, xs, binv, pmat, alpha = _inputs(2, 4, 3, 8, seed=2)
    with pytest.raises(TypeError):
        gp_score.uncertainty_scores_resident(T(cands).double(), T(xs), T(binv), T(pmat),
                                             lengthscale=LS, prior=1.0, block_n=4)
    with pytest.raises(ValueError):
        gp_score.uncertainty_scores_resident(T(cands), T(xs), T(binv)[:, :4], T(pmat),
                                             lengthscale=LS, prior=1.0, block_n=4)
    with pytest.raises(ValueError):  # n=4 is not a multiple of block_n=8
        gp_grad.grad_mean_resident(T(cands), T(xs), T(alpha), lengthscale=LS, block_n=8)
    # the tiled gradient takes any cap (cap=8, chunks of at most 3 rows); a
    # non-positive tile is refused
    ragged = gp_grad.grad_mean_tiled(T(cands), T(xs), T(alpha), lengthscale=LS, block_n=4,
                                     block_cap=3)
    _close(ragged, ref.grad_mean_clients(T(cands), T(xs), T(alpha), LS))
    with pytest.raises(ValueError, match="block_cap"):
        gp_grad.grad_mean_tiled(T(cands), T(xs), T(alpha), lengthscale=LS, block_n=4,
                                block_cap=0)
    with pytest.raises(ValueError):
        gp_grad.grad_mean_resident(T(cands), T(xs).transpose(1, 2).contiguous().transpose(1, 2),
                                   T(alpha), lengthscale=LS, block_n=4)
    with pytest.raises(TypeError):  # the single-client wrappers check the same
        gp_score.uncertainty_scores_single_tiled(T(cands[0]), T(xs[0]).double(), T(binv[0]),
                                                 T(pmat[0]), lengthscale=LS, prior=1.0,
                                                 block_n=4, block_cap=4)
    with pytest.raises(ValueError):  # binv is not (cap, cap)
        gp_score.uncertainty_scores_single_resident(T(cands[0]), T(xs[0]), T(binv[0])[:4],
                                                    T(pmat[0]), lengthscale=LS, prior=1.0,
                                                    block_n=4)
    with pytest.raises(ValueError, match="block_cap"):
        gp_grad.grad_mean_single_tiled(T(cands[0]), T(xs[0]), T(alpha[0]), lengthscale=LS,
                                       block_n=4, block_cap=0)
    with pytest.raises(ValueError):  # alpha is not (cap,)
        gp_grad.grad_mean_single_resident(T(cands[0]), T(xs[0]), T(alpha), lengthscale=LS,
                                          block_n=4)
    x, v, b, ws = (T(a) for a in _rff_inputs(3, 4, 10, seed=2))
    with pytest.raises(TypeError):  # the RFF and Gram wrappers take f32 only
        krff_features.rff_features(x.double(), v, b)
    with pytest.raises(ValueError):  # b is not (M,)
        krff_features.rff_features(x, v, b[:5])
    with pytest.raises(TypeError):
        krff_grad.rff_grad_rows(x, v, b, ws.double())
    with pytest.raises(ValueError):  # ws is not (n, M)
        krff_grad.rff_grad_rows(x, v, b, ws[:2])
    with pytest.raises(ValueError):  # w is not (M,)
        krff_grad.rff_grad(x, v, b, ws)
    with pytest.raises(ValueError):  # v does not match x's d
        krff_grad.rff_grad(x, v[:, :3].contiguous(), b, ws[0])
    with pytest.raises(ValueError):
        krff_grad.rff_grad(x.T.contiguous().T, v, b, ws[0])  # not contiguous
    with pytest.raises(TypeError):
        ksqexp.sqexp_clients(T(xs).double(), T(xs).double(), lengthscale=LS)
    with pytest.raises(ValueError):  # different client counts
        ksqexp.sqexp_clients(T(xs), T(xs)[:1], lengthscale=LS)
    with pytest.raises(ValueError):  # ops.sqexp takes two 2-D or two 3-D inputs
        ops.sqexp(T(xs), T(xs[0]), LS)


def test_autotune_is_deterministic_and_fits():
    main = autotune.select_blocks("score", n=50, cap=192, d=300)
    assert main == autotune.select_blocks("score", n=50, cap=192, d=300)
    assert main[1] >= 192  # the main path's scoring runs resident
    assert main == (4, 192)  # one client's scoring: tiles of 4 candidates (B7a's clusters)
    assert autotune.select_blocks("grad", n=1, cap=192, d=300) == (1, 192)
    # the gradient's resident routes end where a block's part no longer fits
    # as one chunk: at d=300 cap 2960 for one client (clusters of 16), 1480
    # client-batched (8); beyond, chunks of at most 32 rows of 256-row tiles
    assert autotune.select_blocks("grad", n=1, cap=2960, d=300) == (1, 2960)
    assert autotune.select_blocks("grad", n=1, cap=2961, d=300) == (1, 256)
    assert autotune.select_blocks("grad_clients", n=1, cap=1480, d=300) == (1, 1480)
    assert autotune.select_blocks("grad_clients", n=1, cap=1481, d=300) == (1, 256)
    assert autotune.grad_geometry(4096, 300, 1, 256) == (16, 32)
    assert autotune.grad_geometry(1024, 1500, 1, 256) == (16, 16)  # halved to fit
    assert autotune.grad_geometry(192, 300, 1, 64) == autotune.grad_geometry(192, 300, 1,
                                                                             single=True)
    big = autotune.select_blocks("score", n=50, cap=8192, d=300)
    assert big[1] < 8192  # the resident h tile no longer fits: tiled
    # the single-client resident route is the cluster kernel's: at d=300 it
    # fits up to cap=1280 (16 blocks of up to 80 rows), then the tiled route
    # takes panels of 256 rows; the client-batched one up to cap=615
    assert autotune.select_blocks("score", n=50, cap=1280, d=300) == (4, 1280)
    assert autotune.select_blocks("score", n=50, cap=1281, d=300) == (4, 256)
    assert autotune.select_blocks("score_clients", n=50, cap=615, d=300) == (8, 615)
    assert autotune.select_blocks("score_clients", n=50, cap=616, d=300) == (8, 256)
    for kind, (bn, bc), cap in (("score", main, 192), ("score", big, 8192),
                                ("score", (4, 256), 4096), ("score_clients", (8, 64), 192)):
        assert autotune.smem_bytes(kind, block_n=bn, block_cap=bc, cap=cap, d=300) \
            <= autotune.SMEM_BYTES
    # the tiled scoring: the larger of the h pass's candidates (f64) and the
    # panel pass at its largest group, whatever n
    assert autotune.smem_bytes("score", block_n=8, block_cap=64, cap=192, d=300) == \
        max(8 * 8 * 300 + 64, autotune.panel_smem(16, 64))
    assert autotune.panel_smem(16, 256) == 4 * 32 * (256 + 1024) <= autotune.SMEM_BYTES


def test_validate_blocks_rejects_what_the_kernels_cannot_take():
    assert autotune.validate_blocks("grad", block_n=1, block_cap=64, cap=192, d=300) == (1, 64)
    # the gradient: any positive tile at any cap (ragged included); the
    # resident route past its shared memory is refused
    assert autotune.validate_blocks("grad_clients", block_n=1, block_cap=7, cap=4096,
                                    d=1500) == (1, 7)
    with pytest.raises(ValueError, match="shared memory"):
        autotune.validate_blocks("grad", block_n=1, block_cap=2961, cap=2961, d=300)
    with pytest.raises(ValueError, match="positive"):
        autotune.validate_blocks("grad", block_n=1, block_cap=0, cap=192, d=300)
    with pytest.raises(ValueError, match="block_n"):
        autotune.validate_blocks("score", block_n=3, block_cap=64, cap=192, d=300)
    with pytest.raises(ValueError, match="shared memory"):
        autotune.validate_blocks("score", block_n=16, block_cap=4096, cap=4096, d=300)
    with pytest.raises(ValueError):  # pinned through ops
        ops.grad_mean_clients(torch.zeros(1, 1, 4), torch.zeros(1, 8, 4), torch.zeros(1, 8),
                              lengthscale=1.0, block_n=5)
    # the new score budget: the cluster kernel past its cap, the tiled h pass
    # past its candidates' f64 width; any positive panel height is taken
    with pytest.raises(ValueError, match="shared memory"):
        autotune.validate_blocks("score", block_n=4, block_cap=1281, cap=1281, d=300)
    with pytest.raises(ValueError, match="shared memory"):
        autotune.validate_blocks("score_clients", block_n=16, block_cap=64, cap=192, d=2000)
    assert autotune.validate_blocks("score", block_n=4, block_cap=1280, cap=1280, d=300) == \
        (4, 1280)
    assert autotune.validate_blocks("score_clients", block_n=8, block_cap=3, cap=192,
                                    d=1500) == (8, 3)
    with pytest.raises(ValueError, match="positive"):
        autotune.validate_blocks("score", block_n=4, block_cap=0, cap=192, d=300)


# (n, cap, d): the main path's scoring and gradient shapes, ragged ones, a
# trajectory shorter than a cluster, and caps past one cluster's 8 x 32 rows.
GEOMETRY = [(50, 192, 300), (1, 192, 300), (7, 33, 20), (3, 5, 3), (16, 300, 300),
            (12, 16, 8)]


@pytest.mark.parametrize("n,cap,d", GEOMETRY)
def test_cluster_geometry_covers_every_row_and_column_once(n, cap, d):
    """The launch geometry of the client-batched cluster kernels (B1, B3),
    as the wrappers compute it: the blocks of a cluster own every
    trajectory row (and, for B3's final sums, every column of d) exactly
    once; the chunks of B and P cover every row once; the candidate tiles
    cover the padded candidates once; the scoring kernel's threads cover
    a block's columns; shared memory fits the budget."""
    cs, jc = autotune.cluster_geometry(cap)
    assert 1 <= cs <= autotune.CLUSTER and 1 <= jc <= cap
    for total in (cap, d):
        b = autotune.split(total, cs)
        owned = [t for r in range(cs) for t in range(b[r], b[r + 1])]
        assert owned == list(range(total))
    rows = np.diff(autotune.split(cap, cs))
    rmax = -(-cap // cs)
    assert rows.min() >= 1 and rows.max() == rmax
    assert rmax <= 32 or cs == autotune.CLUSTER  # one warp's lanes per block when cap allows
    chunks = [t for j0 in range(0, cap, jc) for t in range(j0, min(j0 + jc, cap))]
    assert chunks == list(range(cap))
    for kind in ("score_clients", "grad_clients"):
        bn, bc = autotune.select_blocks(kind, n=n, cap=cap, d=d)
        npad = -(-n // bn) * bn
        tiles = [(x // cs) * bn + i for x in range(cs * npad // bn) for i in range(bn)
                 if x % cs == 0]
        assert tiles == list(range(npad))
        if bc >= cap:  # the cluster kernel: its columns fit the block's threads
            kw = 32
            while kw < rmax:
                kw *= 2
            assert autotune.THREADS % kw == 0
            assert autotune.smem_bytes(kind, block_n=bn, block_cap=bc, cap=cap, d=d) \
                <= autotune.SMEM_BYTES
    if (cap, d) == (192, 300):  # the main path runs the cluster kernels, 6 blocks each
        assert autotune.cluster_geometry(cap) == (6, 32)
        assert autotune.select_blocks("score_clients", n=50, cap=cap, d=d) == (8, 192)
        assert autotune.select_blocks("grad_clients", n=1, cap=cap, d=d) == (1, 192)


@pytest.mark.parametrize("n,cap,d", GEOMETRY)
def test_single_client_cluster_geometry_spreads_one_client(n, cap, d):
    """B7a's launch (``autotune.cluster_geometry(cap, single=True)``, the
    tuner's candidate tile): up to 16 blocks per cluster, every trajectory
    row owned by exactly one block, at most 256 rows a block; at the
    per-client engine's shapes one client spreads over 208 blocks."""
    cs, jc = autotune.cluster_geometry(cap, single=True)
    assert 1 <= cs <= autotune.SINGLE_CLUSTER and 1 <= jc <= cap
    b = autotune.split(cap, cs)
    assert [t for r in range(cs) for t in range(b[r], b[r + 1])] == list(range(cap))
    assert min(np.diff(b)) >= 1 and -(-cap // cs) <= autotune.THREADS
    bn, bc = autotune.select_blocks("score", n=n, cap=cap, d=d)
    if bc >= cap:
        assert autotune.smem_bytes("score", block_n=bn, block_cap=bc, cap=cap, d=d) \
            <= autotune.SMEM_BYTES
    if (n, cap, d) == (50, 192, 300):
        assert (cs, bn, bc) == (16, 4, 192)
        assert cs * -(-n // bn) == 208


# (kind, n, cap, d, block_cap): the main path's and the per-client
# engine's routes (resident, pinned tile 64), the tuned tiled route at cap
# 1000 and 4096, d=1500, ragged caps and tiles, the small engines' width.
GRAD_LAYOUTS = [("grad_clients", 1, 192, 300, None), ("grad", 1, 192, 300, None),
                ("grad", 1, 192, 300, 64), ("grad_clients", 1, 192, 300, 64),
                ("grad", 1, 1000, 300, 256), ("grad", 1, 4096, 300, 256),
                ("grad_clients", 1, 1000, 300, 256), ("grad", 1, 1024, 1500, 256),
                ("grad_clients", 7, 45, 1029, 8), ("grad", 1, 16, 8, 8),
                ("grad", 1, 2960, 300, None), ("grad_clients", 3, 300, 20, 7)]


@pytest.mark.parametrize("kind,n,cap,d,block_cap", GRAD_LAYOUTS)
def test_grad_layout_covers_every_row_and_column_once(kind, n, cap, d, block_cap):
    """The gradient kernel's chunked split (``autotune.grad_layout``, as
    csrc/gp_grad.cu computes it): over a cluster every trajectory row is
    summed exactly once, each block's in ascending order, in chunks of at
    most block_cap (and GRAD_CHUNK) rows on the tiled route and in one chunk
    on the resident route; every output column is written by exactly one
    block; the tiled route's clusters are the single-client ones whatever
    the kind; shared memory fits the budget."""
    bn, _ = autotune.select_blocks(kind, n=n, cap=cap, d=d)
    single = kind == "grad"
    blocks = autotune.grad_layout(cap, d, bn, block_cap, single)
    cs, jc = autotune.grad_geometry(cap, d, bn, block_cap, single)
    assert len(blocks) == cs <= min(cap, autotune.SINGLE_CLUSTER)
    rows = [t for blk in blocks for ch in blk["chunks"] for t in ch]
    assert rows == list(range(cap))
    assert [c for blk in blocks for c in blk["columns"]] == list(range(d))
    chunks = [len(ch) for blk in blocks for ch in blk["chunks"]]
    assert min(chunks) >= 1 and max(chunks) <= jc
    if block_cap is None:
        assert all(len(blk["chunks"]) == 1 for blk in blocks)
        assert cs == autotune.cluster_geometry(cap, single)[0]
    else:
        assert jc <= min(block_cap, autotune.GRAD_CHUNK)
        assert cs == autotune.cluster_geometry(cap, single=True)[0]
    bc = cap if block_cap is None else block_cap
    assert autotune.smem_bytes(kind, block_n=bn, block_cap=bc, cap=cap, d=d) <= \
        autotune.SMEM_BYTES


@pytest.mark.parametrize("d", [300, 1500])
def test_grad_routes_fit_shared_memory(d):
    """For both gradient kinds at caps 192 to 4096 (one query point per
    client, as the engines take it) the tuner's blocks fit a block's shared
    memory, and so does every cap tile the tuner tries (the chunks halve
    until two buffers fit)."""
    for kind in ("grad", "grad_clients"):
        for cap in (192, 256, 545, 1000, 1024, 1481, 2048, 2961, 4096):
            bn, bc = autotune.select_blocks(kind, n=1, cap=cap, d=d)
            assert autotune.smem_bytes(kind, block_n=bn, block_cap=bc, cap=cap, d=d) <= \
                autotune.SMEM_BYTES
            for tile in autotune.BLOCK_CAP:
                if tile < cap:
                    assert autotune.smem_bytes(kind, block_n=bn, block_cap=tile, cap=cap,
                                               d=d) <= autotune.SMEM_BYTES


@pytest.mark.parametrize("single", [False, True], ids=["clients", "single"])
def test_tiled_grad_takes_the_ragged_cap_unpadded(monkeypatch, single):
    """``kernels.ops`` hands the tiled gradient the trajectory as it is (cap
    20 with tiles of 12: no zero-padding to a tile multiple), and the plain
    version it runs on the CPU masks the ragged last tile."""
    cands, xs, _, _, alpha = _inputs(3, 6, 3, 20, seed=4)
    seen = []
    name = "grad_mean_single_tiled" if single else "grad_mean_tiled"
    real = getattr(gp_grad, name)

    def spy(c, x, a, **kw):
        seen.append((tuple(x.shape), tuple(a.shape)))
        return real(c, x, a, **kw)

    monkeypatch.setattr(gp_grad, name, spy)
    if single:
        got = ops.grad_mean_batch(T(cands[1]), T(xs[1]), T(alpha[1]), lengthscale=LS,
                                  block_cap=12)
        want = rref.grad_mean_batch(cands[1], xs[1], alpha[1], LS)
        assert seen == [((20, 3), (20,))]
    else:
        got = ops.grad_mean_clients(T(cands), T(xs), T(alpha), lengthscale=LS, block_cap=12)
        want = rref.grad_mean_clients(cands, xs, alpha, LS)
        assert seen == [((3, 20, 3), (3, 20))]
    _close(got, want)


# (n, cap, block_n, block_cap): the per-client engine's pinned tile, the
# tuned tiled route at cap 1000 and 4096 (panels of 256 rows), ragged caps
# and panels, more candidates than one group of 128, and the small engine's.
TILED_LAYOUTS = [(52, 192, 4, 64), (52, 1000, 4, 256), (52, 4096, 4, 256), (12, 45, 4, 8),
                 (8, 192, 8, 64), (200, 100, 8, 33), (12, 16, 4, 8), (1, 5, 1, 2)]


@pytest.mark.parametrize("n,cap,block_n,block_cap", TILED_LAYOUTS)
def test_score_tiled_layout_covers_every_cell_once(n, cap, block_n, block_cap):
    """The cap-tiled scoring's passes (``autotune.score_tiled_layout``, as
    csrc/gp_score.cu launches them): the h pass computes every (trajectory
    row, candidate) exactly once; for every candidate the panel pass sums
    every (row, column) cell of B and P exactly once, in panels whose cells
    are numbered in the order the sums add them; the work buffer holds h,
    m and every candidate's partial of every cell; shared memory fits."""
    lay = autotune.score_tiled_layout(n, cap, block_n, block_cap)
    h = np.zeros((cap, n), dtype=np.int32)
    for rows, cands in lay["h"]:
        h[rows.start:rows.stop, cands.start:cands.stop] += 1
    assert (h == 1).all()
    group = 8 * lay["cpw"]
    assert lay["cpw"] in (1, 2, 4, 8, 16) and (group >= n or lay["cpw"] == 16)
    groups = {}  # each candidate group: how often it sums each cell of B and P
    cells = []
    for rows, cols, cands in lay["panels"]:
        assert len(cols) <= autotune.PANEL_COLS and len(rows) <= block_cap and len(cands) <= group
        if cands.start == 0:
            cells.append((rows.start, cols.start))
        cover = groups.setdefault((cands.start, cands.stop), np.zeros((cap, cap), dtype=np.int32))
        cover[rows.start:rows.stop, cols.start:cols.stop] += 1
    assert sorted(i for g in groups for i in range(*g)) == list(range(n))
    assert all((cover == 1).all() for cover in groups.values())
    assert len(cells) == lay["cells"]
    assert cells == sorted(cells)  # row panels outer, column blocks inner
    assert autotune.score_tiled_work(3, n, cap, block_cap) == 3 * n * (2 * cap + lay["cells"])
    assert autotune.panel_smem(lay["cpw"], block_cap) <= autotune.SMEM_BYTES


# (M, d): the main path's B5 shape, the launcher's M=1000, M past the
# earlier kernel's 1024-column chunk of S, fewer features than groups, a
# bank whose rows need several chunks, and d not a multiple of 4.
RFF_LAYOUTS = [(512, 300), (1000, 300), (1100, 257), (32, 3), (5, 8), (4096, 300), (100, 5000)]


@pytest.mark.parametrize("m,d", RFF_LAYOUTS)
def test_rff_grad_layout_covers_every_feature_and_column_once(m, d):
    """The RFF gradient kernel's layout (``autotune.rff_grad_layout``, as
    csrc/rff_grad.cu computes it): over a row's cluster every feature is
    projected and summed exactly once, by the block owning its group
    (m mod 32), each group's features in ascending order across the chunks;
    every output column is received and added up by exactly one block, the
    one whose slice of d holds it; the blocks own the 32 groups in order;
    shared memory fits."""
    blocks = autotune.rff_grad_layout(m, d)
    assert len(blocks) == autotune.RFF_GRAD_CLUSTER
    assert [g for blk in blocks for g in blk["groups"]] == list(range(autotune.RFF_GRAD_GROUPS))
    seen = []
    for blk in blocks:
        for gl, g in enumerate(blk["groups"]):
            feats = [f for chunk in blk["chunks"] for f in chunk[gl]]
            assert feats == list(range(g, m, autotune.RFF_GRAD_GROUPS))  # ascending, all of g
            seen += feats
    assert sorted(seen) == list(range(m))
    assert [c for blk in blocks for c in blk["columns"]] == list(range(d))
    assert all(blk["columns"] == list(blk["slice"]) for blk in blocks)
    smax = -(-d // autotune.RFF_GRAD_CLUSTER)  # the receive buffer's columns per group
    assert all(len(blk["columns"]) <= smax for blk in blocks)
    slots = autotune.rff_grad_slots(m, d)
    ns = -(-m // autotune.RFF_GRAD_GROUPS)
    assert slots >= 1
    assert autotune.rff_grad_smem(d, slots, slots < ns) <= autotune.SMEM_BYTES
    assert len(blocks[0]["chunks"]) == -(-ns // slots)
    if (m, d) == (512, 300):  # the main path: one chunk, every copy issued at once
        assert slots == ns == 16
    if (m, d) == (4096, 300):
        assert 1 < len(blocks[0]["chunks"])


def test_rff_grad_refuses_what_shared_memory_cannot_hold():
    """x, one feature row per group and the groups' pairs must fit a block:
    d above about 5,000 has no slot where M needs chunks, above about 8,000
    where one chunk holds M (the kernel returns an error)."""
    assert autotune.rff_grad_slots(512, 5000) == 1
    assert autotune.rff_grad_slots(512, 5400) == 0
    assert autotune.rff_grad_slots(32, 8000) == 1
    assert autotune.rff_grad_slots(32, 8400) == 0


@pytest.mark.parametrize("rows,d,cols,batch,route", [
    (5, 300, 192, 5, ("rows", 5)), (1, 300, 192, 5, ("rows", 1)), (8, 20, 33, 3, ("rows", 8)),
    (9, 20, 33, 3, ("rows", 16)), (16, 2400, 192, 5, ("rows", 16)),
    (16, 2500, 192, 5, ("tile", 32)), (17, 3, 17, 1, ("tile", 32)),
    (192, 300, 192, 5, ("tile", 32)), (960, 300, 512, 1, ("tile", 64)),
    (4096, 300, 512, 1, ("tile", 64)), (1000, 300, 1000, 1, ("tile", 64)),
    (45, 1029, 45, 2, ("tile", 32)), (48, 8, 32, 1, ("tile", 32)),
    (17, 3, 4224, 1, ("tile", 64)), (17, 3, 4160, 1, ("tile", 32))])
def test_sqexp_rows_route(rows, d, cols, batch, route):
    """The route of csrc/proj.cuh ``launch_proj`` (``autotune.rows_route``):
    an append event's 1 or 5 rows take the rows kernel with BN equal to the
    row count, so no chain is summed for a missing row, up to 16 rows while
    they and a column tile fit shared memory; more rows take the tile
    kernel, with 64 x 64 tiles where that makes at least 66 blocks (half
    the card's SMs: B6's 960 x 512, 120 blocks), else 32 x 32 (factor_init's
    (5, 192, 192) Gram, 45 tiles of 64, 180 of 32)."""
    assert autotune.rows_route(rows, d, cols, batch) == route


# (batch, rows, cols, d): B6 on the main path, the init Gram, and ragged
# rows, cols and d on each tile (d past one chunk, below one k-step of 4,
# at the widest d the smoke's accuracy check takes).
PROJ_LAYOUTS = [(1, 960, 512, 300), (5, 192, 192, 300), (1, 961, 500, 301), (2, 45, 45, 1029),
                (1, 48, 32, 8), (3, 17, 33, 3), (1, 130, 70, 1500)]


@pytest.mark.parametrize("batch,rows,cols,d", PROJ_LAYOUTS)
@pytest.mark.parametrize("tile", [32, 64])
def test_proj_tile_layout_covers_every_output_once(batch, rows, cols, d, tile):
    """The tile kernel's blocks (``autotune.proj_tile_layout``, by the
    kernel's own index arithmetic) store every output of every problem
    exactly once, at either tile; its warps convert every staged row once
    (rows of a, then of bm); its d chunks cover d once, in order, each
    with the k-steps of 4 that cover it and no more."""
    blocks = autotune.proj_tile_layout(batch, rows, cols, d, tile)
    outs = [o for b in blocks for o in b["outputs"]]
    assert len(outs) == batch * rows * cols
    assert set(outs) == {(z, i, j) for z in range(batch) for i in range(rows)
                         for j in range(cols)}
    for b in blocks:
        staged = sorted(r for rs in b["convert"].values() for r in rs)
        assert staged == list(range(2 * tile))
        ks = [k for k0, k1, _ in b["chunks"] for k in range(k0, k1)]
        assert ks == list(range(d))
        assert all(4 * n - 4 < k1 - k0 <= 4 * n for k0, k1, n in b["chunks"])
        assert all(k1 - k0 <= autotune.PROJ_TILE_K for k0, k1, _ in b["chunks"])
    assert len(blocks) == batch * -(-rows // tile) * -(-cols // tile)


@pytest.mark.parametrize("d", [8, 300, 1029, 1500])
def test_proj_tile_fits_shared_memory(d):
    """The tile kernel's shared memory (two f32 stages, two f64 tiles and
    the norms) does not grow with d, and fits a block's 227 KB at either
    tile; the 64 x 64 tile still lets two blocks share an SM.  Its blocks
    are T / 8 warps."""
    for rows, cols, batch in ((960, 512, 1), (5 * 192, 192, 1), (192, 192, 5)):
        tile = autotune.rows_route(rows, d, cols, batch)[1]
        assert autotune.proj_smem(tile) <= autotune.SMEM_BYTES
    assert 2 * autotune.proj_smem(64) <= autotune.SMEM_BYTES
    assert autotune.proj_smem(64) == 107520 and autotune.proj_smem(32) == 53760
    assert autotune.proj_threads(64) == 256 and autotune.proj_threads(32) == 128


def _two_sum32(a, b):
    s = (a + b).astype(np.float32)
    z = (s - a).astype(np.float32)
    return s, ((a - (s - z)) + (b - z)).astype(np.float32)


def _rff_features_tile_model(x, v, b):
    """The tile kernel's arithmetic for B6 on the CPU: the projection summed
    in float64 (every f32 product exact), split into the pair hi = rn(acc),
    lo = rn(acc - hi), the phase added by TwoSum (``add_f``) and
    ``CosEpilogue``'s scale * (cos(hi) - sin(hi) lo) in f32."""
    acc = x.astype(np.float64) @ v.astype(np.float64).T
    hi = acc.astype(np.float32)
    lo = (acc - hi).astype(np.float32)
    s, e = _two_sum32(hi, b.astype(np.float32)[None, :])
    hi, lo = _two_sum32(s, (lo + e).astype(np.float32))
    c = np.cos(hi).astype(np.float64) - np.sin(hi).astype(np.float64) * lo  # fmaf, one rounding
    scale = np.float32(np.sqrt(2.0 / v.shape[0]))
    return (scale * c.astype(np.float32)).astype(np.float32)


@pytest.mark.parametrize("seed", [0, 1])
def test_rff_features_tile_arithmetic_against_float64(seed):
    """A float64 model of the tile kernel's B6 arithmetic at the main path's
    960 x 512 x 300 is within 2 f32 ulps of the output scale sqrt(2/M) of
    float64, and at least as close as the plain f32 version (whose f32
    rounding of projections of tens is a few 1e-7 of phase)."""
    x, v, b, _ = _rff_inputs(960, 300, 512, seed=seed)
    truth = np.sqrt(2.0 / 512) * np.cos(x.astype(np.float64) @ v.astype(np.float64).T + b)
    got = _rff_features_tile_model(x, v, b)
    err = np.abs(got - truth).max()
    assert err <= 2 * np.spacing(np.float32(np.sqrt(2.0 / 512)))
    plain = ref.rff_features(T(x), T(v), T(b)).numpy()
    assert err <= np.abs(plain - truth).max()


def test_loader_builds_every_source_and_binds_every_entry():
    """Every ``csrc`` source and header is in the build (and so in its
    digest), and every bound entry is an ``extern "C"`` function of one."""
    from repro_torch.kernels import loader

    assert sorted(p.name for p in loader.CSRC.glob("*.cu")) == sorted(loader.SOURCES)
    assert sorted(p.name for p in loader.CSRC.glob("*.cuh")) == sorted(loader.HEADERS)
    text = "".join((loader.CSRC / name).read_text() for name in loader.SOURCES)
    for entry in (*loader.SIGNATURES, "fz_error_string"):
        assert f" {entry}(" in text, entry
    assert {"fz_rff_features", "fz_rff_grad", "fz_sqexp"} <= set(loader.SIGNATURES)


def _cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels run only on the card")
    return torch.device("cuda")


@pytest.mark.parametrize("block_cap", [None, 8], ids=["resident", "tiled"])
def test_cuda_kernels_match_plain_versions(block_cap):
    dev = _cuda()
    cands, xs, binv, pmat, alpha = _inputs(3, 10, 6, 24, seed=3)
    c = lambda a: T(a).to(dev)
    bn = None if block_cap is None else 4
    got = ops.uncertainty_scores_clients(c(cands), c(xs), c(binv), c(pmat), lengthscale=LS,
                                         prior=6 / LS**2, block_n=bn, block_cap=block_cap)
    _close(got.cpu(), ref.uncertainty_scores_clients_fused(
        T(cands), T(xs), T(binv), T(pmat), LS, 6 / LS**2))
    g = ops.grad_mean_clients(c(cands), c(xs), c(alpha), lengthscale=LS, block_n=bn,
                              block_cap=block_cap)
    _close(g.cpu(), ref.grad_mean_clients(T(cands), T(xs), T(alpha), LS))
    # the single-client kernels (B7, B8) on client 1's inputs
    before = dict(gp_score.LAUNCHES), dict(gp_grad.LAUNCHES)
    s1 = ops.uncertainty_scores(c(cands[1]), c(xs[1]), c(binv[1]), c(pmat[1]), lengthscale=LS,
                                prior=6 / LS**2, block_n=bn, block_cap=block_cap)
    _close(s1.cpu(), ref.uncertainty_scores(T(cands[1]), T(xs[1]), T(binv[1]), T(pmat[1]), LS,
                                            6 / LS**2))
    g1 = ops.grad_mean_batch(c(cands[1]), c(xs[1]), c(alpha[1]), lengthscale=LS, block_n=bn,
                             block_cap=block_cap)
    _close(g1.cpu(), ref.grad_mean_batch(T(cands[1]), T(xs[1]), T(alpha[1]), LS))
    route = "resident" if block_cap is None else "tiled"
    assert gp_score.LAUNCHES[f"score_single_{route}"] == before[0][f"score_single_{route}"] + 1
    assert gp_grad.LAUNCHES[f"grad_single_{route}"] == before[1][f"grad_single_{route}"] + 1
    for n, d, m in RFF_SHAPES:  # B5, B6 and B9
        _check_cuda_rff_and_gram(dev, n, d, m)
    if block_cap is None:
        _check_cuda_cluster_kernels(dev)


def _check_cuda_cluster_kernels(dev):
    """B1 and B3 (the cluster kernels) at the main path's shapes (N=5,
    n=50, cap=192, d=300; one query point per client for B3) and at a
    ragged one past 32 rows per block (cap=300, d=20, n=7) against their
    plain versions on the CPU, one launch each, and bitwise the same on a
    second launch (fixed-order sums, no float atomics)."""
    for nb, n, d, cap in ((5, 50, 300, 192), (2, 7, 20, 300)):
        cands, xs, binv, pmat, alpha = _inputs(nb, n, d, cap, seed=9)
        c = lambda a: T(a).to(dev)
        before = _all_launches()
        kw = dict(lengthscale=LS, prior=d / LS**2)
        s = ops.uncertainty_scores_clients(c(cands), c(xs), c(binv), c(pmat), **kw)
        _close(s.cpu(), ref.uncertainty_scores_clients_fused(T(cands), T(xs), T(binv),
                                                             T(pmat), LS, d / LS**2))
        assert torch.equal(s, ops.uncertainty_scores_clients(c(cands), c(xs), c(binv),
                                                             c(pmat), **kw))
        q = cands[:, :1]
        g = ops.grad_mean_clients(c(q), c(xs), c(alpha), lengthscale=LS)
        _close(g.cpu(), ref.grad_mean_clients(T(q), T(xs), T(alpha), LS))
        assert torch.equal(g, ops.grad_mean_clients(c(q), c(xs), c(alpha), lengthscale=LS))
        after = _all_launches()
        assert after["score_resident"] == before["score_resident"] + 2
        assert after["grad_resident"] == before["grad_resident"] + 2


def _check_cuda_rff_and_gram(dev, n, d, m):
    """B5, B6 and B9 on the card against their plain versions on the CPU,
    with exact launch counts, and B5 bitwise the same on a second launch
    (no float atomics)."""
    x, v, b, ws = _rff_inputs(n, d, m, seed=5)
    c = lambda a: T(a).to(dev)
    before = _all_launches()
    _close(ops.rff_features(c(x), c(v), c(b)).cpu(), ref.rff_features(T(x), T(v), T(b)),
           RFF_ATOL)
    g = ops.rff_grad_rows(c(x), c(v), c(b), c(ws))
    _close(g.cpu(), ref.rff_grad_rows(T(x), T(v), T(b), T(ws)), RFF_ATOL)
    assert torch.equal(g, ops.rff_grad_rows(c(x), c(v), c(b), c(ws)))
    _close(ops.rff_grad(c(x), c(v), c(b), c(ws[0])).cpu(),
           ref.rff_grad(T(x), T(v), T(b), T(ws[0])), RFF_ATOL)
    x1, x2 = _gram_inputs(3, n, m, d, seed=6)
    k = ops.sqexp(c(x1), c(x2), RFF_LS).cpu()
    for i in range(3):
        _close_gram(k[i], (ref.sqexp(T(x1[i]), T(x2[i]), RFF_LS),), _gram_truth(x1[i], x2[i]))
    _close_gram(ops.sqexp(c(x1[0]), c(x2[0]), RFF_LS).cpu(),
                (ref.sqexp(T(x1[0]), T(x2[0]), RFF_LS),), _gram_truth(x1[0], x2[0]))
    after = _all_launches()
    assert after["rff_features"] == before["rff_features"] + 1
    assert after["rff_grad"] == before["rff_grad"] + 3
    assert after["sqexp"] == before["sqexp"] + 2


# Ragged shapes of the RFF gradient's kernel on the card: n rows (clusters),
# M features (M=4096 at d=300 needs several chunks), by d.
CUDA_RFF_N, CUDA_RFF_M = (1, 5, 16, 17), (32, 512, 1000, 1100)


@pytest.mark.parametrize("d", [3, 8, 257, 300])
def test_cuda_rff_grad_matches_plain_and_repeats(d):
    """B5 on the card, per-row w and one w, against its plain version on the
    CPU (RFF_ATOL), and bitwise the same on a second launch (fixed-order
    sums, no float atomics), over n in CUDA_RFF_N and M in CUDA_RFF_M; a d
    that shared memory cannot hold raises."""
    dev = _cuda()
    c = lambda a: T(a).to(dev)
    for n in CUDA_RFF_N:
        for m in CUDA_RFF_M + ((4096,) if d == 300 else ()):
            x, v, b, ws = _rff_inputs(n, d, m, seed=n + m + d)
            got = ops.rff_grad_rows(c(x), c(v), c(b), c(ws))
            _close(got.cpu(), ref.rff_grad_rows(T(x), T(v), T(b), T(ws)), RFF_ATOL)
            assert torch.equal(got, ops.rff_grad_rows(c(x), c(v), c(b), c(ws)))
            one = ops.rff_grad(c(x), c(v), c(b), c(ws[0]))
            _close(one.cpu(), ref.rff_grad(T(x), T(v), T(b), T(ws[0])), RFF_ATOL)
            assert torch.equal(one, ops.rff_grad(c(x), c(v), c(b), c(ws[0])))
    if d == 300:  # no slot fits shared memory (autotune.rff_grad_slots): the launch raises
        x, v, b, ws = _rff_inputs(2, 5400, 512, seed=1)
        with pytest.raises(RuntimeError, match="rff_grad launch failed"):
            ops.rff_grad_rows(c(x), c(v), c(b), c(ws))


@pytest.mark.parametrize("d", [3, 8, 257, 300])
def test_cuda_sqexp_rows_matches_plain_and_repeats(d):
    """B9's rows route on the card (a new rows against the (N, cap, d) ring)
    against float64 within the plain version's error (``_close_gram``) and
    bitwise the same on a second launch, over a in (1, 5, 16) and cap in
    (1, 16, 192, 193)."""
    dev = _cuda()
    c = lambda a: T(a).to(dev)
    for a in (1, 5, 16):
        for cap in (1, 16, 192, 193):
            x1, x2 = _gram_inputs(3, a, cap, d, seed=a + cap + d)
            k = ops.sqexp(c(x1), c(x2), RFF_LS)
            assert torch.equal(k, ops.sqexp(c(x1), c(x2), RFF_LS))
            for i in range(3):
                _close_gram(k[i].cpu(), (ref.sqexp(T(x1[i]), T(x2[i]), RFF_LS),),
                            _gram_truth(x1[i], x2[i]))


# (rows, M, d): B6 on the card at the main path's 960 rows, at 4096, ragged
# in all three, at the small engines' width, and at 17 rows (the fewest the
# tile kernel takes).
CUDA_RFF_FEATURES = [(960, 512, 300), (4096, 512, 300), (961, 500, 301), (48, 32, 8), (17, 3, 5)]


@pytest.mark.parametrize("n,m,d", CUDA_RFF_FEATURES)
def test_cuda_rff_features_matches_plain_and_repeats(n, m, d):
    """B6 on the card (the projection's tile kernel) against float64 (its
    plain version on float64 copies of the inputs): no further off than the
    plain version in f32, within the RFF tolerance of it, bitwise the same
    on a second launch (fixed-order f64 sums), one launch a call."""
    dev = _cuda()
    x, v, b, _ = _rff_inputs(n, d, m, seed=n + m + d)
    c = lambda a: T(a).to(dev)
    before = _all_launches()["rff_features"]
    got = ops.rff_features(c(x), c(v), c(b))
    assert torch.equal(got, ops.rff_features(c(x), c(v), c(b)))
    assert _all_launches()["rff_features"] == before + 2
    truth = ref.rff_features(T(x).double(), T(v).double(), T(b).double())
    plain = ref.rff_features(T(x), T(v), T(b))
    assert torch.isfinite(got).all() and got.shape == (n, m)
    assert (got.cpu().double() - truth).abs().max() <= (plain.double() - truth).abs().max()
    _close(got.cpu(), plain, RFF_ATOL)


# (N, a, c, d): the SE Gram's tile route on the card at factor_init's
# (5, 192, 192), one client at 1000, ragged at d=1029 and at small d, and
# more rows than columns.
CUDA_SQEXP_TILES = [(5, 192, 192, 300), (1, 1000, 1000, 300), (2, 45, 45, 1029), (3, 17, 33, 3),
                    (2, 70, 20, 8)]


@pytest.mark.parametrize("nb,a,c,d", CUDA_SQEXP_TILES)
def test_cuda_sqexp_tile_matches_plain_and_repeats(nb, a, c, d):
    """B9's tile route on the card (a > 16 rows) against float64 within the
    plain version's error (``_close_gram``) and no further off than it,
    bitwise the same on a second launch, one launch a call."""
    dev = _cuda()
    x1, x2 = _gram_inputs(nb, a, c, d, seed=a + c + d)
    before = _all_launches()["sqexp"]
    k = ops.sqexp(T(x1).to(dev), T(x2).to(dev), RFF_LS)
    assert torch.equal(k, ops.sqexp(T(x1).to(dev), T(x2).to(dev), RFF_LS))
    assert _all_launches()["sqexp"] == before + 2
    plain = ref.sqexp(T(x1), T(x2), RFF_LS).double()
    for i in range(nb):
        truth = _gram_truth(x1[i], x2[i])
        _close_gram(k[i].cpu(), (plain[i].numpy(),), truth)
        assert np.abs(k[i].cpu().double().numpy() - truth).max() <= np.abs(
            plain[i].numpy() - truth).max()


# (N, n, cap, d, cap tile): the sizes of the smoke's tiled-accuracy check
# (chip_smoke.TILED_ACCURACY): one client and five at cap 1000, one at 4096,
# d=1500, ragged caps and candidate counts, the pinned tile and the small
# engines' width; and the single-client resident route's largest cap at
# d=300 (1280: clusters of 16 blocks of 80 rows).
CUDA_SCORES = [(1, 50, 1000, 300, 256), (1, 50, 4096, 300, 256), (5, 50, 1000, 300, 256),
               (1, 50, 1024, 1500, 256), (2, 9, 45, 1029, 8), (5, 7, 192, 300, 64),
               (1, 12, 16, 8, 8), (1, 7, 1280, 300, 256)]


@pytest.mark.parametrize("nb,n,cap,d,tile", CUDA_SCORES)
def test_cuda_scores_match_plain_and_repeat(nb, n, cap, d, tile):
    """The scoring kernels of the per-client engine on the card.  The
    cap-tiled route (B2 client-batched, B7b one client) against float64 (the
    tiled plain version on float64 copies of the inputs): its max error is
    no more than the f32 plain version's; the single-client entry on client
    0 gives row 0 of the client-batched entry bit for bit; a second launch
    gives the same bits.  The single-client resident route (B7a, the
    cluster kernel), where the tuner takes it at this shape, against its
    plain version (ATOL) and bitwise the same on a second launch."""
    dev = _cuda()
    cands, xs, binv, pmat, _ = _inputs(nb, n, d, cap, seed=cap + n + d)
    c = lambda a: T(a).to(dev)
    prior = d / LS**2
    kw = dict(lengthscale=LS, prior=prior)
    before = _all_launches()
    args = (c(cands), c(xs), c(binv), c(pmat))
    got = ops.uncertainty_scores_clients(*args, **kw, block_cap=tile)
    assert torch.equal(got, ops.uncertainty_scores_clients(*args, **kw, block_cap=tile))
    one = ops.uncertainty_scores(*(a[0] for a in args), **kw, block_cap=tile)
    assert torch.equal(one, got[0])
    assert torch.equal(one, ops.uncertainty_scores(*(a[0] for a in args), **kw, block_cap=tile))
    f64 = lambda a: T(a).double()
    truth = gp_score.scores_tiled_plain(f64(cands), f64(xs), f64(binv), f64(pmat), LS, prior,
                                        tile)
    plain = gp_score.scores_tiled_plain(T(cands), T(xs), T(binv), T(pmat), LS, prior, tile)
    assert torch.isfinite(got).all() and got.shape == (nb, n)
    assert (got.cpu().double() - truth).abs().max() <= (plain.double() - truth).abs().max()
    after = _all_launches()
    assert after["score_tiled"] == before["score_tiled"] + 2
    assert after["score_single_tiled"] == before["score_single_tiled"] + 2
    if autotune.select_blocks("score", n=n, cap=cap, d=d)[1] >= cap:
        s1 = ops.uncertainty_scores(*(a[0] for a in args), **kw)
        _close(s1.cpu(), ref.uncertainty_scores(T(cands[0]), T(xs[0]), T(binv[0]), T(pmat[0]),
                                                LS, prior))
        assert torch.equal(s1, ops.uncertainty_scores(*(a[0] for a in args), **kw))
        assert _all_launches()["score_single_resident"] == before["score_single_resident"] + 2


# (N, n, cap, d, cap tile): the sizes of the smoke's tiled-gradient accuracy
# check (chip_smoke.TILED_GRAD_ACCURACY), and the single-client resident
# route's largest cap at d=300 (2960: clusters of 16 blocks of 185 rows).
CUDA_GRADS = [(1, 1, 1000, 300, 256), (1, 1, 4096, 300, 256), (5, 1, 1000, 300, 256),
              (1, 1, 1024, 1500, 256), (2, 7, 45, 1029, 8), (5, 1, 192, 300, 64),
              (1, 1, 16, 8, 8), (1, 1, 2960, 300, 256)]


@pytest.mark.parametrize("nb,n,cap,d,tile", CUDA_GRADS)
def test_cuda_grad_means_match_plain_and_repeat(nb, n, cap, d, tile):
    """The gradient kernel's routes on the card, at query points that are
    the last rows of each client's trajectory.  The cap-tiled route (B4
    client-batched, B8b one client) against float64 (the tiled plain
    version on float64 copies of the inputs): its max error is no more than
    the f32 plain version's; the single-client entry on client b gives row
    b of the client-batched entry bit for bit; a second launch gives the
    same bits.  The resident routes (B3 client-batched, B8a one client)
    against their plain versions (ATOL) and bitwise the same on a second
    launch; B8a, whose clusters are the tiled route's, gives B8b's bits
    (the chunking changes no sum's order).  Launch counts exact."""
    dev = _cuda()
    _, xs, _, _, alpha = _inputs(nb, n, d, cap, seed=cap + n + d)
    q = np.ascontiguousarray(xs[:, -n:])
    c = lambda a: T(a).to(dev)
    before = _all_launches()
    args = (c(q), c(xs), c(alpha))
    got = ops.grad_mean_clients(*args, lengthscale=LS, block_cap=tile)
    assert torch.equal(got, ops.grad_mean_clients(*args, lengthscale=LS, block_cap=tile))
    ones = []
    for b in range(nb):
        one = ops.grad_mean_batch(*(a[b] for a in args), lengthscale=LS, block_cap=tile)
        assert torch.equal(one, got[b])
        ones.append(one)
    assert torch.equal(ones[0], ops.grad_mean_batch(*(a[0] for a in args), lengthscale=LS,
                                                    block_cap=tile))
    f64 = lambda a: T(a).double()
    truth = gp_grad.grad_mean_tiled_plain(f64(q), f64(xs), f64(alpha), LS, tile)
    plain = gp_grad.grad_mean_tiled_plain(T(q), T(xs), T(alpha), LS, tile)
    assert torch.isfinite(got).all() and got.shape == (nb, n, d)
    assert (got.cpu().double() - truth).abs().max() <= (plain.double() - truth).abs().max()
    after = _all_launches()
    assert after["grad_tiled"] == before["grad_tiled"] + 2
    assert after["grad_single_tiled"] == before["grad_single_tiled"] + nb + 1
    for kind, entry in (("grad_clients", "grad_resident"), ("grad", "grad_single_resident")):
        if autotune.select_blocks(kind, n=n, cap=cap, d=d)[1] < cap:
            continue  # the tuner takes the tiled route at this shape
        before = _all_launches()
        if kind == "grad":
            res = ops.grad_mean_batch(*(a[0] for a in args), lengthscale=LS)
            _close(res.cpu(), ref.grad_mean_batch(T(q[0]), T(xs[0]), T(alpha[0]), LS))
            assert torch.equal(res, ops.grad_mean_batch(*(a[0] for a in args), lengthscale=LS))
            assert torch.equal(res, ones[0])
        else:
            res = ops.grad_mean_clients(*args, lengthscale=LS)
            _close(res.cpu(), ref.grad_mean_clients(T(q), T(xs), T(alpha), LS))
            assert torch.equal(res, ops.grad_mean_clients(*args, lengthscale=LS))
        assert _all_launches()[entry] == before[entry] + 2
