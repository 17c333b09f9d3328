"""Port parity of the GP kernels, client-batched (B1-B4) and single-client
(B7, B8), and their wrappers.

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
partial sum, far inside 5e-5.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as rops
from repro.kernels import ref as rref
from repro_torch.kernels import autotune, gp_grad, gp_score, ops, ref

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


def _close(got, want):
    want = np.asarray(want)
    scale = max(float(np.abs(want).max()), 1.0)
    np.testing.assert_allclose(np.asarray(got) / scale, want / scale, atol=ATOL)


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


def test_cpu_tensors_launch_nothing():
    cands, xs, binv, pmat, alpha = _inputs(2, 3, 3, 8, seed=1)
    before = dict(gp_score.LAUNCHES), dict(gp_grad.LAUNCHES)
    ops.uncertainty_scores_clients(T(cands), T(xs), T(binv), T(pmat), lengthscale=LS, prior=4.0)
    ops.grad_mean_clients(T(cands), T(xs), T(alpha), lengthscale=LS, block_cap=4, block_n=1)
    ops.uncertainty_scores(T(cands[0]), T(xs[0]), T(binv[0]), T(pmat[0]), lengthscale=LS,
                           prior=4.0, block_cap=4, block_n=1)
    ops.grad_mean_batch(T(cands[1]), T(xs[1]), T(alpha[1]), lengthscale=LS)
    assert (dict(gp_score.LAUNCHES), dict(gp_grad.LAUNCHES)) == before


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
    with pytest.raises(ValueError):  # cap=8 is not a multiple of block_cap=3
        gp_grad.grad_mean_tiled(T(cands), T(xs), T(alpha), lengthscale=LS, block_n=4,
                                block_cap=3)
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
    with pytest.raises(ValueError):  # cap=8 is not a multiple of block_cap=3
        gp_grad.grad_mean_single_tiled(T(cands[0]), T(xs[0]), T(alpha[0]), lengthscale=LS,
                                       block_n=4, block_cap=3)
    with pytest.raises(ValueError):  # alpha is not (cap,)
        gp_grad.grad_mean_single_resident(T(cands[0]), T(xs[0]), T(alpha), lengthscale=LS,
                                          block_n=4)


def test_autotune_is_deterministic_and_fits():
    main = autotune.select_blocks("score", n=50, cap=192, d=300)
    assert main == autotune.select_blocks("score", n=50, cap=192, d=300)
    assert main[1] >= 192  # the main path's scoring runs resident
    assert autotune.select_blocks("grad", n=1, cap=192, d=300) == (1, 192)
    big = autotune.select_blocks("score", n=50, cap=8192, d=300)
    assert big[1] < 8192  # the resident h tile no longer fits: tiled
    for kind, (bn, bc), cap in (("score", main, 192), ("score", big, 8192)):
        assert autotune.smem_bytes(kind, block_n=bn, block_cap=bc, cap=cap, d=300) \
            <= autotune.SMEM_BYTES


def test_validate_blocks_rejects_what_the_kernels_cannot_take():
    assert autotune.validate_blocks("grad", block_n=1, block_cap=64, cap=192, d=300) == (1, 64)
    with pytest.raises(ValueError, match="block_n"):
        autotune.validate_blocks("score", block_n=3, block_cap=64, cap=192, d=300)
    with pytest.raises(ValueError, match="shared memory"):
        autotune.validate_blocks("score", block_n=16, block_cap=4096, cap=4096, d=300)
    with pytest.raises(ValueError):  # pinned through ops
        ops.grad_mean_clients(torch.zeros(1, 1, 4), torch.zeros(1, 8, 4), torch.zeros(1, 8),
                              lengthscale=1.0, block_n=5)


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
