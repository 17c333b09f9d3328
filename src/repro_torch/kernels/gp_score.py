"""Wrappers of the uncertainty-scoring kernels (csrc/gp_score.cu).

The client-batched wrappers ``uncertainty_scores_resident`` and
``uncertainty_scores_tiled`` take already padded inputs (``kernels.ops``
pads and routes): candidates (N, n, d) with n a multiple of ``block_n``,
trajectory xs (N, cap, d), the masked Gram inverse B and P = B o XX^T
(N, cap, cap); the tiled route takes any cap, ``block_cap`` being the rows
of its panels, and an f64 work buffer the wrapper allocates
(``autotune.score_tiled_work``; under a graph capture, from the graph's
memory pool).  They return the scores (N, n).  The
``*_single_*`` wrappers take one client's inputs, the same shapes without
N, and return (n,): the resident one launches the cluster kernel with one
client and its own geometry (``autotune.cluster_geometry(cap,
single=True)``), the tiled one the same passes as the client-batched one.

On CPU tensors each wrapper computes its kernel's plain version; on CUDA
tensors it launches the kernel (building it on first use) or raises.
``LAUNCHES`` counts the kernel launches of each wrapper.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import autotune, loader, ref

LAUNCHES = {"score_resident": 0, "score_tiled": 0,
            "score_single_resident": 0, "score_single_tiled": 0}


def _checked(name, cands, xs, binv, pmat, block_n, block_cap=None):
    nb, n, d = cands.shape
    cap = xs.shape[1]
    loader.check_inputs(name, {
        "cands": (cands, (nb, n, d)), "xs": (xs, (nb, cap, d)),
        "binv": (binv, (nb, cap, cap)), "pmat": (pmat, (nb, cap, cap)),
    })
    if n % block_n:
        raise ValueError(f"{name}: n={n} is not a multiple of block_n={block_n}")
    if block_cap is not None and block_cap < 1:
        raise ValueError(f"{name}: block_cap={block_cap} must be positive")


def _launch(name, cands, xs, binv, pmat, lengthscale, prior, block_n, block_cap=None):
    """One launch of the kernel behind ``name`` on checked client-batched
    CUDA tensors; the single-client entries take no client count.  The
    resident route passes its cluster geometry, the tiled route its work
    buffer, its panel rows and f64 scalars."""
    nb, n, d = cands.shape
    cap = xs.shape[1]
    out = torch.empty((nb, n), dtype=torch.float32, device=cands.device)
    l2 = float(lengthscale) ** 2
    ptrs = [cands.data_ptr(), xs.data_ptr(), binv.data_ptr(), pmat.data_ptr(), out.data_ptr()]
    sizes = [n] if name.startswith("score_single") else [nb, n]
    sizes += [cap, d, block_n]
    if block_cap is None:
        sizes += autotune.cluster_geometry(cap, single=name.startswith("score_single"))
    else:
        work = torch.empty(autotune.score_tiled_work(nb, n, cap, block_cap),
                           dtype=torch.float64, device=cands.device)
        ptrs.append(work.data_ptr())
        sizes.append(block_cap)
    err = getattr(loader.library(), "fz_" + name)(
        *ptrs, *sizes, 0.5 / l2, 1.0 / (l2 * l2), float(prior), loader.stream())
    loader.check(err, name)
    LAUNCHES[name] += 1
    return out


def uncertainty_scores_resident(cands, xs, binv, pmat, *, lengthscale, prior, block_n):
    """Scores with h over the whole trajectory kept on chip, one thread
    block cluster per client and candidate tile
    (``autotune.cluster_geometry``): (N, n)."""
    _checked("score_resident", cands, xs, binv, pmat, block_n)
    if loader.on_cpu(cands, xs, binv, pmat):
        return ref.uncertainty_scores_clients_fused(cands, xs, binv, pmat, lengthscale, prior)
    return _launch("score_resident", cands, xs, binv, pmat, lengthscale, prior, block_n)


def scores_tiled_plain(cands, xs, binv, pmat, lengthscale, prior, block_cap):
    """Plain version of the tiled kernel: the same sum over (j, k) cap tiles,
    with h_j, h_k and c.x_k recomputed per cell."""
    tile = lambda t0: ref._h_cross(cands, xs[:, t0:t0 + block_cap], lengthscale)
    acc = torch.zeros(cands.shape[:2], dtype=cands.dtype, device=cands.device)
    for j0 in range(0, xs.shape[1], block_cap):
        hj, _, _ = tile(j0)
        for k0 in range(0, xs.shape[1], block_cap):
            hk, ck, n1 = tile(k0)
            g1 = hj @ pmat[:, j0:j0 + block_cap, k0:k0 + block_cap]
            g2 = hj @ binv[:, j0:j0 + block_cap, k0:k0 + block_cap]
            acc = acc + torch.sum((g1 - (2.0 * ck - n1[..., None]) * g2) * hk, dim=-1)
    return torch.clamp(prior - acc / (lengthscale**4), min=0.0)


def uncertainty_scores_tiled(cands, xs, binv, pmat, *, lengthscale, prior, block_n, block_cap):
    """Scores by panels of block_cap rows of B and P, in f64: (N, n)."""
    _checked("score_tiled", cands, xs, binv, pmat, block_n, block_cap)
    if loader.on_cpu(cands, xs, binv, pmat):
        return scores_tiled_plain(cands, xs, binv, pmat, lengthscale, prior, block_cap)
    return _launch("score_tiled", cands, xs, binv, pmat, lengthscale, prior, block_n, block_cap)


def uncertainty_scores_single_resident(cands, xs, binv, pmat, *, lengthscale, prior, block_n):
    """One client's scores, resident route: (n, d) -> (n,)."""
    args = (cands[None], xs[None], binv[None], pmat[None])
    _checked("score_single_resident", *args, block_n)
    if loader.on_cpu(cands, xs, binv, pmat):
        return ref.uncertainty_scores(cands, xs, binv, pmat, lengthscale, prior)
    return _launch("score_single_resident", *args, lengthscale, prior, block_n)[0]


def uncertainty_scores_single_tiled(cands, xs, binv, pmat, *, lengthscale, prior, block_n,
                                    block_cap):
    """One client's scores by panels of block_cap rows: (n, d) -> (n,)."""
    args = (cands[None], xs[None], binv[None], pmat[None])
    _checked("score_single_tiled", *args, block_n, block_cap)
    if loader.on_cpu(cands, xs, binv, pmat):
        return scores_tiled_plain(*args, lengthscale, prior, block_cap)[0]
    return _launch("score_single_tiled", *args, lengthscale, prior, block_n, block_cap)[0]
