"""Wrappers of the client-batched uncertainty-scoring kernels (csrc/gp_score.cu).

``uncertainty_scores_resident`` and ``uncertainty_scores_tiled`` take
already padded inputs (``kernels.ops`` pads and routes): candidates
(N, n, d) with n a multiple of ``block_n``, trajectory xs (N, cap, d), the
masked Gram inverse B and P = B o XX^T (N, cap, cap), and for the tiled
route cap a multiple of ``block_cap``.  They return the scores (N, n).

On CPU tensors each wrapper computes its kernel's plain version; on CUDA
tensors it launches the kernel (building it on first use) or raises.
``LAUNCHES`` counts the kernel launches of each wrapper.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import loader, ref

LAUNCHES = {"score_resident": 0, "score_tiled": 0}


def _checked(name, cands, xs, binv, pmat, block_n, block_cap=None):
    nb, n, d = cands.shape
    cap = xs.shape[1]
    loader.check_inputs(name, {
        "cands": (cands, (nb, n, d)), "xs": (xs, (nb, cap, d)),
        "binv": (binv, (nb, cap, cap)), "pmat": (pmat, (nb, cap, cap)),
    })
    if n % block_n:
        raise ValueError(f"{name}: n={n} is not a multiple of block_n={block_n}")
    if block_cap is not None and cap % block_cap:
        raise ValueError(f"{name}: cap={cap} is not a multiple of block_cap={block_cap}")
    return nb, n, cap, d


def _scalars(lengthscale: float, prior: float):
    l2 = float(lengthscale) ** 2
    return 0.5 / l2, 1.0 / (l2 * l2), float(prior)


def uncertainty_scores_resident(cands, xs, binv, pmat, *, lengthscale, prior, block_n):
    """Scores with h over the whole trajectory kept on chip: (N, n) ."""
    nb, n, cap, d = _checked("score_resident", cands, xs, binv, pmat, block_n)
    if loader.on_cpu(cands, xs, binv, pmat):
        return ref.uncertainty_scores_clients_fused(cands, xs, binv, pmat, lengthscale, prior)
    out = torch.empty((nb, n), dtype=torch.float32, device=cands.device)
    inv_two_l2, inv_l4, pr = _scalars(lengthscale, prior)
    err = loader.library().fz_score_resident(
        cands.data_ptr(), xs.data_ptr(), binv.data_ptr(), pmat.data_ptr(), out.data_ptr(),
        nb, n, cap, d, block_n, inv_two_l2, inv_l4, pr, loader.stream())
    loader.check(err, "score_resident")
    LAUNCHES["score_resident"] += 1
    return out


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
    """Scores over (block_cap x block_cap) cells of B and P: (N, n)."""
    nb, n, cap, d = _checked("score_tiled", cands, xs, binv, pmat, block_n, block_cap)
    if loader.on_cpu(cands, xs, binv, pmat):
        return scores_tiled_plain(cands, xs, binv, pmat, lengthscale, prior, block_cap)
    out = torch.empty((nb, n), dtype=torch.float32, device=cands.device)
    inv_two_l2, inv_l4, pr = _scalars(lengthscale, prior)
    err = loader.library().fz_score_tiled(
        cands.data_ptr(), xs.data_ptr(), binv.data_ptr(), pmat.data_ptr(), out.data_ptr(),
        nb, n, cap, d, block_n, block_cap, inv_two_l2, inv_l4, pr, loader.stream())
    loader.check(err, "score_tiled")
    LAUNCHES["score_tiled"] += 1
    return out
