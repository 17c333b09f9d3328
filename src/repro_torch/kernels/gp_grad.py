"""Wrappers of the gradient-mean kernel (csrc/gp_grad.cu).

Every route launches one kernel, ``grad_cluster_kernel``: a thread block
cluster per (client, candidate tile) whose blocks stream their part of the
trajectory in chunks; the wrappers give it its geometry
(``autotune.grad_geometry``).  The resident wrappers take each block's part
in one chunk, with clusters of up to 8 blocks client-batched (B3) and up to
16 for one client (B8a); the tiled wrappers chunks of at most ``block_cap``
rows with the single-client clusters for both (B4, B8b), at any cap, so one
client's tiled gradient is its row of a client-batched call bit for bit.

The client-batched wrappers take query points (N, n, d) with n a multiple
of ``block_n`` (``kernels.ops`` pads the candidate axis and routes),
trajectory xs (N, cap, d) and alpha (N, cap) with the validity mask folded
in, and return grad mu (N, n, d).  The ``*_single_*`` wrappers take one
client's inputs, the same shapes without N, and return (n, d).

On CPU tensors each wrapper computes its kernel's plain version; on CUDA
tensors it launches the kernel (building it on first use) or raises.
``LAUNCHES`` counts the kernel launches of each wrapper.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import autotune, loader, ref

LAUNCHES = {"grad_resident": 0, "grad_tiled": 0,
            "grad_single_resident": 0, "grad_single_tiled": 0}


def _checked(name, cands, xs, alpha, block_n, block_cap=None):
    nb, n, d = cands.shape
    cap = xs.shape[1]
    loader.check_inputs(name, {
        "cands": (cands, (nb, n, d)), "xs": (xs, (nb, cap, d)), "alpha": (alpha, (nb, cap)),
    })
    if n % block_n:
        raise ValueError(f"{name}: n={n} is not a multiple of block_n={block_n}")
    if block_cap is not None and block_cap < 1:
        raise ValueError(f"{name}: block_cap={block_cap} must be positive")


def _launch(name, cands, xs, alpha, lengthscale, block_n, geometry=()):
    """One launch of the kernel behind ``name`` on checked client-batched
    CUDA tensors; the single-client entries take no client count.
    ``geometry`` is the route's further ints: the cluster size, and for the
    tiled entries the chunk rows."""
    nb, n, d = cands.shape
    out = torch.empty((nb, n, d), dtype=torch.float32, device=cands.device)
    l2 = float(lengthscale) ** 2
    sizes = (n,) if name.startswith("grad_single") else (nb, n)
    sizes += (xs.shape[1], d, block_n, *geometry)
    err = getattr(loader.library(), "fz_" + name)(
        cands.data_ptr(), xs.data_ptr(), alpha.data_ptr(), out.data_ptr(),
        *sizes, 0.5 / l2, 1.0 / l2, loader.stream())
    loader.check(err, name)
    LAUNCHES[name] += 1
    return out


def grad_mean_resident(cands, xs, alpha, *, lengthscale, block_n):
    """Gradient mean with each client's trajectory split over the blocks of
    one thread block cluster per candidate tile
    (``autotune.cluster_geometry``): (N, n, d)."""
    _checked("grad_resident", cands, xs, alpha, block_n)
    if loader.on_cpu(cands, xs, alpha):
        return ref.grad_mean_clients(cands, xs, alpha, lengthscale)
    return _launch("grad_resident", cands, xs, alpha, lengthscale, block_n,
                   autotune.grad_geometry(xs.shape[1], cands.shape[2], block_n)[:1])


def grad_mean_tiled_plain(cands, xs, alpha, lengthscale, block_cap):
    """Plain version of the tiled route: the product and the weight sum
    accumulated over cap tiles (the last one ragged where block_cap does
    not divide cap)."""
    acc = torch.zeros_like(cands)
    s = torch.zeros_like(cands[..., :1])
    for t0 in range(0, xs.shape[1], block_cap):
        x = xs[:, t0:t0 + block_cap]
        w = ref._h_cross(cands, x, lengthscale)[0] * alpha[:, None, t0:t0 + block_cap]
        acc = acc + w @ x
        s = s + torch.sum(w, dim=-1, keepdim=True)
    return (acc - s * cands) / (lengthscale**2)


def grad_mean_tiled(cands, xs, alpha, *, lengthscale, block_n, block_cap):
    """Gradient mean with each block's rows streamed in chunks of at most
    block_cap rows, at any cap: (N, n, d)."""
    _checked("grad_tiled", cands, xs, alpha, block_n, block_cap)
    if loader.on_cpu(cands, xs, alpha):
        return grad_mean_tiled_plain(cands, xs, alpha, lengthscale, block_cap)
    return _launch("grad_tiled", cands, xs, alpha, lengthscale, block_n,
                   autotune.grad_geometry(xs.shape[1], cands.shape[2], block_n, block_cap))


def grad_mean_single_resident(cands, xs, alpha, *, lengthscale, block_n):
    """One client's gradient mean, resident route: (n, d) -> (n, d)."""
    args = (cands[None], xs[None], alpha[None])
    _checked("grad_single_resident", *args, block_n)
    if loader.on_cpu(cands, xs, alpha):
        return ref.grad_mean_batch(cands, xs, alpha, lengthscale)
    return _launch("grad_single_resident", *args, lengthscale, block_n,
                   autotune.grad_geometry(xs.shape[0], cands.shape[1], block_n, single=True)[:1])[0]


def grad_mean_single_tiled(cands, xs, alpha, *, lengthscale, block_n, block_cap):
    """One client's gradient mean, chunks of at most block_cap rows:
    (n, d) -> (n, d)."""
    args = (cands[None], xs[None], alpha[None])
    _checked("grad_single_tiled", *args, block_n, block_cap)
    if loader.on_cpu(cands, xs, alpha):
        return grad_mean_tiled_plain(*args, lengthscale, block_cap)[0]
    return _launch("grad_single_tiled", *args, lengthscale, block_n,
                   autotune.grad_geometry(xs.shape[0], cands.shape[1], block_n, block_cap))[0]
