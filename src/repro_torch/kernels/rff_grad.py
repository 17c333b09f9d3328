"""Wrapper of the RFF gradient-contraction kernel (csrc/rff_grad.cu, B5).

``rff_grad_rows`` takes x (n, d), the bank v (M, d) and b (M,), and one
weight vector per row, ws (n, M); ``rff_grad`` one w (M,) for every row.
Both return grad phi(X)^T w, (n, d), through the same kernel entry (the
weight stride selects the form): one device kernel, a thread block
cluster per row, with no scratch (S stays in shared memory).  On CPU
tensors the wrappers compute the plain versions; on CUDA tensors they
launch the kernel (building it on first use) or raise.  ``LAUNCHES``
counts the launches of the entry.
"""

from __future__ import annotations

import math

import torch

from repro_torch.kernels import loader, ref

LAUNCHES = {"rff_grad": 0}


def _launch(x, v, b, w, w_stride):
    n, d = x.shape
    m = v.shape[0]
    out = torch.empty((n, d), dtype=torch.float32, device=x.device)
    err = loader.library().fz_rff_grad(x.data_ptr(), v.data_ptr(), b.data_ptr(), w.data_ptr(),
                                       out.data_ptr(), n, m, d, w_stride, math.sqrt(2.0 / m),
                                       loader.stream())
    loader.check(err, "rff_grad")
    LAUNCHES["rff_grad"] += 1
    return out


def _checked(x, v, b, w, w_shape):
    n, d = x.shape
    m = v.shape[0]
    loader.check_inputs("rff_grad", {"x": (x, (n, d)), "v": (v, (m, d)), "b": (b, (m,)),
                                     "w": (w, w_shape(n, m))})


def rff_grad_rows(x, v, b, ws):
    """Per-row weights: x (n, d), ws (n, M) -> (n, d)."""
    _checked(x, v, b, ws, lambda n, m: (n, m))
    if loader.on_cpu(x, v, b, ws):
        return ref.rff_grad_rows(x, v, b, ws)
    return _launch(x, v, b, ws, v.shape[0])


def rff_grad(x, v, b, w):
    """One weight vector for every row: x (n, d), w (M,) -> (n, d)."""
    _checked(x, v, b, w, lambda n, m: (m,))
    if loader.on_cpu(x, v, b, w):
        return ref.rff_grad(x, v, b, w)
    return _launch(x, v, b, w, 0)
