"""Wrapper of the RFF feature kernel (csrc/rff_features.cu, B6).

``rff_features`` takes x (n, d), the bank v (M, d) and b (M,) and returns
phi(X) = sqrt(2/M) cos(X V^T + b), (n, M); the kernel masks ragged n, M
and d itself, so nothing is padded.  On CPU tensors it computes the plain
version; on CUDA tensors it launches the kernel (building it on first use)
or raises.  ``LAUNCHES`` counts the kernel launches.
"""

from __future__ import annotations

import math

import torch

from repro_torch.kernels import loader, ref

LAUNCHES = {"rff_features": 0}


def rff_features(x, v, b):
    """phi(X): (n, d), (M, d), (M,) -> (n, M)."""
    n, d = x.shape
    m = v.shape[0]
    loader.check_inputs("rff_features", {"x": (x, (n, d)), "v": (v, (m, d)), "b": (b, (m,))})
    if loader.on_cpu(x, v, b):
        return ref.rff_features(x, v, b)
    out = torch.empty((n, m), dtype=torch.float32, device=x.device)
    err = loader.library().fz_rff_features(x.data_ptr(), v.data_ptr(), b.data_ptr(),
                                           out.data_ptr(), n, m, d, math.sqrt(2.0 / m),
                                           loader.stream())
    loader.check(err, "rff_features")
    LAUNCHES["rff_features"] += 1
    return out
