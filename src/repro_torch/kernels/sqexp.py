"""Wrapper of the SE Gram kernel (csrc/sqexp.cu, B9).

``sqexp_clients`` takes x1 (N, a, d) and x2 (N, b, d) and returns the
client-batched Gram exp(-max(|x1|^2 + |x2|^2 - 2 x1.x2, 0) / 2 l^2),
(N, a, b), in one launch; ``kernels.ops.sqexp`` sends a 2-D call as N=1.
The kernel masks ragged a, b and d itself, so nothing is padded.  On CPU
tensors it computes the plain version with float64 distances
(``ref.sqexp_f64``, as accurate as the kernel's compensated sums); on
CUDA tensors it launches the kernel (building it on first use) or raises.
``LAUNCHES`` counts the kernel launches, ``LAUNCHES_BY_ROWS`` the same
launches by the number of rows a of x1 (an append event's 1 or k new
rows, factor_init's cap).
"""

from __future__ import annotations

import torch

from repro_torch.kernels import loader, ref

LAUNCHES = {"sqexp": 0}
LAUNCHES_BY_ROWS: dict[int, int] = {}


def sqexp_clients(x1, x2, *, lengthscale):
    """SE Gram per client: (N, a, d), (N, b, d) -> (N, a, b)."""
    nb, a, d = x1.shape
    c = x2.shape[1]
    loader.check_inputs("sqexp", {"x1": (x1, (nb, a, d)), "x2": (x2, (nb, c, d))})
    if loader.on_cpu(x1, x2):
        return ref.sqexp_f64(x1, x2, lengthscale)
    out = torch.empty((nb, a, c), dtype=torch.float32, device=x1.device)
    err = loader.library().fz_sqexp(x1.data_ptr(), x2.data_ptr(), out.data_ptr(), nb, a, c, d,
                                    0.5 / float(lengthscale) ** 2, loader.stream())
    loader.check(err, "sqexp")
    LAUNCHES["sqexp"] += 1
    LAUNCHES_BY_ROWS[a] = LAUNCHES_BY_ROWS.get(a, 0) + 1
    return out
