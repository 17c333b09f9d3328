"""Trajectory-informed derived-GP gradient surrogate with the cached Gram
factor (port of ``repro.core.gp_surrogate``).

The factor cache and the ``*_clients`` functions carry a leading client
axis N: the port's engines keep all clients in one stacked state, and each
of these is the batched form of the reference function of the same name
(where the reference vmaps, the batch dimension is written out).  Two
factor updates are ported:

* ``factor_update_deferred`` (the deferred engine): branch-free; an
  unhealthy update raises ``needs_repair`` and freezes the factor until
  ``factor_repair_masked`` (driven by ``core.rounds.repair_flagged_clients``)
  refactorizes the exact cached Gram with a clamped eigh;
* ``factor_update`` (the per-client engine): an unhealthy update falls back
  to the clamped eigh at once, for the failing clients only.

As under the reference's client vmap, both factor candidates (border
extension and full refresh) are computed and selected per client with
``torch.where``.  Cholesky, eigh and the triangular solves go to
``torch.linalg``; ``cholesky_ex``'s ``info`` is the branch-free non-PD
signal that the reference reads from NaN pivots; Cholesky solves are two
triangular solves (``chol_solve``).

The single-client functions (``gp_alpha_cached``, ``grad_mean_cached``,
``grad_uncertainty_batch_cached``, ``select_active_queries_cached``) take
one client's trajectory and factor (no leading axis; ``client`` cuts one
out of a stacked batch) and run the single-client kernels.  The seed
eigh path (``gp_alpha``, ``grad_mean``, ``grad_uncertainty_batch``,
``select_active_queries``, ...) refactorizes from scratch on every call,
single-client, as the reference does; its Jacobians stay plain torch.

Every SE Gram (``sqexp``: the append events' new rows, ``factor_init``,
the seed path's padded Gram, ``mean_value``) is one launch of the SE Gram
kernel (B9, ``kernels.ops.sqexp``) in the reference's expanded form.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional

import torch

from repro_torch.kernels import ops

#: A live pivot below ``PIVOT_FLOOR_SCALE * sqrt(jitter)`` marks the factor
#: unhealthy (same rule as the reference).
PIVOT_FLOOR_SCALE = 0.5


class Trajectory(NamedTuple):
    """Fixed-capacity ring buffers of (x, y) queries, one per client."""

    xs: torch.Tensor  # (N, cap, d)
    ys: torch.Tensor  # (N, cap)
    count: torch.Tensor  # (N,) int32 total appends (may exceed cap)

    @property
    def capacity(self) -> int:
        return self.xs.shape[-2]

    @property
    def dim(self) -> int:
        return self.xs.shape[-1]

    def n_valid(self) -> torch.Tensor:
        return torch.clamp(self.count, max=self.capacity)

    def valid_mask(self) -> torch.Tensor:
        """(N, cap) 1.0 on live slots, 0.0 on padding."""
        ar = torch.arange(self.capacity, device=self.xs.device)
        return (ar < self.n_valid()[..., None]).to(self.xs.dtype)


class GPHyper(NamedTuple):
    lengthscale: float
    noise: float  # observation noise variance sigma^2


class GramFactor(NamedTuple):
    """Cached factorization of each client's padded Gram system.

    ``chol`` is the lower Cholesky factor of ``gram`` while ``exact``;
    after a repair solves route through the clamped eigh factors.
    ``needs_repair`` freezes the factor until the next repair pass.
    """

    gram: torch.Tensor  # (N, cap, cap) padded Gram (always exact)
    chol: torch.Tensor  # (N, cap, cap)
    eigvecs: torch.Tensor  # (N, cap, cap)
    eigvals: torch.Tensor  # (N, cap)
    exact: torch.Tensor  # (N,) bool
    n_updates: torch.Tensor  # (N,) int32
    n_refactors: torch.Tensor  # (N,) int32
    needs_repair: torch.Tensor  # (N,) bool


def traj_init(n_clients: int, capacity: int, dim: int, device, dtype=torch.float32) -> Trajectory:
    return Trajectory(
        xs=torch.zeros((n_clients, capacity, dim), dtype=dtype, device=device),
        ys=torch.zeros((n_clients, capacity), dtype=dtype, device=device),
        count=torch.zeros((n_clients,), dtype=torch.int32, device=device),
    )


def client(batch, i: int):
    """Client ``i`` of a stacked ``Trajectory`` or ``GramFactor`` (views)."""
    return type(batch)(*(a[i] for a in batch))


def _rows(n: int, device) -> torch.Tensor:
    return torch.arange(n, device=device)[:, None]


def traj_append_batch(traj: Trajectory, xs: torch.Tensor, ys: torch.Tensor) -> Trajectory:
    """Append k queries per client, (N, k, d) and (N, k), as one scatter;
    later rows win when the batch itself wraps the ring."""
    k = xs.shape[1]
    cap = traj.capacity
    total = traj.count + k
    offset = 0
    if k > cap:  # only the last `cap` rows survive a full wrap
        xs, ys, offset = xs[:, k - cap:], ys[:, k - cap:], k - cap
    ar = torch.arange(xs.shape[1], device=xs.device)
    idx = (traj.count.long()[:, None] + offset + ar) % cap
    rows = _rows(xs.shape[0], xs.device)
    new_xs = traj.xs.clone()
    new_xs[rows, idx] = xs.to(traj.xs.dtype)
    new_ys = traj.ys.clone()
    new_ys[rows, idx] = ys.to(traj.ys.dtype)
    return Trajectory(xs=new_xs, ys=new_ys, count=total)


def sqexp(x1: torch.Tensor, x2: torch.Tensor, lengthscale: float) -> torch.Tensor:
    """Pairwise SE kernel, (N, a, d), (N, b, d) -> (N, a, b) or (a, d),
    (b, d) -> (a, b): one launch of the SE Gram kernel (B9), in the
    reference's expanded form max(|x1|^2 + |x2|^2 - 2 x1.x2, 0)."""
    return ops.sqexp(x1, x2, lengthscale)


def _jitter_of(hyper: GPHyper) -> float:
    return max(float(hyper.noise), 1e-4)


def _padded_gram(traj: Trajectory, hyper: GPHyper) -> tuple[torch.Tensor, torch.Tensor]:
    """Padded Gram systems [K_n + s^2 I, I] and the validity masks."""
    mask = traj.valid_mask()
    k = sqexp(traj.xs, traj.xs, hyper.lengthscale)
    m2 = mask[..., :, None] * mask[..., None, :]
    gram = k * m2 + torch.diag_embed(_jitter_of(hyper) * mask + (1.0 - mask))
    return gram, mask


def _factor_health(chol, mask, jitter: float, info: torch.Tensor) -> torch.Tensor:
    """(N,) True when the factorization succeeded and every live pivot is
    finite and at or above the pivot floor."""
    floor = PIVOT_FLOOR_SCALE * math.sqrt(jitter)
    diag = torch.diagonal(chol, dim1=-2, dim2=-1)
    live = torch.where(mask > 0, diag, torch.ones_like(diag))
    return (info == 0) & torch.isfinite(chol).all(-1).all(-1) & (live >= floor).all(-1)


def _eye_like(gram: torch.Tensor) -> torch.Tensor:
    cap = gram.shape[-1]
    return torch.eye(cap, dtype=gram.dtype, device=gram.device).expand_as(gram)


def _clamped_eigh(gram: torch.Tensor, jitter: float) -> tuple[torch.Tensor, torch.Tensor]:
    """Eigenvectors and clamped eigenvalues of each Gram.  A Gram with a
    non-finite entry (a run poisoned by a fault it does not tolerate) gets
    NaN factors, as the reference's eigh gives, where LAPACK and cuSOLVER
    would fail; a finite Gram's factors are unchanged."""
    bad = ~torch.isfinite(gram).all(-1).all(-1)
    w, v = torch.linalg.eigh(torch.where(bad[..., None, None], _eye_like(gram), gram))
    v = torch.where(bad[..., None, None], float("nan"), v)
    w = torch.where(bad[..., None], float("nan"), w)
    return v, torch.clamp(w, min=jitter)


def dkdx(x: torch.Tensor, xs: torch.Tensor, lengthscale: float) -> torch.Tensor:
    """d_x k(x, X) for the SE kernel: x (..., d), xs (cap, d) -> (..., cap, d),
    row t = -(x - x_t)/l^2 k(x, x_t)."""
    diff = x[..., None, :] - xs
    k = torch.exp(-0.5 * torch.sum(diff * diff, dim=-1) / (lengthscale**2))
    return (-diff / (lengthscale**2)) * k[..., None]


def _masked_gram_chol(traj: Trajectory, hyper: GPHyper):
    """Clamped-eigh factors of one client's padded Gram, from scratch:
    ((eigvecs, eigvals), mask).  The from-scratch oracle of the seed path."""
    gram, mask = _padded_gram(traj, hyper)
    return _clamped_eigh(gram, _jitter_of(hyper)), mask


def _gram_solve(factors, b: torch.Tensor) -> torch.Tensor:
    """(K + jitter)^-1 b through clamped eigh factors; b (cap,) or (..., cap, m)."""
    v, w = factors
    if b.dim() == 1:
        return v @ ((v.T @ b) / w)
    return v @ ((v.T @ b) / w[:, None])


def gp_alpha(traj: Trajectory, hyper: GPHyper) -> torch.Tensor:
    """alpha = (K + s^2 I)^{-1} y of one client, refactorized: (cap,)."""
    factors, mask = _masked_gram_chol(traj, hyper)
    return _gram_solve(factors, traj.ys * mask)


def grad_mean(traj: Trajectory, hyper: GPHyper, x: torch.Tensor,
              alpha: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Posterior gradient mean (eq. 5) of one client: x (..., d) -> (..., d)."""
    if alpha is None:
        alpha = gp_alpha(traj, hyper)
    j = dkdx(x, traj.xs, hyper.lengthscale) * traj.valid_mask()[:, None]
    return torch.einsum("...cd,c->...d", j, alpha)


def grad_mean_batch(traj: Trajectory, hyper: GPHyper, xs: torch.Tensor) -> torch.Tensor:
    """``grad_mean`` at (n, d) points with one alpha: (n, d)."""
    return grad_mean(traj, hyper, xs, gp_alpha(traj, hyper))


def grad_uncertainty_trace(traj: Trajectory, hyper: GPHyper, x: torch.Tensor,
                           chol_mask=None) -> torch.Tensor:
    """tr d_sigma2(x) = d/l^2 - sum J (K + s^2 I)^{-1} J, J = d_x k(x, X),
    clamped at 0: x (..., d) -> (...)."""
    factors, mask = _masked_gram_chol(traj, hyper) if chol_mask is None else chol_mask
    j = dkdx(x, traj.xs, hyper.lengthscale) * mask[:, None]
    corr = torch.sum(j * _gram_solve(factors, j), dim=(-2, -1))
    return torch.clamp(x.shape[-1] / (hyper.lengthscale**2) - corr, min=0.0)


def grad_uncertainty_batch(traj: Trajectory, hyper: GPHyper, xs: torch.Tensor) -> torch.Tensor:
    """Uncertainty scores of (n, d) candidates with one factorization: (n,)."""
    return grad_uncertainty_trace(traj, hyper, xs, _masked_gram_chol(traj, hyper))


def _top(scores: torch.Tensor, cands: torch.Tensor, n_select: int) -> torch.Tensor:
    """The ``n_select`` highest-scoring candidates, (..., n, d) -> (..., n_select, d);
    ties keep the lower candidate index first, as ``lax.top_k`` does."""
    top = torch.sort(scores, dim=-1, descending=True, stable=True).indices[..., :n_select]
    return torch.gather(cands, -2, top[..., None].expand(*top.shape, cands.shape[-1]))


def select_active_queries(deltas: torch.Tensor, traj: Trajectory, hyper: GPHyper,
                          center: torch.Tensor, n_select: int, lo: float = 0.0,
                          hi: float = 1.0) -> torch.Tensor:
    """The ``n_select`` most uncertain of the candidates ``center + deltas``
    (deltas (n, d) uniform in [-radius, radius]), scored from scratch."""
    cands = torch.clamp(center + deltas, lo, hi)
    return _top(grad_uncertainty_batch(traj, hyper, cands), cands, n_select)


def mean_value(traj: Trajectory, hyper: GPHyper, x: torch.Tensor) -> torch.Tensor:
    """Posterior mean of f itself at one point x (d,)."""
    kvec = sqexp(x[None], traj.xs, hyper.lengthscale)[0] * traj.valid_mask()
    return kvec @ gp_alpha(traj, hyper)


def factor_init(traj: Trajectory, hyper: GPHyper) -> GramFactor:
    """Build the factor caches from scratch (once, at client init)."""
    gram, mask = _padded_gram(traj, hyper)
    jitter = _jitter_of(hyper)
    chol, info = torch.linalg.cholesky_ex(gram)
    ok = _factor_health(chol, mask, jitter, info)
    eye = _eye_like(gram)
    v, w = eye.clone(), torch.ones(gram.shape[:-1], dtype=gram.dtype, device=gram.device)
    if not bool(ok.all()):  # init only: the clamped-eigh fallback for unhealthy clients
        ve, we = _clamped_eigh(gram, jitter)
        v = torch.where(ok[:, None, None], v, ve)
        w = torch.where(ok[:, None], w, we)
    n = gram.shape[0]
    return GramFactor(
        gram=gram,
        # row-major, as every update leaves it: an eager chunk's arithmetic
        # follows its inputs' strides, so a captured chunk (whose static
        # state keeps the initial layout) and the eager chunks meet the
        # same layouts at every boundary
        chol=torch.where(ok[:, None, None], chol, eye).contiguous(),
        eigvecs=v,
        eigvals=w,
        exact=ok,
        n_updates=torch.zeros((n,), dtype=torch.int32, device=gram.device),
        n_refactors=(~ok).to(torch.int32),
        needs_repair=torch.zeros((n,), dtype=torch.bool, device=gram.device),
    )


def _border_extend(chol, gram, start: torch.Tensor, k: int, jitter: float):
    """Extend each Cholesky factor by k contiguous appended rows (no wrap).

    Rows ``start .. start+k-1`` of ``gram`` are newly valid.  Returns the
    bordered factors and the ``info`` of the k x k factorizations.  As in
    the reference, out-of-range starts are clamped (the result is then
    discarded by the caller).
    """
    n, cap = chol.shape[0], chol.shape[-1]
    dev = chol.device
    ar = torch.arange(k, device=dev)
    s = torch.clamp(start.long(), 0, cap - k)
    cidx = s[:, None] + ar  # (N, k)
    cols = torch.gather(gram, 2, cidx[:, None, :].expand(n, cap, k))  # (N, cap, k)
    prefix = (torch.arange(cap, device=dev)[None, :] < start.long()[:, None]).to(cols.dtype)
    z = torch.linalg.solve_triangular(chol, cols * prefix[:, :, None], upper=False)
    rows = _rows(n, dev)
    c22 = gram[rows[:, :, None], cidx[:, :, None], cidx[:, None, :]]  # (N, k, k)
    ls, info = torch.linalg.cholesky_ex(c22 - z.transpose(-1, -2) @ z)
    border = z.transpose(-1, -2) * prefix[:, None, :]  # (N, k, cap), zero at/after start
    border = border.scatter(2, cidx[:, None, :].expand(n, k, k), ls)
    new = chol.scatter(1, cidx[:, :, None].expand(n, k, cap), border)
    return new, info


def _gram_replace_rows(factor: GramFactor, traj_new: Trajectory, hyper: GPHyper, k: int,
                       old_count: torch.Tensor) -> torch.Tensor:
    """Exact row/column replacement of the padded Grams: O(k cap d)."""
    cap = traj_new.capacity
    mask = traj_new.valid_mask()
    dev = mask.device
    idx = (old_count.long()[:, None] + torch.arange(k, device=dev)) % cap  # (N, k)
    rows = _rows(idx.shape[0], dev)
    xb = traj_new.xs[rows, idx]  # (N, k, d)
    new_rows = sqexp(xb, traj_new.xs, hyper.lengthscale) * mask[:, None, :]
    new_rows[rows, torch.arange(k, device=dev)[None, :], idx] += _jitter_of(hyper)
    gram = factor.gram.clone()
    gram[rows, idx] = new_rows
    gram[rows, :, idx] = new_rows  # column idx[n, j] <- new_rows[n, j, :]
    return gram


def _candidate(factor: GramFactor, gram, old_count, k: int, jitter: float, use_border):
    """Each client's candidate factor, the border extension where
    ``use_border`` and the full refresh elsewhere, and its ``info``."""
    b_chol, b_info = _border_extend(factor.chol, gram, old_count, k, jitter)
    r_chol, r_info = torch.linalg.cholesky_ex(gram)
    cand = torch.where(use_border[:, None, None], b_chol, r_chol)
    return cand, torch.where(use_border, b_info, r_info)


def factor_update(factor: GramFactor, traj_new: Trajectory, hyper: GPHyper, k: int,
                  old_count: torch.Tensor) -> GramFactor:
    """Factor maintenance with the inline clamped-eigh fallback (the
    per-client engine; ``traj_new`` is ``traj_append_batch`` of k rows).

    A healthy candidate (border before the ring wraps, refresh after) is
    adopted; an unhealthy one is replaced at once by the clamped eigh of
    the exact cached Gram, which the solves then route through.  The eigh
    runs only for the failing clients: their (N,) health flags are read on
    the host, one sync per append event, which this oracle engine accepts.
    ``n_refactors`` counts the fallbacks; ``needs_repair`` stays False.
    """
    cap = traj_new.capacity
    if k > cap:
        raise ValueError(f"append event of {k} rows exceeds capacity {cap}")
    jitter = _jitter_of(hyper)
    mask = traj_new.valid_mask()
    gram = _gram_replace_rows(factor, traj_new, hyper, k, old_count)
    use_border = (old_count + k <= cap) & factor.exact
    cand, info = _candidate(factor, gram, old_count, k, jitter, use_border)
    ok = _factor_health(cand, mask, jitter, info)
    v, w = factor.eigvecs, factor.eigvals
    bad = torch.nonzero(~ok).flatten()
    if bad.numel():
        v, w = v.clone(), w.clone()
        v[bad], w[bad] = _clamped_eigh(gram[bad], jitter)
    return GramFactor(
        gram=gram,
        chol=torch.where(ok[:, None, None], cand, _eye_like(gram)),
        eigvecs=v,
        eigvals=w,
        exact=ok,
        n_updates=factor.n_updates + 1,
        n_refactors=factor.n_refactors + (~ok).to(torch.int32),
        needs_repair=torch.zeros_like(factor.needs_repair),
    )


def factor_update_deferred(factor: GramFactor, traj_new: Trajectory, hyper: GPHyper, k: int,
                           old_count: torch.Tensor) -> GramFactor:
    """Branch-free Cholesky-only factor maintenance (no eigh, ever).

    A healthy candidate (border before the ring wraps, refresh after) is
    adopted; an unhealthy one raises ``needs_repair`` and the factor keeps
    its last-good state until the repair pass.
    """
    cap = traj_new.capacity
    if k > cap:
        raise ValueError(f"append event of {k} rows exceeds capacity {cap}")
    jitter = _jitter_of(hyper)
    mask = traj_new.valid_mask()
    gram = _gram_replace_rows(factor, traj_new, hyper, k, old_count)
    use_border = (old_count + k <= cap) & factor.exact & ~factor.needs_repair
    cand, info = _candidate(factor, gram, old_count, k, jitter, use_border)
    ok = _factor_health(cand, mask, jitter, info)
    adopt = ok & ~factor.needs_repair
    return GramFactor(
        gram=gram,
        chol=torch.where(adopt[:, None, None], cand, factor.chol),
        eigvecs=factor.eigvecs,
        eigvals=factor.eigvals,
        exact=factor.exact | adopt,
        n_updates=factor.n_updates + 1,
        n_refactors=factor.n_refactors,  # repairs are counted at the boundary
        needs_repair=factor.needs_repair | ~ok,
    )


def factor_repair_masked(factor: GramFactor, jitter: float) -> GramFactor:
    """Clamped-eigh repair of the flagged clients of a stacked factor."""
    v, w = _clamped_eigh(factor.gram, jitter)
    flag = factor.needs_repair
    return factor._replace(
        eigvecs=torch.where(flag[:, None, None], v.to(factor.eigvecs.dtype), factor.eigvecs),
        eigvals=torch.where(flag[:, None], w.to(factor.eigvals.dtype), factor.eigvals),
        exact=factor.exact & ~flag,
        n_refactors=factor.n_refactors + flag.to(torch.int32),
        needs_repair=torch.zeros_like(flag),
    )


def factor_repair_gated(factor: GramFactor, jitter: float) -> GramFactor:
    """``factor_repair_masked`` only when a flag is raised.  The reference
    decides on device under ``lax.cond``; eager torch reads the flag count
    on the host instead."""
    if int(factor.needs_repair.sum()) == 0:
        return factor
    return factor_repair_masked(factor, jitter)


def chol_solve(chol: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(L L^T)^-1 b for lower L, b (..., cap, m), by two triangular solves:
    ``torch.cholesky_solve``'s mathematics without its batched CUDA path
    (MAGMA's ``spotrs_batched``, which allocates device memory inside the
    call, so a CUDA graph capture refuses it)."""
    z = torch.linalg.solve_triangular(chol, b, upper=False)
    return torch.linalg.solve_triangular(chol.transpose(-1, -2), z, upper=True)


def factor_solve(factor: GramFactor, b: torch.Tensor) -> torch.Tensor:
    """(K + jitter)^-1 b, b (..., cap) or (..., cap, m), for a stacked or a
    single-client factor: through the Cholesky factor when ``exact`` and
    the clamped eigh factors otherwise."""
    vec = b.dim() == factor.gram.dim() - 1
    bb = b[..., None] if vec else b
    from_chol = chol_solve(factor.chol, bb)
    v, w = factor.eigvecs, factor.eigvals
    from_eigh = v @ ((v.transpose(-1, -2) @ bb) / w[..., None])
    out = torch.where(factor.exact[..., None, None], from_chol, from_eigh)
    return out[..., 0] if vec else out


def factor_inverse(factor: GramFactor) -> torch.Tensor:
    """Explicit (K + jitter)^-1, (..., cap, cap)."""
    eye = _eye_like(factor.gram)
    from_chol = chol_solve(factor.chol, eye)
    v, w = factor.eigvecs, factor.eigvals
    from_eigh = (v / w[..., None, :]) @ v.transpose(-1, -2)
    return torch.where(factor.exact[..., None, None], from_chol, from_eigh)


def traj_extend_clients(trajs: Trajectory, factors: GramFactor, xs: torch.Tensor,
                        ys: torch.Tensor, hyper: GPHyper,
                        deferred: bool = True) -> tuple[Trajectory, GramFactor]:
    """Append (N, k, d) / (N, k) queries and maintain the factors, with
    ``factor_update_deferred`` (the default: the port's main path) or, for
    ``deferred=False``, the inline ``factor_update``."""
    old_count = trajs.count
    traj2 = traj_append_batch(trajs, xs, ys)
    upd = factor_update_deferred if deferred else factor_update
    return traj2, upd(factors, traj2, hyper, xs.shape[1], old_count)


def gp_alpha_cached_clients(trajs: Trajectory, factors: GramFactor) -> torch.Tensor:
    """alpha = (K + s^2 I)^{-1} y per client, (N, cap)."""
    return factor_solve(factors, trajs.ys * trajs.valid_mask())


def _score_inputs(trajs: Trajectory, factors: GramFactor, xs_q: torch.Tensor):
    """The scoring kernels' inputs, stacked or for one client: candidates
    and trajectory in coordinates shifted to the candidate centroid
    (distances, hence the scores, are shift-invariant; the expansion's
    terms cancel less in f32 there, DESIGN.md Sec. 2.4), the masked
    inverse B and P = B o XX^T."""
    masks = trajs.valid_mask()
    binv = factor_inverse(factors) * (masks[..., :, None] * masks[..., None, :])
    c0 = torch.mean(xs_q, dim=-2, keepdim=True)
    xs_sh = (trajs.xs - c0) * masks[..., None]
    pmat = binv * (xs_sh @ xs_sh.transpose(-1, -2))
    return xs_q - c0, xs_sh, binv, pmat


def gp_alpha_cached(traj: Trajectory, factor: GramFactor, hyper: GPHyper) -> torch.Tensor:
    """alpha = (K + s^2 I)^{-1} y of one client through its cached factor: (cap,)."""
    del hyper  # the hyperparameters are in the factor
    return factor_solve(factor, traj.ys * traj.valid_mask())


def grad_mean_cached(traj: Trajectory, factor: GramFactor, hyper: GPHyper, x: torch.Tensor,
                     *, block_n: Optional[int] = None,
                     block_cap: Optional[int] = None) -> torch.Tensor:
    """Posterior gradient mean of one client at x (d,): one launch of the
    single-client kernel.  alpha is masked here: the eigh route does not
    leave exact zeros on padded slots."""
    alpha = gp_alpha_cached(traj, factor, hyper) * traj.valid_mask()
    return ops.grad_mean_batch(x[None], traj.xs, alpha, lengthscale=hyper.lengthscale,
                               block_n=block_n, block_cap=block_cap)[0]


def grad_uncertainty_batch_cached(traj: Trajectory, factor: GramFactor, hyper: GPHyper,
                                  xs_q: torch.Tensor, *, block_n: Optional[int] = None,
                                  block_cap: Optional[int] = None) -> torch.Tensor:
    """Uncertainty scores of one client's candidates (n, d) -> (n,): one
    launch of the single-client kernel, in centroid-shifted coordinates."""
    cands, xs_sh, binv, pmat = _score_inputs(traj, factor, xs_q)
    return ops.uncertainty_scores(cands, xs_sh, binv, pmat, lengthscale=hyper.lengthscale,
                                  prior=traj.dim / (hyper.lengthscale**2),
                                  block_n=block_n, block_cap=block_cap)


def select_active_queries_cached(deltas: torch.Tensor, traj: Trajectory, factor: GramFactor,
                                 hyper: GPHyper, center: torch.Tensor, n_select: int,
                                 lo: float = 0.0, hi: float = 1.0, *,
                                 block_n: Optional[int] = None,
                                 block_cap: Optional[int] = None) -> torch.Tensor:
    """The ``n_select`` most uncertain of one client's candidates
    ``center + deltas`` (deltas (n, d)), scored through its cached factor."""
    cands = torch.clamp(center + deltas, lo, hi)
    scores = grad_uncertainty_batch_cached(traj, factor, hyper, cands, block_n=block_n,
                                           block_cap=block_cap)
    return _top(scores, cands, n_select)


def grad_mean_cached_clients(trajs: Trajectory, factors: GramFactor, hyper: GPHyper,
                             xs: torch.Tensor, *, block_n: Optional[int] = None,
                             block_cap: Optional[int] = None) -> torch.Tensor:
    """Posterior gradient mean at one point per client: (N, d) -> (N, d)."""
    alpha = gp_alpha_cached_clients(trajs, factors)
    out = ops.grad_mean_clients(xs[:, None, :], trajs.xs, alpha, lengthscale=hyper.lengthscale,
                                block_n=block_n, block_cap=block_cap)
    return out[:, 0, :]


def grad_uncertainty_batch_cached_clients(trajs: Trajectory, factors: GramFactor,
                                          hyper: GPHyper, xs_q: torch.Tensor, *,
                                          block_n: Optional[int] = None,
                                          block_cap: Optional[int] = None) -> torch.Tensor:
    """Uncertainty scores of per-client candidates: (N, nc, d) -> (N, nc),
    one launch of the client-batched kernel (see ``_score_inputs``)."""
    cands, xs_sh, binv, pmat = _score_inputs(trajs, factors, xs_q)
    return ops.uncertainty_scores_clients(
        cands, xs_sh, binv, pmat, lengthscale=hyper.lengthscale,
        prior=trajs.dim / (hyper.lengthscale**2), block_n=block_n, block_cap=block_cap)


def select_active_queries_cached_clients(
    deltas: torch.Tensor,  # (N, nc, d) uniform draws in [-radius, radius]
    trajs: Trajectory,
    factors: GramFactor,
    hyper: GPHyper,
    centers: torch.Tensor,  # (N, d)
    n_select: int,
    lo: float = 0.0,
    hi: float = 1.0,
    *,
    block_n: Optional[int] = None,
    block_cap: Optional[int] = None,
) -> torch.Tensor:
    """The ``n_select`` most uncertain candidates around each center: (N, n_select, d)."""
    cands = torch.clamp(centers[:, None, :] + deltas, lo, hi)
    scores = grad_uncertainty_batch_cached_clients(
        trajs, factors, hyper, cands, block_n=block_n, block_cap=block_cap)
    return _top(scores, cands, n_select)
