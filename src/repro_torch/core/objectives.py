"""Federated black-box objectives (port of ``repro.core.objectives``).

The heterogeneous quadratics of paper Appx. E.1:

    f_i(x) = 1/(10 d) * ( sum_j [ (1 + C (a_j^i - 1/N)) xr_j^2
                                 + (1 + C (b_j^i - 1/N)) xr_j ] + 1 ),
    xr in [-10, 10]^d,  a_j, b_j ~ Dir(1/N * 1) across clients,

so F(x) = mean_i f_i(x) = 1/(10d) (sum_j xr_j^2 + xr_j + 1) whatever C is;
and the non-convex sinquad family,

    f_i(x) = sum_j wa_j^i xr_j^2 / d + (0.1 C / d) sum_j sin(3 xr_j + phase_j^i),
    xr in [-2, 2]^d,  wa^i = 1 + C (a^i - 1/N),  phase ~ U[0, 2 pi).

Per-client parameters are stacked along a leading client axis N.  Points
passed to ``quadratic_value``/``quadratic_query`` carry the same leading
axis: ``xs`` is (N, ..., d), one batch of points per client.  The query
noise is an argument (standard-normal draws of shape (N, ...)), so the
engine's draw source decides where it comes from.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from repro_torch.device import resolve_device


class QuadraticClient(NamedTuple):
    a: torch.Tensor  # (N, d) Dirichlet weights for the quadratic term
    b: torch.Tensor  # (N, d) Dirichlet weights for the linear term
    c_het: torch.Tensor  # (N,) heterogeneity constant C
    n_clients: torch.Tensor  # (N,) float N
    noise_std: torch.Tensor  # (N,) observation noise sigma


def make_quadratic(
    seed: int,
    n_clients: int,
    dim: int,
    c_het: float,
    noise_std: float = 0.01,
    device: str | torch.device = "cuda",
) -> QuadraticClient:
    """Stacked per-client params; the Dirichlet draws come from numpy(seed)."""
    device = resolve_device(device)
    rng = np.random.default_rng(seed)
    alpha = np.full((n_clients,), 1.0 / n_clients)
    a = rng.dirichlet(alpha, size=dim).T  # (N, d)
    b = rng.dirichlet(alpha, size=dim).T
    rep = lambda v: torch.full((n_clients,), v, dtype=torch.float32, device=device)
    as_t = lambda v: torch.as_tensor(v, dtype=torch.float32).to(device)
    return QuadraticClient(
        a=as_t(a), b=as_t(b), c_het=rep(c_het), n_clients=rep(float(n_clients)),
        noise_std=rep(noise_std),
    )


def _to_raw(x_unit: torch.Tensor) -> torch.Tensor:
    return 20.0 * x_unit - 10.0  # [0,1] -> [-10,10]


def _lead(v: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    """Reshape a per-client tensor (N,) or (N, d) to broadcast against
    ``like`` (N, ..., d) or (N, ...)."""
    extra = like.dim() - v.dim()
    if v.dim() == 2:  # (N, d): insert the point axes before d
        return v.reshape(v.shape[:1] + (1,) * extra + v.shape[1:])
    return v.reshape(v.shape + (1,) * extra)


def _weights(cp: QuadraticClient, xr: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    c = _lead(cp.c_het, cp.a)
    inv_n = 1.0 / _lead(cp.n_clients, cp.a)
    wa = 1.0 + c * (cp.a - inv_n)
    wb = 1.0 + c * (cp.b - inv_n)
    return _lead(wa, xr), _lead(wb, xr)


def quadratic_value(cp: QuadraticClient, x_unit: torch.Tensor) -> torch.Tensor:
    """f_i at per-client points: (N, ..., d) -> (N, ...)."""
    xr = _to_raw(x_unit)
    d = xr.shape[-1]
    wa, wb = _weights(cp, xr)
    return (torch.sum(wa * xr * xr + wb * xr, dim=-1) + 1.0) / (10.0 * d)


def quadratic_grad(cp: QuadraticClient, x_unit: torch.Tensor) -> torch.Tensor:
    """Exact grad wrt the unit-domain x (chain rule factor 20): (N, ..., d)."""
    xr = _to_raw(x_unit)
    d = xr.shape[-1]
    wa, wb = _weights(cp, xr)
    return 20.0 * (2.0 * wa * xr + wb) / (10.0 * d)


def quadratic_query(cp: QuadraticClient, x_unit: torch.Tensor, z: torch.Tensor) -> torch.Tensor:
    """Noisy query y = f_i(x) + sigma_i z with z ~ N(0, 1): (N, ..., d) -> (N, ...)."""
    return quadratic_value(cp, x_unit) + _lead(cp.noise_std, z) * z


def quadratic_global_value(cps: QuadraticClient, x_unit: torch.Tensor) -> torch.Tensor:
    """F(x) = mean_i f_i(x) at one point x (d,) -> ()."""
    n = cps.a.shape[0]
    return torch.mean(quadratic_value(cps, x_unit.expand(n, -1)))


def quadratic_global_grad(cps: QuadraticClient, x_unit: torch.Tensor) -> torch.Tensor:
    n = cps.a.shape[0]
    return torch.mean(quadratic_grad(cps, x_unit.expand(n, -1)), dim=0)


def quadratic_fstar(dim: int) -> float:
    """F at the optimum xr_j = -1/2: (d*(-1/4) + 1)/(10 d)."""
    return float((-0.25 * dim + 1.0) / (10.0 * dim))


class SinQuadClient(NamedTuple):
    a: torch.Tensor  # (N, d) Dirichlet weights
    phase: torch.Tensor  # (N, d) ripple phases
    c_het: torch.Tensor  # (N,)
    n_clients: torch.Tensor  # (N,)
    noise_std: torch.Tensor  # (N,)


def make_sinquad(
    seed: int,
    n_clients: int,
    dim: int,
    c_het: float,
    noise_std: float = 0.01,
    device: str | torch.device = "cuda",
) -> SinQuadClient:
    """Stacked per-client params; the Dirichlet and phase draws come from numpy(seed)."""
    device = resolve_device(device)
    rng = np.random.default_rng(seed)
    a = rng.dirichlet(np.full((n_clients,), 1.0 / n_clients), size=dim).T  # (N, d)
    phase = rng.uniform(0.0, 2.0 * np.pi, size=(n_clients, dim))
    rep = lambda v: torch.full((n_clients,), v, dtype=torch.float32, device=device)
    as_t = lambda v: torch.as_tensor(v, dtype=torch.float32).to(device)
    return SinQuadClient(a=as_t(a), phase=as_t(phase), c_het=rep(c_het),
                         n_clients=rep(float(n_clients)), noise_std=rep(noise_std))


def _sinquad_terms(cp: SinQuadClient, x_unit: torch.Tensor):
    xr = 4.0 * x_unit - 2.0  # [0,1] -> [-2,2]
    d = xr.shape[-1]
    c = _lead(cp.c_het, cp.a)
    wa = _lead(1.0 + c * (cp.a - 1.0 / _lead(cp.n_clients, cp.a)), xr)
    ripple = _lead(0.1 * cp.c_het / max(d, 1), xr[..., 0])[..., None]
    return xr, d, wa, _lead(cp.phase, xr), ripple


def sinquad_value(cp: SinQuadClient, x_unit: torch.Tensor) -> torch.Tensor:
    """f_i at per-client points: (N, ..., d) -> (N, ...)."""
    xr, d, wa, phase, ripple = _sinquad_terms(cp, x_unit)
    return torch.sum(wa * xr * xr / d + ripple * torch.sin(3.0 * xr + phase), dim=-1)


def sinquad_grad(cp: SinQuadClient, x_unit: torch.Tensor) -> torch.Tensor:
    """Exact grad wrt the unit-domain x (chain rule factor 4): (N, ..., d)."""
    xr, d, wa, phase, ripple = _sinquad_terms(cp, x_unit)
    return 4.0 * (2.0 * wa * xr / d + 3.0 * ripple * torch.cos(3.0 * xr + phase))


def sinquad_query(cp: SinQuadClient, x_unit: torch.Tensor, z: torch.Tensor) -> torch.Tensor:
    """Noisy query y = f_i(x) + sigma_i z with z ~ N(0, 1): (N, ..., d) -> (N, ...)."""
    return sinquad_value(cp, x_unit) + _lead(cp.noise_std, z) * z


def sinquad_global_value(cps: SinQuadClient, x_unit: torch.Tensor) -> torch.Tensor:
    """F(x) = mean_i f_i(x) at one point x (d,) -> ()."""
    return torch.mean(sinquad_value(cps, x_unit.expand(cps.a.shape[0], -1)))


def sinquad_global_grad(cps: SinQuadClient, x_unit: torch.Tensor) -> torch.Tensor:
    return torch.mean(sinquad_grad(cps, x_unit.expand(cps.a.shape[0], -1)), dim=0)
