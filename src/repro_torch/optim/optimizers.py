"""SGD / Adam / AdamW on tensors (port of ``repro.optim.optimizers``).

The port's engine keeps the parameters of all clients in one stacked
tensor, so each update is one batched expression.  ``AdamState.step`` is
either a scalar (every client steps in lockstep) or carries the leading
client axes; it broadcasts against the parameters from the left.

Adam's parameters may also be a (named) tuple of tensors, as the
reference's pytrees are (``MLPParams`` of ``core/model_objectives.py``, whose leaves
carry a leading victim axis): the moments then have the same structure,
and every leaf is updated by the single tensor's expressions.
"""

from __future__ import annotations

from typing import Any, Callable, NamedTuple, Optional

import torch
from torch.utils import _pytree as pytree


class AdamState(NamedTuple):
    mu: Any  # a tensor, or a tuple of tensors shaped as the parameters
    nu: Any
    step: torch.Tensor  # int32, () or the leading client axes


def _keep_dtype(p: torch.Tensor, new_p: torch.Tensor) -> torch.Tensor:
    """Updated tensor cast back to the PARAM dtype (bf16 params stay bf16;
    a no-op for f32)."""
    return new_p.to(p.dtype)


def _lead(v: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    return v.reshape(v.shape + (1,) * (like.dim() - v.dim()))


def sgd_init(params: torch.Tensor) -> None:
    del params
    return None


def sgd_update(state: None, grads: torch.Tensor, params: torch.Tensor, lr: float
               ) -> tuple[torch.Tensor, None]:
    return _keep_dtype(params, params - lr * grads), state


def adam_init(params) -> AdamState:
    """Zero moments shaped as ``params`` (a tensor or a tuple of tensors)."""
    leaf = pytree.tree_leaves(params)[0]
    return AdamState(
        mu=pytree.tree_map(torch.zeros_like, params),
        nu=pytree.tree_map(torch.zeros_like, params),
        step=torch.zeros((), dtype=torch.int32, device=leaf.device),
    )


def _moments(st: AdamState, grads, b1: float, b2: float):
    step = st.step + 1
    mu = pytree.tree_map(lambda m, g: b1 * m + (1 - b1) * g, st.mu, grads)
    nu = pytree.tree_map(lambda v, g: b2 * v + (1 - b2) * (g * g), st.nu, grads)
    bc1 = 1 - b1 ** step.to(torch.float32)
    bc2 = 1 - b2 ** step.to(torch.float32)
    return mu, nu, step, bc1, bc2


def adam_update(st: AdamState, grads, params, lr: float, b1: float = 0.9, b2: float = 0.999,
                eps: float = 1e-8) -> tuple[Any, AdamState]:
    mu, nu, step, bc1, bc2 = _moments(st, grads, b1, b2)
    new = pytree.tree_map(
        lambda p, m, v: _keep_dtype(
            p, p - lr * (m / _lead(bc1, m)) / (torch.sqrt(v / _lead(bc2, v)) + eps)),
        params, mu, nu)
    return new, AdamState(mu=mu, nu=nu, step=step)


def adamw_init(params: torch.Tensor) -> AdamState:
    return adam_init(params)


def adamw_update(st: AdamState, grads: torch.Tensor, params: torch.Tensor, lr: float,
                 b1: float = 0.9, b2: float = 0.95, eps: float = 1e-8,
                 weight_decay: float = 0.1) -> tuple[torch.Tensor, AdamState]:
    mu, nu, step, bc1, bc2 = _moments(st, grads, b1, b2)
    new = params - lr * ((mu / _lead(bc1, mu)) / (torch.sqrt(nu / _lead(bc2, nu)) + eps)
                         + weight_decay * params)
    return _keep_dtype(params, new), AdamState(mu=mu, nu=nu, step=step)


def make_optimizer(name: str) -> tuple[Callable[..., Optional[AdamState]], Callable[..., tuple]]:
    if name == "sgd":
        return sgd_init, sgd_update
    if name == "adam":
        return adam_init, adam_update
    if name == "adamw":
        return adamw_init, adamw_update
    raise ValueError(f"unknown optimizer {name!r}")
