"""Carry parameters and state across from the JAX reference.

The reference's pytrees are handed over as numpy arrays (for example
``jax.tree_util.tree_map(np.asarray, state)``); the functions here read
them by field name, so this module needs neither JAX nor the reference
package, and return the port's tensors on the chosen device.  The
reference's per-client PRNG keys have no torch counterpart: a client's
generator is seeded from ``(seed, client_id)`` instead
(``core.algorithms.ClientDraws``).
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.core import algorithms as alg
from repro_torch.core import gp_surrogate as gp
from repro_torch.core import model_objectives as mobj
from repro_torch.core import objectives as obj
from repro_torch.core import rff as rfflib
from repro_torch.models.model import AttnCache, DecodeCache, SsmStack
from repro_torch.optim.optimizers import AdamState


def tensor(a, device) -> torch.Tensor:
    """A numpy array (or array-like) as a tensor of the same dtype.  A
    bfloat16 array (``ml_dtypes.bfloat16``, which ``torch.from_numpy``
    refuses) arrives bit for bit as ``torch.bfloat16``, through its 16-bit
    integer view."""
    arr = np.array(a, copy=True)
    if arr.dtype.name == "bfloat16":
        return torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16).to(device)
    return torch.from_numpy(arr).to(device)


def _fields(src, cls, device):
    return cls(*(tensor(getattr(src, f), device) for f in cls._fields))


def quadratic(src, device) -> obj.QuadraticClient:
    """A stacked reference ``QuadraticClient``."""
    return _fields(src, obj.QuadraticClient, device)


def sinquad(src, device) -> obj.SinQuadClient:
    """A stacked reference ``SinQuadClient``."""
    return _fields(src, obj.SinQuadClient, device)


def mlp_params(src, device) -> mobj.MLPParams:
    """A reference ``MLPParams`` (stacked or not)."""
    return _fields(src, mobj.MLPParams, device)


def attack_objective(src, device) -> mobj.AttackObjective:
    """A stacked reference ``AttackObjective``; the labels as int64, the
    port's index type."""
    return mobj.AttackObjective(
        victims=mlp_params(src.victims, device), z=tensor(src.z, device),
        label=tensor(src.label, device).long(), eps=tensor(src.eps, device),
        noise_std=tensor(src.noise_std, device))


def metric_objective(src, device) -> mobj.MetricObjective:
    """A stacked reference ``MetricObjective``; the labels as int64."""
    return mobj.MetricObjective(
        base=mlp_params(src.base, device), xs=tensor(src.xs, device),
        ys=tensor(src.ys, device).long(), scale=tensor(src.scale, device),
        noise_std=tensor(src.noise_std, device), n_classes=tensor(src.n_classes, device))


def lm_params(src, device) -> dict:
    """A reference model's flat parameter dict (``repro.models.init_params``)
    as the port's, leaf by leaf under the same names, in the same dtypes."""
    return {name: tensor(a, device) for name, a in src.items()}


def decode_cache(src, device) -> DecodeCache:
    """A reference ``DecodeCache`` (``repro.models.model``: its K/V, conv
    and state stacks, its cross K/V, its int32 position) as the port's:
    the same layouts leaf for leaf, in the same dtypes, ``pos`` a 0-d
    int64 tensor."""
    pair = lambda c: AttnCache(tensor(c.k, device), tensor(c.v, device))
    return DecodeCache(attn=pair(src.attn),
                       ssm=SsmStack(tensor(src.ssm.conv, device), tensor(src.ssm.state, device)),
                       cross=pair(src.cross), pos=tensor(src.pos, device).long().reshape(()))


def lm_objective(src, device) -> mobj.LMObjective:
    """A stacked reference ``LMObjective``; the tokens and labels as int64,
    the port's index type."""
    return mobj.LMObjective(
        batches_tokens=tensor(src.batches_tokens, device).long(),
        batches_labels=tensor(src.batches_labels, device).long(),
        scale=tensor(src.scale, device), noise_std=tensor(src.noise_std, device))


def rff(src, device) -> rfflib.RFFParams:
    """A reference ``RFFParams`` (the shared feature bank)."""
    return _fields(src, rfflib.RFFParams, device)


def trajectory(src, device) -> gp.Trajectory:
    """A stacked reference ``Trajectory``."""
    return _fields(src, gp.Trajectory, device)


def gram_factor(src, device) -> gp.GramFactor:
    """A stacked reference ``GramFactor``."""
    return _fields(src, gp.GramFactor, device)


def client_state(src, device) -> alg.ClientState:
    """A stacked reference ``ClientState`` with an Adam optimizer state
    (``opt.inner`` holds mu, nu and step).  The key is dropped."""
    inner = src.opt.inner
    t = lambda a: tensor(a, device)
    return alg.ClientState(
        x=t(src.x),
        traj=trajectory(src.traj, device),
        factor=gram_factor(src.factor, device),
        w_local=t(src.w_local),
        w_global=t(src.w_global),
        c_local=t(src.c_local),
        c_global=t(src.c_global),
        fd_bank=t(src.fd_bank),
        fd_accum=t(src.fd_accum),
        opt=AdamState(mu=t(inner.mu), nu=t(inner.nu), step=t(inner.step)),
        queries=t(src.queries),
        client_id=t(src.client_id),
        quarantined=t(src.quarantined),
    )


def client_draws(seed: int, client_ids, device) -> alg.ClientDraws:
    """The draw source of the given clients: generators seeded from
    ``(seed, client_id)``."""
    return alg.ClientDraws(seed, [int(i) for i in np.asarray(client_ids)], device)
