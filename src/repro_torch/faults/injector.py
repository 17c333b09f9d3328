"""Deterministic fault schedule (port of ``repro.faults.injector``).

The schedule is a pure function of ``(FaultConfig.seed, round, client_id,
kind)``: as in the reference, each draw is

    bernoulli(fold_in(fold_in(fold_in(PRNGKey(seed), round), client), kind), rate)

with the kind tags 0 drop, 1 straggle, 2 nan, 3 inf.  This module computes
those threefry-2x32 hashes itself, with integer tensor operations (each
uint32 word carried in an int64 tensor), the way ``jax.random`` computes
them with ``jax_threefry_partitionable`` on and 64-bit types off: a seed
keys ``(0, seed mod 2**32)``; ``fold_in(key, data)`` hashes the count
words ``(0, data)`` under ``key``; a scalar draw hashes ``(0, 0)`` and
takes the xor of the two output words; ``uniform`` keeps its top 23 bits
m as the mantissa of a float32 in [1, 2) less 1, which is m / 2**23
exactly; ``bernoulli`` is ``uniform < rate`` with the rate rounded to
float32, so here ``m < ceil(rate32 * 2**23)``, in integers.  So the port's
schedule is the reference's, bit for bit (``tests/test_torch_faults.py``),
and it depends on no topology: client identity is the
``ClientState.client_id`` leaf.

Fault kinds (each an independent Bernoulli per round x client; a dropped
client cannot also straggle or send a payload, and nan wins over inf):

* ``drop``: the client misses the round (no update, no queries);
* ``straggle``: its update arrives too late, the server sees the round's
  broadcast iterate and the client's state does not advance;
* ``nan`` / ``inf``: its update payload is poisoned with non-finite values.

A rate of 0 draws nothing for that kind, and the window
``[first_round, last_round)`` of absolute rounds gates every draw.

Two ways to read the schedule on the device, both free of host reads, so
either can run inside a captured CUDA graph:

* ``draw_faults(fcfg, round_idx, client_ids)``: one round, from the round
  index as a 0-d tensor: two hashes of the client batch, and two more for
  each kind whose rate is above 0;
* ``FaultSchedule(fcfg, rounds, n_clients, device)``: every round of a
  run over the client ids ``0..n_clients-1``, hashed once when it is
  built; ``draw(round_idx, client_ids)`` then reads one round's columns of
  the batch's ids with two index operations.  The round engine's loop and
  chunks, dense or pooled, read this one.

``schedule_table`` is the host's (rounds, N) view of the same draws.
"""

from __future__ import annotations

import dataclasses
import math
import struct
from typing import NamedTuple, Optional

import torch

#: fold_in tags per fault kind: disjoint streams off the per-(round,
#: client) key, so enabling one kind never moves another's draws.
KINDS = ("drop", "straggle", "nan", "inf")

_M32 = 0xFFFFFFFF
_PARITY = 0x1BD11BDA
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))


@dataclasses.dataclass(frozen=True)
class FaultConfig:
    """Static fault schedule; its ``repr`` is the reference's for the same
    arguments (a checkpoint's run identity holds it).

    ``first_round``/``last_round`` window the injection on the absolute
    round index (half-open; ``last_round=None`` runs to the end).
    ``tolerate=True`` turns on the engine's masking and quarantine;
    ``tolerate=False`` injects without them, so one poisoned client
    poisons the dense mean.
    """

    seed: int = 0
    drop_rate: float = 0.0
    straggle_rate: float = 0.0
    nan_rate: float = 0.0
    inf_rate: float = 0.0
    first_round: int = 0
    last_round: Optional[int] = None
    tolerate: bool = True

    def __post_init__(self):
        for field in ("drop_rate", "straggle_rate", "nan_rate", "inf_rate"):
            v = getattr(self, field)
            if not 0.0 <= v <= 1.0:
                raise ValueError(f"{field}={v} outside [0, 1]")

    @property
    def rates(self) -> tuple:
        """The four rates in the order of ``KINDS``."""
        return (self.drop_rate, self.straggle_rate, self.nan_rate, self.inf_rate)

    @property
    def injects(self) -> bool:
        """True when a kind can ever fire: a rate above 0 and a window that
        is not empty by construction (``last_round <= first_round``)."""
        if self.last_round is not None and self.last_round <= self.first_round:
            return False
        return any(r > 0 for r in self.rates)

    def active_in(self, rounds: int, start: int = 0) -> bool:
        """True when the window meets the run's rounds ``[start, rounds)``."""
        if not self.injects:
            return False
        if self.first_round >= rounds:
            return False
        if self.last_round is not None and self.last_round <= max(start, 0):
            return False
        return True


def effective_config(fcfg: Optional[FaultConfig], rounds: int) -> Optional[FaultConfig]:
    """The config a ``rounds``-round run runs with: one that can never fire
    inside ``[0, rounds)`` becomes None (the faults-free engine, bit for
    bit).  A config with every rate 0 passes unchanged: it asks for the
    masked engine with nothing injected."""
    if fcfg is None or not fcfg.injects:
        return fcfg
    return fcfg if fcfg.active_in(rounds) else None


class FaultDraw(NamedTuple):
    """Per-client fault indicators for one round (bool, shape (N,))."""

    drop: torch.Tensor
    straggle: torch.Tensor
    nan: torch.Tensor
    inf: torch.Tensor


def threefry2x32(k1, k2, x1, x2):
    """The Threefry-2x32 block cipher (20 rounds) of ``jax.random``: key
    words (k1, k2) and count words (x1, x2), each a uint32 value in an
    int64 tensor or a Python int (broadcast); returns the output words."""
    ks = (k1, k2, k1 ^ k2 ^ _PARITY)
    x1 = (x1 + ks[0]) & _M32
    x2 = (x2 + ks[1]) & _M32
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x1 = (x1 + x2) & _M32
            x2 = x1 ^ (((x2 << r) & _M32) | (x2 >> (32 - r)))
        x1 = (x1 + ks[(i + 1) % 3]) & _M32
        x2 = (x2 + ks[(i + 2) % 3] + (i + 1)) & _M32
    return x1, x2


def fold_in(key, data):
    """``jax.random.fold_in``: the key of ``data`` (uint32 words) under ``key``."""
    return threefry2x32(key[0], key[1], 0, data)


def mantissa(key):
    """The 23 bits of ``jax.random.uniform(key, (), float32)`` of every key
    of the batch: the uniform draw is this integer over 2**23."""
    b1, b2 = threefry2x32(key[0], key[1], 0, 0)
    return (b1 ^ b2) >> 9


def threshold(rate: float) -> int:
    """The least mantissa that ``bernoulli`` at ``rate`` rejects:
    ``m / 2**23 < rate32`` exactly when ``m < threshold(rate)``, rate32
    being the rate rounded to float32 (as the reference compares)."""
    rate32 = struct.unpack("f", struct.pack("f", rate))[0]
    return math.ceil(rate32 * 2**23)


def _draws(fcfg: FaultConfig, rounds: torch.Tensor, client_ids: torch.Tensor) -> FaultDraw:
    """The draws of every (round, client) pair of the broadcast of
    ``rounds`` and ``client_ids`` (integer tensors), window not applied.
    Every constant enters as a Python scalar: no copy from the host."""
    r = rounds.to(torch.int64) & _M32
    c = client_ids.to(torch.int64) & _M32
    base = fold_in(fold_in((0, fcfg.seed & _M32), r), c)
    shape = torch.broadcast_shapes(r.shape, c.shape)
    drop, straggle, nan, inf = (
        mantissa(fold_in(base, tag)) < threshold(rate) if rate > 0
        else torch.zeros(shape, dtype=torch.bool, device=c.device)
        for tag, rate in enumerate(fcfg.rates))
    return FaultDraw(drop=drop, straggle=straggle & ~drop, nan=nan & ~drop,
                     inf=inf & ~drop & ~nan)


def _gate(fcfg: FaultConfig, draws: FaultDraw, rounds: torch.Tensor) -> FaultDraw:
    """The draws outside ``[first_round, last_round)`` cleared."""
    if fcfg.first_round <= 0 and fcfg.last_round is None:
        return draws
    active = rounds >= fcfg.first_round
    if fcfg.last_round is not None:
        active = active & (rounds < fcfg.last_round)
    return FaultDraw(*(m & active for m in draws))


def draw_faults(fcfg: FaultConfig, round_idx: torch.Tensor, client_ids: torch.Tensor
                ) -> FaultDraw:
    """Fault indicators of one round over a batch of clients.

    ``round_idx`` is the absolute 0-based round, a 0-d integer tensor on the
    clients' device; ``client_ids`` the (N,) identity leaf of the stacked
    ``ClientState``.  Deterministic in (seed, round, client) and
    independent of batch order; no host read."""
    round_idx = torch.as_tensor(round_idx, device=client_ids.device)
    return _gate(fcfg, _draws(fcfg, round_idx, client_ids), round_idx)


class FaultSchedule:
    """A run's fault draws for rounds ``[0, rounds)`` and the client ids
    ``0..n_clients-1`` (on ``device``), hashed once: ``table`` is (4,
    rounds, n_clients) bool in the order of ``KINDS``, equal to
    ``draw_faults`` round by round.  ``draw(round_idx, client_ids)`` reads
    one round from a 0-d index tensor and the columns of the batch's
    ``client_id`` leaf, so a captured graph reads the round it is replayed
    at and the clients in its static buffers: the dense engine's ids
    ``0..N-1``, or a pool's cohort."""

    def __init__(self, config: FaultConfig, rounds: int, n_clients: int, device="cpu"):
        self.config = config
        rs = torch.arange(rounds, dtype=torch.int64, device=device)[:, None]
        ids = torch.arange(n_clients, dtype=torch.int64, device=device)[None, :]
        self.table = torch.stack(tuple(_gate(config, _draws(config, rs, ids), rs)))

    def draw(self, round_idx: torch.Tensor, client_ids: torch.Tensor) -> FaultDraw:
        rows = self.table.index_select(1, round_idx.reshape(1).to(torch.int64))
        rows = rows.index_select(2, client_ids.to(torch.int64))
        return FaultDraw(*rows[:, 0].unbind(0))


def schedule_table(fcfg: FaultConfig, rounds: int, n_clients: int) -> dict:
    """Host-side (rounds, N) view of the schedule per kind: a dict of numpy
    bool arrays keyed by ``KINDS``, computed with the draws the engine
    reads."""
    table = FaultSchedule(fcfg, rounds, n_clients).table
    return {k: table[i].numpy().astype(bool) for i, k in enumerate(KINDS)}
