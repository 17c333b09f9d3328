"""Partial participation: the client pool (port of ``repro.core.pool``,
DESIGN.md Sec. 9).

The paper's federated setting lets only a cohort of K << N clients take
part in a round.  The dense engine holds all N clients on the device; this
module holds them on the host and runs the existing chunk engine on K:

* ``sample_cohort``: the reference's cohort, bit for bit: ``fold_in(
  PRNGKey(seed), round)``, then ``jax.random.permutation`` of ``range(N)``
  (with ``jax_threefry_partitionable`` on: ``ceil(3 ln N / ln(2**32 - 1))``
  rounds of a key split, 32 random bits per element and a stable sort by
  them), its first K entries sorted.  It runs on the host in integers,
  on ``faults/injector.py``'s threefry, once per chunk.  K = N is
  ``range(N)``, so the pooled engine is then the dense engine bit for bit.
* ``ClientPool``: the N stacked ``ClientState`` rows as CPU tensors, and
  each client's generator state (the port's draws live in the run's
  ``ClientDraws``, not in the state).  ``gather`` lifts K rows onto the
  device in the layout the engine left them in (an eager chunk's
  arithmetic follows its inputs' strides; the objectives' rows keep
  theirs too) and ``scatter`` writes them back; a gather followed by a scatter of untouched rows changes no bit.
* ``run_pooled_rounds``: ``rounds.run_rounds`` with a gather and a scatter
  at every chunk boundary.  The cohort of the chunk that starts at round r
  is ``sample_cohort(cohort_seed, r, N, K)``, so a resumed or rolled-back
  run draws the same cohorts.  Its states, its generator states and its
  objectives' rows go into the same tensors every chunk: on the card one
  captured graph per chunk length serves every cohort (``graphs.COUNTS``:
  one capture per length, one replay per chunk).

The cohort's round is ``n_clients=K``'s, so its mean is over the live
members of the cohort, never over N: with faults, the masked,
participation-weighted mean of the fault engine; without, every member is
live and the round is the faults-free round over K.  (The reference runs
its masked round with a zero-rate ``FaultConfig()`` there, whose sum over
the live count is its dense mean bit for bit; the port's masked round is
not its faults-free round bit for bit, so the faults-free round keeps
K = N the dense engine bit for bit; ROADMAP Queue C.)  The fault schedule is built once over the N pool ids and read
by the cohort's ``client_id`` leaf.  Quarantined members are restarted
before they scatter back; a poisoned chunk is not scattered and rolls back
as ``rounds.run_rounds`` does, from the pool's ``pool-v1`` checkpoint
(``checkpoint/io.py``).  ``global_value_fn`` inside a chunk
sees the cohort's objectives (the cohort's estimate of F; the initial F
is the pool's).
"""

from __future__ import annotations

import dataclasses
import math
from functools import partial
from typing import Any, Optional

import numpy as np
import torch
from torch.utils import _pytree as pytree

from repro_torch.checkpoint import io as ckpt_io
from repro_torch.core import algorithms as alg
from repro_torch.core import graphs
from repro_torch.core import rounds as rounds_mod
from repro_torch.faults import injector

_M32 = 0xFFFFFFFF

# ---------------------------------------------------------------------------
# Cohort sampling
# ---------------------------------------------------------------------------


def _split2(key) -> tuple[tuple[int, int], tuple[int, int]]:
    """``jax.random.split(key)``: the keys of the counts (0, 0) and (0, 1)."""
    b1, b2 = injector.threefry2x32(key[0], key[1], 0, torch.tensor([0, 1], dtype=torch.int64))
    return (int(b1[0]), int(b2[0])), (int(b1[1]), int(b2[1]))


def permutation(key, n: int) -> torch.Tensor:
    """``jax.random.permutation(key, n)`` of a threefry key (two uint32
    words), as int64.  Each round sorts by 32 random bits per element
    (``_random_bits``: the xor of the two words hashed from the counts
    (0, i)) with a stable sort, as ``lax.sort_key_val``; two equal bits
    keep their order.  At N <= 256 one round runs and a tie in it comes
    with probability below 1e-5."""
    x = torch.arange(n, dtype=torch.int64)
    n_rounds = int(np.ceil(3 * np.log(max(1, n)) / np.log(np.iinfo(np.uint32).max)))
    for _ in range(n_rounds):
        key, sub = _split2(key)
        b1, b2 = injector.threefry2x32(sub[0], sub[1], 0, torch.arange(n, dtype=torch.int64))
        x = x[torch.sort(b1 ^ b2, stable=True).indices]
    return x


def sample_cohort(seed: int, round_idx: int, pool_size: int, cohort: int) -> np.ndarray:
    """The cohort of the chunk that starts at absolute round ``round_idx``:
    the first ``cohort`` entries of the permutation keyed
    ``fold_in(PRNGKey(seed), round_idx)``, sorted (pool order is batch
    order), as int64; ``range(pool_size)`` when ``cohort == pool_size``.
    The reference's, bit for bit (``tests/test_torch_pool.py``)."""
    if not 1 <= cohort <= pool_size:
        raise ValueError(f"cohort={cohort} must be in [1, pool_size={pool_size}]")
    if cohort == pool_size:
        return np.arange(pool_size, dtype=np.int64)
    key = injector.fold_in((0, int(seed) & _M32), int(round_idx) & _M32)
    perm = permutation(key, pool_size).numpy()
    return np.sort(perm[:cohort]).astype(np.int64)


# ---------------------------------------------------------------------------
# The pool store
# ---------------------------------------------------------------------------


def dim_order(t: torch.Tensor) -> Optional[list]:
    """The order of ``t``'s dimensions from the outermost in memory to the
    innermost (an objective's (N, d) weights may be a transposed array),
    or None when ``t`` is not dense (then a gather lays its rows out
    contiguously)."""
    if t.dim() == 0 or torch.empty_like(t, device="meta").stride() != t.stride():
        return None
    return sorted(range(t.dim()), key=lambda i: (-t.stride(i), i))


def empty_in_order(shape, order: Optional[list], dtype, device) -> torch.Tensor:
    """An empty tensor of ``shape`` with its dimensions laid out in
    ``order`` (``dim_order``'s; None: contiguous)."""
    if order is None:
        return torch.empty(shape, dtype=dtype, device=device)
    inverse = sorted(range(len(order)), key=order.__getitem__)
    return torch.empty([shape[i] for i in order], dtype=dtype, device=device).permute(inverse)


class ClientPool:
    """Host store of N stacked client states and their generator states.

    ``leaves`` are the state's tensor leaves in ``checkpoint.io``'s order,
    CPU tensors with leading axis N (a 0-d leaf, the optimizer's shared
    step counter, is kept as it is); ``draw_states`` the N clients'
    generator states, rows of a ``ClientDraws.state()``.
    """

    def __init__(self, states, draw_states: list, orders: Optional[list] = None):
        leaves, self.treedef_str = ckpt_io.tree_flatten(states)
        self._tree = states
        self._leaves = [t.detach().to("cpu", copy=True) for t in leaves]
        if any(t.dim() and t.shape[0] != self._leaves[0].shape[0] for t in self._leaves):
            raise ValueError("every pool leaf but the 0-d ones must stack the N clients")
        self._orders = list(orders) if orders is not None else [dim_order(t) for t in leaves]
        self.draw_states = [s.to("cpu", copy=True) for s in draw_states]
        if len(self.draw_states) != self.size:
            raise ValueError(f"{len(self.draw_states)} generator states for a pool of "
                             f"{self.size}")
        self._staging: dict = {}

    @property
    def size(self) -> int:
        return int(self._leaves[0].shape[0])

    @property
    def leaves(self) -> list:
        return self._leaves

    @property
    def orders(self) -> list:
        """Each leaf's ``dim_order`` as the engine last left it."""
        return self._orders

    def nbytes(self) -> int:
        """Host bytes of the pool: its leaves and its generator states."""
        return sum(t.numel() * t.element_size() for t in (*self._leaves, *self.draw_states))

    def load(self, leaves: list, draw_states: list, orders: Optional[list]) -> None:
        """Replace the pool's contents (a checkpoint's restore)."""
        if len(leaves) != len(self._leaves):
            raise ValueError(f"pool has {len(self._leaves)} leaves, got {len(leaves)}")
        for i, (old, new) in enumerate(zip(self._leaves, leaves)):
            if old.shape != new.shape or old.dtype != new.dtype:
                raise ValueError(f"pool leaf {i}: cannot load {tuple(new.shape)}/{new.dtype} "
                                 f"over {tuple(old.shape)}/{old.dtype}")
        self._leaves = [t.to("cpu", copy=True) for t in leaves]
        self.draw_states = [s.to("cpu", copy=True) for s in draw_states]
        if orders is not None:
            self._orders = list(orders)

    def gather(self, idx, device) -> alg.ClientState:
        """The rows ``idx`` on ``device``, each leaf in its layout.  On the
        card the rows are staged in pinned memory and copied without a host
        wait (the copies keep the stream's order)."""
        device = torch.device(device)
        idx_t = torch.as_tensor(np.asarray(idx), dtype=torch.int64)
        k = int(idx_t.numel())
        out = []
        for i, (leaf, order) in enumerate(zip(self._leaves, self._orders)):
            if leaf.dim() == 0:
                out.append(leaf.to(device))
                continue
            shape = (k, *leaf.shape[1:])
            dst = empty_in_order(shape, order, leaf.dtype, device)
            if device.type == "cuda":
                stage = self._staging.get(("in", i, k))
                if stage is None:
                    stage = self._staging[("in", i, k)] = torch.empty(shape, dtype=leaf.dtype,
                                                                      pin_memory=True)
                torch.index_select(leaf, 0, idx_t, out=stage)
                dst.copy_(stage, non_blocking=True)
            else:
                dst.copy_(leaf.index_select(0, idx_t))
            out.append(dst)
        return ckpt_io.tree_unflatten(self._tree, out)

    def gather_draws(self, idx) -> list:
        return [self.draw_states[int(i)] for i in np.asarray(idx)]

    def scatter(self, idx, states, draw_states=None) -> None:
        """Write the cohort's state back into rows ``idx`` (and its
        generator states, where given), keeping its layout.  From the card
        the rows come through pinned memory, with one wait for them all."""
        leaves, treedef = ckpt_io.tree_flatten(states)
        if treedef != self.treedef_str:
            raise ValueError("scatter: the cohort's state structure does not match the pool "
                             f"({treedef} vs {self.treedef_str})")
        idx_t = torch.as_tensor(np.asarray(idx), dtype=torch.int64)
        rows = []
        for i, (dst, src) in enumerate(zip(self._leaves, leaves)):
            if src.shape[1:] != dst.shape[1:] or src.dtype != dst.dtype:
                raise ValueError(f"scatter: leaf {i} is {tuple(src.shape[1:])}/{src.dtype}, "
                                 f"the pool holds {tuple(dst.shape[1:])}/{dst.dtype}")
            if src.is_cuda and dst.dim():
                # into pinned memory without a host wait; one wait for all
                key = ("out", i, src.shape[0])
                stage = self._staging.get(key)
                if stage is None:
                    stage = self._staging[key] = torch.empty(src.shape, dtype=src.dtype,
                                                             pin_memory=True)
                rows.append(stage.copy_(src.detach(), non_blocking=True))
            else:
                rows.append(src.detach().to("cpu"))
        if any(src.is_cuda for src in leaves):
            torch.cuda.current_stream(leaves[0].device).synchronize()
        for i, (dst, src, row) in enumerate(zip(self._leaves, leaves, rows)):
            if dst.dim() == 0:
                self._leaves[i] = row.clone()
                continue
            dst.index_copy_(0, idx_t, row)
            self._orders[i] = dim_order(src)
        for j, st in zip(np.asarray(idx), draw_states or ()):
            self.draw_states[int(j)] = st.to("cpu", copy=True)


def init_pool(cfg: alg.AlgoConfig, x0: torch.Tensor, seed: int = 0,
              batch: Optional[int] = None) -> ClientPool:
    """A pool of ``cfg.n_clients`` fresh clients, built on ``x0``'s device
    ``batch`` clients at a time and kept on the host; client i's generator
    state is ``ClientDraws(seed, ...)``'s for client i.  ``batch=None``
    builds all N in one go, bit for bit ``init_states`` (the dense
    engine's init); a smaller ``batch`` bounds the device memory of the
    build and gives the same bits."""
    n, dev = cfg.n_clients, x0.device
    batch = n if batch is None else batch
    if batch < 1:
        raise ValueError(f"batch={batch} must be >= 1")
    pool = None
    for lo in range(0, n, batch):
        hi = min(lo + batch, n)
        block = alg.init_states(dataclasses.replace(cfg, n_clients=hi - lo), x0)
        block = block._replace(client_id=torch.arange(lo, hi, dtype=torch.int32, device=dev))
        if pool is None:
            full = pytree.tree_map_only(
                torch.Tensor, lambda t: t if t.dim() == 0 else
                torch.empty((n, *t.shape[1:]), dtype=t.dtype), block)
            gens = [alg.client_generator(seed, i, dev).get_state() for i in range(n)]
            pool = ClientPool(full, gens, [dim_order(t) for t in ckpt_io.tree_flatten(block)[0]])
        pool.scatter(np.arange(lo, hi), block)
    return pool


# ---------------------------------------------------------------------------
# The pooled rounds
# ---------------------------------------------------------------------------


def _gather_cobjs(cobjs_host, idx, n: int, device):
    """The cohort's rows of the stacked per-client objectives, each leaf in
    its layout."""
    idx_t = torch.as_tensor(np.asarray(idx), dtype=torch.int64)

    def one(t):
        if t.dim() == 0 or t.shape[0] != n:
            raise ValueError(f"cobjs leaf has leading axis {tuple(t.shape)[:1]}, expected the "
                             f"pool size {n} (per-client objectives must stack over N)")
        out = empty_in_order((idx_t.numel(), *t.shape[1:]), dim_order(t), t.dtype, device)
        return out.copy_(t.index_select(0, idx_t))

    return pytree.tree_map_only(torch.Tensor, one, cobjs_host)


def run_pooled_rounds(cfg, rff, query_fn, cobjs, pool: ClientPool, x0: torch.Tensor,
                      global_value_fn, rounds: int, chunk: int, *, cohort: int,
                      cohort_seed: int = 0, draws, diag_global_grad=None,
                      checkpoint_dir: Optional[str] = None, checkpoint_every: int = 1,
                      eval_every: int = 1, async_checkpoint: bool = True,
                      faults: Optional[injector.FaultConfig] = None, max_rollbacks: int = 3,
                      identity: Optional[dict] = None):
    """Run ``rounds`` rounds with K-of-N partial participation; returns
    ``(pool, history)``.

    At each chunk boundary the cohort of the chunk's first round is
    gathered (its states, its generator states into ``draws``, whose K
    generators then draw for it, and its objectives' rows), the chunk
    engine of ``rounds.chunk_fn`` runs on it with ``n_clients=K``, the
    deferred engine's flagged members are repaired, quarantined members
    restarted, and the cohort is scattered back.  Checkpoints, resume, the
    fallback past corrupt steps and chunk rollback follow
    ``rounds.run_rounds``, on the ``pool-v1`` layout; the run's identity
    adds the pool's size, the cohort and its seed.
    """
    if rounds < 0:
        raise ValueError(f"rounds must be >= 0, got {rounds}")
    if chunk < 1:
        raise ValueError("run_pooled_rounds requires chunk >= 1 (the pooled engine has no "
                         "per-round loop; the dense engine at K = N is its oracle)")
    if eval_every < 1:
        raise ValueError(f"eval_every must be >= 1, got {eval_every}")
    if cfg.n_clients != pool.size:
        raise ValueError(f"cfg.n_clients={cfg.n_clients} must equal the pool size {pool.size} "
                         "(the pool is the client population)")
    if not 1 <= cohort <= pool.size:
        raise ValueError(f"cohort={cohort} must be in [1, pool_size={pool.size}]")
    chunk = min(chunk, max(rounds, 1))
    dev = x0.device
    n = pool.size
    ccfg = dataclasses.replace(cfg, n_clients=cohort)
    fcfg = injector.effective_config(faults, rounds)
    run_meta = rounds_mod.run_identity(
        rounds, chunk, cfg, eval_every, fcfg,
        dict(identity or {}, pool_size=n, cohort=cohort, cohort_seed=cohort_seed))
    cobjs_host = pytree.tree_map_only(torch.Tensor, lambda t: t.detach().cpu(), cobjs)

    def restore(step):
        hist_like = rounds_mod.history_init(rounds, x0, torch.zeros((), dtype=torch.float32))
        head = draws.state()[0]
        rows = torch.stack(pool.draw_states)
        leaves, hist, got, orders, start = ckpt_io.restore_pool_state(
            checkpoint_dir, pool.leaves, hist_like, step=step, draws_like=[head, rows])
        return leaves, hist, got, orders, min(start, rounds)

    def restore_newest():
        got = rounds_mod.newest_good(checkpoint_dir, run_meta, restore, "pool")
        if got is None:
            return None, 0
        leaves, hist, (head, rows), orders, start = got
        pool.load(leaves, list(rows.unbind(0)), orders)
        draws.load_state([head, *pool.draw_states[:cohort]])
        return hist, start

    start, hist = 0, None
    if checkpoint_dir and ckpt_io.latest_step(checkpoint_dir) is not None:
        hist, start = restore_newest()
    if hist is None:
        hist = rounds_mod.history_init(rounds, x0, global_value_fn(cobjs, x0))
    sx = hist.xs[start]

    # the cohort's objectives: one set of K-row buffers the chunks close over
    c_cobjs = _gather_cobjs(cobjs_host, sample_cohort(cohort_seed, start, n, cohort), n, dev)

    def engine(done):
        """(reset, chunk maker, captured chunks) of ``fcfg``."""
        schedule = reset = None
        if fcfg is not None:
            schedule = injector.FaultSchedule(fcfg, rounds, n, dev)
            if fcfg.tolerate:
                reset = alg.make_quarantine_reset(ccfg, dev)
        make = lambda k, d: rounds_mod.chunk_fn(ccfg, rff, query_fn, c_cobjs, d,
                                                global_value_fn, diag_global_grad, k,
                                                eval_every, rounds, faults=schedule)
        captured = None
        if rounds > done and graphs.captures(ccfg, draws, dev):
            idx = sample_cohort(cohort_seed, done, n, cohort)
            captured = graphs.CapturedChunks(make, draws, pool.gather(idx, dev), sx)
        return reset, make, captured

    reset, make, captured = engine(start)
    writer = ckpt_io.AsyncCheckpointWriter() if checkpoint_dir and async_checkpoint else None

    def snapshot():
        return ckpt_io.prepare_pool_state(pool.leaves, pool.treedef_str, 0, n,
                                          hist, [draws.state()[0], torch.stack(pool.draw_states)],
                                          pool.orders)

    if fcfg is not None and checkpoint_dir and ckpt_io.latest_step(checkpoint_dir) is None:
        # the insurance: a restore target before the first faulted chunk
        ckpt_io.write_round_state(checkpoint_dir, start, snapshot(), run_meta)
    done, chunks_done, rollbacks = start, 0, 0
    try:
        while done < rounds:
            k = min(chunk, rounds - done)
            idx = sample_cohort(cohort_seed, done, n, cohort)
            cstates = pool.gather(idx, dev)
            # the cohort's generator states into the run's K generators; the
            # source keeps its own (the RFF bank's)
            draws.load_state([draws.state()[0], *pool.gather_draws(idx)])
            graphs.copy_into(c_cobjs, _gather_cobjs(cobjs_host, idx, n, dev))
            if captured is not None:
                captured.load(cstates, sx)
                ys = captured.run(k, done)
                cstates, sx = captured.states, captured.sx
            else:
                offset = torch.full((), done, dtype=torch.int64, device=dev)
                cstates, sx, ys = make(k, draws)(cstates, sx, offset)
            rounds_mod.hist_write(hist, ys, done)
            done += k
            chunks_done += 1
            ok = wrote = True
            if fcfg is not None:
                read = torch.cat([torch.isfinite(sx).all()[None], cstates.quarantined]).cpu()
                ok = bool(read[0])
            if ok:
                cstates, _ = rounds_mod.repair_flagged_clients(cstates, ccfg)
                if reset is not None and bool(read[1:].any()):
                    # a member never goes back into the pool quarantined
                    cstates = reset(cstates, sx)
                pool.scatter(idx, cstates, draws.state()[1:])
                if checkpoint_dir and (chunks_done % max(checkpoint_every, 1) == 0
                                       or done == rounds):
                    wrote = rounds_mod.write_boundary(
                        writer, partial(ckpt_io.write_round_state, checkpoint_dir, done,
                                        snapshot(), run_meta),
                        done >= rounds, fcfg is not None, done, "pool")
            if ok and wrote:
                continue
            reason = "non-finite server iterate" if not ok else "checkpoint write failure"
            rollbacks = rounds_mod.rollback_or_raise(reason, done, checkpoint_dir, rollbacks,
                                                     max_rollbacks, writer, "pool")
            r_hist, r_start = restore_newest()
            if r_hist is None:
                raise rounds_mod.nothing_to_restore(done, checkpoint_dir)
            hist, done = r_hist, r_start
            sx = hist.xs[done]
            chunks_done = 0
            if not fcfg.tolerate:
                fcfg = rounds_mod.tolerant(fcfg, "pool")
                reset, make, captured = engine(done)
    finally:
        if writer is not None:
            writer.wait()
    return pool, hist
