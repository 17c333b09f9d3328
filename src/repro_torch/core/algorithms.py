"""The federated round engines (port of ``repro.core.algorithms``, the
single-process ``simulate`` without cohorts).

Each round: T collective-free local steps for the whole client batch, one
mean of the iterates, then the round-end work and the second mean.  All
five algorithms of the reference run:

* fzoos: query the iterate, append it and maintain the Gram factor, score
  active-query candidates, query and append the picks, surrogate gradient
  mean + RFF correction (eq. 2/8), Adam; at round end active queries
  around the new server iterate, the eq. 6 RFF fit, the mean of w.  Three
  engines, as in the reference:

  - deferred (``use_factor_cache``, ``defer_repair``; the default):
    branch-free factor updates, one launch of the client-batched scoring
    and gradient-mean kernels per step for the whole batch, the Cholesky
    RFF fit; flagged factors are repaired between chunks of rounds
    (``core/rounds.py``), or between rounds in the loop;
  - per-client (``defer_repair=False``): the inline factor update with its
    clamped-eigh fallback, and per client one launch of the single-client
    scoring and gradient-mean kernels (N launches per step); the
    clamped-eigh RFF fit;
  - seed (``use_factor_cache=False``): the GP refactorized from scratch by
    eigh at every scoring and gradient, per client, in plain torch;

  ``rff_fit_exact`` fits w through the cached exact-GP factor instead.
* fedzo, fedprox, scaffold1, scaffold2: a finite-difference estimate per
  step, plus the proximal term (fedprox) or the control variates
  (scaffold1: an extra FD estimate at the round's start; scaffold2: the
  round's mean FD gradient).

The port keeps all clients in one stacked state (leading axis N) in every
engine; only the per-client engine's surrogate calls loop over clients.

Faults (``faults.FaultConfig``; ``faults/injector.py``): with ``faults``,
``run_round`` reads the round's draws from the absolute round index, a 0-d
tensor on the device, and injects them as the reference does.  nan and inf
poison the update, never the state; a straggler's update is the round's
broadcast iterate; without tolerance a dropped client is a NaN row of the
dense mean.  With tolerance the server takes the masked,
participation-weighted mean of the finite updates of live clients (the
live and quarantine counts as two more columns of the same sum), keeps the
previous iterate when no client is live, quarantines a client whose
update is not finite, and rolls the dropped, straggling and quarantined
clients back to their state after the round's prologue.  A quarantined
client stays out of both means until ``make_quarantine_reset`` restarts it
at the server iterate: after every round of the loop here, at every chunk
boundary in ``core/rounds.py``.  ``faults=None`` runs the faults-free
round, bit for bit what it was before faults were ported.

The draw source's generators live outside ``ClientState``: the port's
streams are its own (they never were the reference's threefry streams).
A frozen client's generator is not rolled back with its state: every
client draws every round, and a frozen client's draws of that round are
discarded with its update.  So a captured chunk replays the loop's
draws, a resumed run restores the generators with the state, and the
parity tests feed each round's draws recorded from the reference's own
keys, which do roll back (``tests/test_torch_faults.py``).

Every random draw goes through one draw source (``ClientDraws``): per
client, candidate deltas, query noise and FD directions, and the RFF bank.
It is backed by one ``torch.Generator`` per client, seeded from
``(seed, client_id)``; tests substitute the reference's recorded draws,
so the order of the calls is part of the engine's contract:

* ``simulate``: ``bank(M, d)`` once, for fzoos only;
* a fzoos local step (every engine): ``noise(1)`` for the iterate's
  query; when ``active_per_iter > 0``, ``deltas(n_cand, d, radius)`` then
  ``noise(active_per_iter)``; a fzoos round end: when
  ``active_round_end > 0``, ``deltas`` then ``noise(active_round_end)``;
* an FD local step: ``directions(q, d)`` then ``noise(q + 1)``, the noise of
  the query at x first; scaffold1's round start draws the same pair once
  before the local steps.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, NamedTuple, Optional

import numpy as np
import torch
from torch.utils import _pytree as pytree

from repro_torch.core import fd as fdlib
from repro_torch.core import gp_surrogate as gp
from repro_torch.core import rff as rfflib
from repro_torch.device import resolve_device
from repro_torch.faults import injector
from repro_torch.optim.optimizers import make_optimizer

QueryFn = Callable[[Any, torch.Tensor, torch.Tensor], torch.Tensor]

ALGORITHMS = ("fzoos", "fedzo", "fedprox", "scaffold1", "scaffold2")

#: Seed of the constant FD direction bank shared by every client (Prop. D.4).
FD_BANK_SEED = 12345


@dataclasses.dataclass(frozen=True)
class AlgoConfig:
    """Static algorithm configuration (same fields as the reference)."""

    name: str
    dim: int
    n_clients: int
    eta: float = 0.01
    local_steps: int = 10  # T
    optimizer: str = "adam"
    q: int = 20
    fd_lambda: float = 5e-3
    prox_mu: float = 1.0
    n_features: int = 512  # M
    traj_capacity: int = 128
    lengthscale: float = 1.0
    noise: float = 1e-4
    gamma_mode: str = "inv_t"  # inv_t | const  (Cor. C.1 practical choice)
    gamma_const: float = 1.0
    active_per_iter: int = 5
    active_candidates: int = 100
    active_radius: float = 0.01
    active_round_end: int = 5
    use_factor_cache: bool = True
    defer_repair: bool = True
    rff_fit_exact: bool = False
    # Block-size pins of the scoring / gradient-mean kernels (kernels/ops.py)
    # of both cached engines: the client-batched kernels of the deferred
    # engine and the single-client ones of the per-client engine.  None
    # leaves them to kernels/autotune.py.
    score_block_n: Optional[int] = None
    score_block_cap: Optional[int] = None
    grad_block_n: Optional[int] = None
    grad_block_cap: Optional[int] = None
    lo: float = 0.0
    hi: float = 1.0

    def __post_init__(self):
        if self.name not in ALGORITHMS:
            raise ValueError(f"unknown algorithm {self.name!r}; choose from {ALGORITHMS}")
        if self.rff_fit_exact and not self.use_factor_cache:
            raise ValueError("rff_fit_exact=True requires use_factor_cache=True "
                             "(the round-end fit consumes the cached Gram factor)")

    @property
    def is_fzoos(self) -> bool:
        return self.name == "fzoos"

    @property
    def deferred(self) -> bool:
        """True when the deferred-repair client-batched engine is active."""
        return self.is_fzoos and self.use_factor_cache and self.defer_repair

    @property
    def uses_fd(self) -> bool:
        return self.name in ("fedzo", "fedprox", "scaffold1", "scaffold2")

    def queries_per_round(self) -> int:
        """Per-client query count per round."""
        t = self.local_steps
        if self.is_fzoos:
            return t * (1 + self.active_per_iter) + self.active_round_end
        per_iter = fdlib.fd_queries(self.q)
        extra = fdlib.fd_queries(self.q) if self.name == "scaffold1" else 0
        return t * per_iter + extra

    def comm_floats_per_round(self) -> int:
        """Client->server payload floats per round."""
        base = self.dim
        if self.is_fzoos:
            return base + self.n_features  # + w^(i)  (Sec. 4.2.1)
        if self.name in ("scaffold1", "scaffold2"):
            return base + self.dim
        return base


class ClientState(NamedTuple):
    """Stacked state of all clients (leading axis N).  The reference's
    per-client PRNG key is replaced by the draw source's generators."""

    x: torch.Tensor  # (N, d)
    traj: gp.Trajectory
    factor: gp.GramFactor
    w_local: torch.Tensor  # (N, M)
    w_global: torch.Tensor  # (N, M)
    c_local: torch.Tensor  # (N, d)
    c_global: torch.Tensor  # (N, d)
    fd_bank: torch.Tensor  # (N, Q, d) constant shared direction bank (Prop. D.4)
    fd_accum: torch.Tensor  # (N, d)
    opt: Any  # optimizer state over x
    queries: torch.Tensor  # (N,) int32 cumulative queries
    client_id: torch.Tensor  # (N,) int32
    quarantined: torch.Tensor  # (N,) bool


class RoundStats(NamedTuple):
    server_x: torch.Tensor  # (d,)
    mean_cos: torch.Tensor
    mean_disparity: torch.Tensor
    queries_per_client: torch.Tensor
    refactor_rate: torch.Tensor
    repair_rate: torch.Tensor
    drop_rate: torch.Tensor
    quarantine_rate: torch.Tensor


class SimResult(NamedTuple):
    """Per-round history; ``f_values[r]`` is F(x_r) (NaN rows are skipped
    by ``eval_every``)."""

    xs: torch.Tensor  # (R+1, d)
    f_values: torch.Tensor  # (R+1,)
    queries: torch.Tensor  # (R,)
    mean_cos: torch.Tensor
    mean_disparity: torch.Tensor
    refactor_rate: torch.Tensor
    repair_rate: torch.Tensor
    drop_rate: torch.Tensor
    quarantine_rate: torch.Tensor


def stream_seed(seed: int, *words: int) -> int:
    """A 64-bit generator seed derived from ``(seed, *words)``."""
    return int(np.random.SeedSequence([seed, *words]).generate_state(1, np.uint64)[0])


def client_generator(seed: int, client_id: int, device) -> torch.Generator:
    """The generator of one client's draws, seeded from (seed, client_id)."""
    return torch.Generator(device=device).manual_seed(stream_seed(seed, 0, client_id))


class ClientDraws:
    """The engine's draw source: candidate deltas and query noise from each
    client's generator, the RFF bank from a generator of its own."""

    def __init__(self, seed: int, client_ids, device):
        self.device = torch.device(device)
        self.gens = [client_generator(seed, int(i), self.device) for i in client_ids]
        self.bank_gen = torch.Generator(device=self.device).manual_seed(stream_seed(seed, 1))

    def bank(self, m: int, d: int) -> tuple[torch.Tensor, torch.Tensor]:
        """Standard-normal (M, d) and uniform [0, 2 pi) (M,) bank draws."""
        z = torch.randn(m, d, generator=self.bank_gen, device=self.device)
        u = torch.rand(m, generator=self.bank_gen, device=self.device)
        return z, u * (2.0 * np.pi)

    def deltas(self, n: int, d: int, radius: float) -> torch.Tensor:
        """Uniform [-radius, radius) candidate offsets, (N, n, d)."""
        u = torch.stack([torch.rand(n, d, generator=g, device=self.device) for g in self.gens])
        return u * (2.0 * radius) - radius

    def noise(self, k: int) -> torch.Tensor:
        """Standard-normal query noise, (N, k)."""
        return torch.stack([torch.randn(k, generator=g, device=self.device) for g in self.gens])

    def directions(self, q: int, d: int) -> torch.Tensor:
        """Standard-normal FD directions, (N, q, d)."""
        return torch.stack([torch.randn(q, d, generator=g, device=self.device)
                            for g in self.gens])

    def state(self) -> list[torch.Tensor]:
        """Every generator's ``get_state()`` (uint8 CPU tensors): the bank
        generator's, then each client's.  A round-state checkpoint keeps it
        (``checkpoint/io.py``, group ``draws``)."""
        return [self.bank_gen.get_state(), *(g.get_state() for g in self.gens)]

    def load_state(self, states) -> None:
        """Inverse of ``state()``: set every generator's state.  On the card
        a replay reads the state of each generator registered with its
        graph, so the loaded state reaches captured chunks too."""
        bank, *clients = states
        if len(clients) != len(self.gens):
            raise ValueError(f"draw state holds {len(clients)} client generators, this "
                             f"source has {len(self.gens)}")
        for gen, st in zip((self.bank_gen, *self.gens), (bank, *clients)):
            gen.set_state(st.to("cpu", torch.uint8))


def _hyper_of(cfg: AlgoConfig) -> gp.GPHyper:
    return gp.GPHyper(float(cfg.lengthscale), float(cfg.noise))


def init_states(cfg: AlgoConfig, x0: torch.Tensor) -> ClientState:
    """Stacked fresh states of all clients on ``x0``'s device."""
    n, d, dev = cfg.n_clients, cfg.dim, x0.device
    cap = cfg.traj_capacity if cfg.is_fzoos else 1
    m = cfg.n_features if cfg.is_fzoos else 1
    qd = cfg.q if cfg.name == "scaffold2" else 1
    opt_init, _ = make_optimizer(cfg.optimizer)
    gen = torch.Generator(device=dev).manual_seed(FD_BANK_SEED)
    bank = fdlib.sample_directions(gen, qd, d)
    x = x0.to(torch.float32).expand(n, d).clone()
    traj0 = gp.traj_init(n, cap, d, dev)
    zeros = lambda *shape: torch.zeros(shape, dtype=torch.float32, device=dev)
    return ClientState(
        x=x,
        traj=traj0,
        factor=gp.factor_init(traj0, _hyper_of(cfg)),
        w_local=zeros(n, m),
        w_global=zeros(n, m),
        c_local=zeros(n, d),
        c_global=zeros(n, d),
        fd_bank=bank.expand(n, qd, d).clone(),
        fd_accum=zeros(n, d),
        opt=opt_init(x),
        queries=torch.zeros((n,), dtype=torch.int32, device=dev),
        client_id=torch.arange(n, dtype=torch.int32, device=dev),
        quarantined=torch.zeros((n,), dtype=torch.bool, device=dev),
    )


def _extend(cfg, hyper, traj, factor, xs, ys):
    """Append (N, k, d) queries; maintain the factors where they are cached."""
    if cfg.use_factor_cache:
        return gp.traj_extend_clients(traj, factor, xs, ys, hyper, deferred=cfg.defer_repair)
    return gp.traj_append_batch(traj, xs, ys), factor


def _select(cfg, hyper, deltas, traj, factor, centers, n_select):
    """Every client's active-query picks, (N, n_select, d)."""
    pins = dict(block_n=cfg.score_block_n, block_cap=cfg.score_block_cap)
    if cfg.deferred:
        return gp.select_active_queries_cached_clients(
            deltas, traj, factor, hyper, centers, n_select, cfg.lo, cfg.hi, **pins)
    picks = []
    for i in range(centers.shape[0]):
        tr = gp.client(traj, i)
        if cfg.use_factor_cache:
            picks.append(gp.select_active_queries_cached(
                deltas[i], tr, gp.client(factor, i), hyper, centers[i], n_select, cfg.lo,
                cfg.hi, **pins))
        else:
            picks.append(gp.select_active_queries(deltas[i], tr, hyper, centers[i], n_select,
                                                  cfg.lo, cfg.hi))
    return torch.stack(picks)


def _grad_mean(cfg, hyper, traj, factor, x):
    """Every client's surrogate gradient mean at its iterate, (N, d)."""
    pins = dict(block_n=cfg.grad_block_n, block_cap=cfg.grad_block_cap)
    if cfg.deferred:
        return gp.grad_mean_cached_clients(traj, factor, hyper, x, **pins)
    out = []
    for i in range(x.shape[0]):
        tr = gp.client(traj, i)
        if cfg.use_factor_cache:
            out.append(gp.grad_mean_cached(tr, gp.client(factor, i), hyper, x[i], **pins))
        else:
            out.append(gp.grad_mean(tr, hyper, x[i]))
    return torch.stack(out)


def _active(cfg, hyper, query_fn, cobjs, draws, traj, factor, centers, n_select):
    """Pick ``n_select`` active queries around each center, query and append them."""
    deltas = draws.deltas(cfg.active_candidates, cfg.dim, cfg.active_radius)
    cands = _select(cfg, hyper, deltas, traj, factor, centers, n_select)
    ys = query_fn(cobjs, cands, draws.noise(n_select))
    return _extend(cfg, hyper, traj, factor, cands, ys)


def _estimate_gradient(cfg, rff, query_fn, cobjs, sts: ClientState, server_x, t, draws):
    """ghat per eq. (2)/(8) for every client, (N, d), and the state with the
    estimate's queries counted."""
    x = sts.x
    if cfg.is_fzoos:
        g_loc = _grad_mean(cfg, _hyper_of(cfg), sts.traj, sts.factor, x)
        corr = (rfflib.grad_features_t_w_rows(rff, x, sts.w_global)
                - rfflib.grad_features_t_w_rows(rff, x, sts.w_local))
        gamma = np.float32(1.0) / np.float32(t) if cfg.gamma_mode == "inv_t" \
            else np.float32(cfg.gamma_const)
        return g_loc + float(gamma) * corr, sts
    g_fd, sts = _fd_estimate(cfg, query_fn, cobjs, sts, x, draws)
    if cfg.name == "fedzo":
        return g_fd, sts
    if cfg.name == "fedprox":
        return g_fd + cfg.prox_mu * (x - server_x), sts
    # scaffold1 / scaffold2: gamma = 1 control-variate correction
    sts = sts._replace(fd_accum=sts.fd_accum + g_fd)
    return g_fd + (sts.c_global - sts.c_local), sts


def _fd_estimate(cfg, query_fn, cobjs, sts: ClientState, x, draws):
    """One FD estimate per client at x (N, d) with fresh directions."""
    dirs = draws.directions(cfg.q, cfg.dim)
    nq = fdlib.fd_queries(cfg.q)
    g = fdlib.fd_grad(query_fn, cobjs, x, draws.noise(nq), dirs, cfg.fd_lambda)
    return g, sts._replace(queries=sts.queries + nq)


def _local_phase(cfg, rff, query_fn, cobjs, sts: ClientState, server_x, draws,
                 diag_global_grad):
    """T local steps for the whole client batch; returns (states, sum_cos,
    sum_disparity) with per-client sums over the steps."""
    _, opt_update = make_optimizer(cfg.optimizer)
    hyper = _hyper_of(cfg)
    n = sts.x.shape[0]
    sum_cos = torch.zeros((n,), dtype=torch.float32, device=sts.x.device)
    sum_disp = torch.zeros_like(sum_cos)
    for t in range(1, cfg.local_steps + 1):
        if cfg.is_fzoos:
            # query the iterate (+ active queries) BEFORE estimating: the
            # estimate is conditioned on D_{r,t-1}
            y = query_fn(cobjs, sts.x[:, None, :], draws.noise(1))
            traj, factor = _extend(cfg, hyper, sts.traj, sts.factor, sts.x[:, None, :], y)
            n_q = 1
            if cfg.active_per_iter > 0:
                traj, factor = _active(cfg, hyper, query_fn, cobjs, draws, traj, factor, sts.x,
                                       cfg.active_per_iter)
                n_q += cfg.active_per_iter
            sts = sts._replace(traj=traj, factor=factor, queries=sts.queries + n_q)

        ghat, sts = _estimate_gradient(cfg, rff, query_fn, cobjs, sts, server_x, t, draws)
        new_x, new_opt = opt_update(sts.opt, ghat, sts.x, cfg.eta)
        new_x = torch.clamp(new_x, cfg.lo, cfg.hi)
        if diag_global_grad is not None:
            gf = diag_global_grad(sts.x)
            sum_cos = sum_cos + torch.sum(ghat * gf, -1) / (
                torch.linalg.norm(ghat, dim=-1) * torch.linalg.norm(gf, dim=-1) + 1e-12)
            sum_disp = sum_disp + torch.sum((ghat - gf) ** 2, -1)
        sts = sts._replace(x=new_x, opt=new_opt)
    return sts, sum_cos, sum_disp


def _post_phase(cfg, rff, query_fn, cobjs, sts: ClientState, new_server_x, draws):
    """Round-end work of every client at the new server iterate: FZooS's
    active queries and eq. 6 fit, scaffold2's control variate."""
    sts = sts._replace(x=new_server_x.expand_as(sts.x).clone())
    if cfg.is_fzoos:
        hyper = _hyper_of(cfg)
        traj, factor = sts.traj, sts.factor
        if cfg.active_round_end > 0:
            traj, factor = _active(cfg, hyper, query_fn, cobjs, draws, traj, factor, sts.x,
                                   cfg.active_round_end)
            sts = sts._replace(traj=traj, factor=factor,
                               queries=sts.queries + cfg.active_round_end)
        if cfg.rff_fit_exact:
            w = rfflib.fit_w_from_factor(rff, traj, factor)
        elif cfg.deferred:
            w = rfflib.fit_w_chol(rff, traj, hyper, factor)
        else:
            w = rfflib.fit_w(rff, traj, hyper)
        return sts._replace(w_local=w)
    if cfg.name == "scaffold2":
        return sts._replace(c_local=sts.fd_accum / cfg.local_steps)
    return sts


def _broadcast_mean(a: torch.Tensor) -> torch.Tensor:
    """The server mean over clients, replicated to every client."""
    return torch.mean(a, dim=0).expand_as(a).clone()


def _over(v: torch.Tensor, n) -> torch.Tensor:
    """``v / n`` by a true division: on the card a division by a host scalar
    multiplies by 1/n, one ulp off (at N=7, say)."""
    return v / torch.full((), float(n), dtype=torch.float32, device=v.device)


def _fault_draws(faults, round_idx, client_ids):
    """(config, the round's FaultDraw) from a ``FaultConfig`` (hashed now)
    or a ``FaultSchedule`` (read from its table)."""
    if round_idx is None:
        raise ValueError("faults injection requires round_idx")
    if isinstance(faults, injector.FaultSchedule):
        return faults.config, faults.draw(round_idx, client_ids)
    return faults, injector.draw_faults(faults, round_idx, client_ids)


def _freeze(frozen: torch.Tensor, old, new):
    """Every leaf of ``new`` with the rows of the ``frozen`` clients taken
    from ``old``; the optimizer's step counter, shared by all clients,
    stays ``new``'s (the next prologue resets it)."""
    def sel(o, n):
        if not torch.is_tensor(n) or n.dim() == 0:
            return n
        return torch.where(frozen.reshape(frozen.shape + (1,) * (n.dim() - 1)), o, n)
    return pytree.tree_map(sel, old, new)


def _masked_mean(values: torch.Tensor, mask: torch.Tensor, *extra: torch.Tensor):
    """The sum over clients of the rows of ``values`` where ``mask``, with
    ``mask`` and every ``extra`` (N,) vector as further columns of the same
    sum: returns (sum of values, count, sums of the extras).  ``where``,
    never a product with the mask: NaN times 0 is NaN."""
    cols = [torch.where(mask[:, None], values, 0.0), mask.to(torch.float32)[:, None],
            *(e.to(torch.float32)[:, None] for e in extra)]
    tot = torch.sum(torch.cat(cols, dim=1), dim=0)
    k = values.shape[1]
    return tot[:k], tot[k], tot[k + 1:]


def run_round(
    cfg: AlgoConfig,
    rff: Optional[rfflib.RFFParams],
    query_fn: QueryFn,
    cobjs,
    states: ClientState,
    server_x: torch.Tensor,
    draws,
    diag_global_grad: Optional[Callable[[torch.Tensor], torch.Tensor]] = None,
    *,
    faults=None,
    round_idx: Optional[torch.Tensor] = None,
) -> tuple[ClientState, RoundStats]:
    """One communication round with mean aggregation over all clients.

    ``diag_global_grad`` maps the stacked iterates (N, d) to grad F (N, d).
    ``faults`` (a ``FaultConfig``, or a run's ``FaultSchedule``) injects
    the draws of ``round_idx``, the absolute round as a 0-d tensor on the
    device, and with ``faults.tolerate`` masks the aggregation (module
    docstring); ``faults=None`` is the faults-free round.
    """
    fd = None
    if faults is not None:
        faults, fd = _fault_draws(faults, round_idx, states.client_id)
    opt_init, _ = make_optimizer(cfg.optimizer)
    x = server_x.expand_as(states.x).clone()
    states = states._replace(x=x, opt=opt_init(x), fd_accum=torch.zeros_like(x))
    if cfg.name == "scaffold1":
        # c_i <- FD estimate at x_{r-1}: one extra transmission (Appx. D)
        c_i, states = _fd_estimate(cfg, query_fn, cobjs, states, x, draws)
        states = states._replace(c_local=c_i, c_global=_broadcast_mean(c_i))
    # the post-prologue snapshot that faulted clients roll back to
    states0 = states

    states, sum_cos, sum_disp = _local_phase(
        cfg, rff, query_fn, cobjs, states, server_x, draws, diag_global_grad)
    tolerant = faults is not None and faults.tolerate
    if faults is None:
        new_server_x = torch.mean(states.x, dim=0)
    else:
        # the payload faults go into the update, never into the state
        x_up = states.x
        if faults.nan_rate > 0:
            x_up = torch.where(fd.nan[:, None], float("nan"), x_up)
        if faults.inf_rate > 0:
            x_up = torch.where(fd.inf[:, None], float("inf"), x_up)
        x_up = torch.where(fd.straggle[:, None], server_x, x_up)
        if tolerant:
            finite = torch.isfinite(x_up).all(-1)
            quar = states.quarantined | (~finite & ~fd.drop)
            live = ~fd.drop & ~states.quarantined & finite
            x_sum, n_live, (n_quar,) = _masked_mean(x_up, live, quar)
            new_server_x = torch.where(n_live > 0, x_sum / torch.clamp(n_live, min=1.0),
                                       server_x)
        else:
            # silence is a NaN row of the dense mean
            x_up = torch.where(fd.drop[:, None], float("nan"), x_up)
            new_server_x = _over(torch.sum(x_up, dim=0), cfg.n_clients)
    states = _post_phase(cfg, rff, query_fn, cobjs, states, new_server_x, draws)
    if tolerant:
        # a client that did not deliver, or is quarantined, keeps its state
        states = _freeze(fd.drop | fd.straggle | quar, states0, states)
        states = states._replace(quarantined=quar)
    if cfg.is_fzoos:
        if tolerant:
            # stragglers send their stale w; dropped and quarantined clients none
            m_w = ~fd.drop & ~quar
            w_sum, n_w, _ = _masked_mean(states.w_local, m_w)
            w_glob = torch.where(n_w > 0, w_sum / torch.clamp(n_w, min=1.0),
                                 torch.mean(states.w_global, dim=0))
            states = states._replace(w_global=w_glob.expand_as(states.w_global).clone())
        else:
            states = states._replace(w_global=_broadcast_mean(states.w_local))
    elif cfg.name == "scaffold2":
        states = states._replace(c_global=_broadcast_mean(states.c_local))

    f32 = lambda v: v.to(torch.float32)
    zero = torch.zeros((), dtype=torch.float32, device=x.device)
    n = states.queries.shape[0]
    if tolerant:  # means over the live clients
        denom = torch.clamp(n_live, min=1.0)
        mean = count = lambda v: torch.sum(torch.where(live, v, 0.0)) / denom
        # the shares of clients not live and quarantined, correctly rounded
        drop_rate, quarantine_rate = _over(n - n_live, n), _over(n_quar, n)
    else:
        # the counts' mean is their sum divided by N, exact as the reference's
        mean, count = torch.mean, lambda v: _over(torch.sum(v), n)
        drop_rate = zero if faults is None else _over(torch.sum(f32(fd.drop)), n)
        quarantine_rate = zero
    fac = states.factor
    stats = RoundStats(
        server_x=new_server_x,
        mean_cos=mean(sum_cos) / cfg.local_steps,
        mean_disparity=mean(sum_disp) / cfg.local_steps,
        queries_per_client=count(f32(states.queries)),
        refactor_rate=mean(f32(fac.n_refactors) / torch.clamp(f32(fac.n_updates), min=1.0)),
        repair_rate=mean(f32(fac.needs_repair)),
        drop_rate=drop_rate,
        quarantine_rate=quarantine_rate,
    )
    return states, stats


def make_quarantine_reset(cfg: AlgoConfig, device):
    """Build ``reset(states, server_x)``: restart the quarantined clients as
    fresh clients joining at ``server_x`` (the reference's chunk-boundary
    recovery).  The fresh client's template (empty trajectory, its factor,
    the shared FD bank) is built here, once, outside any capture.  A
    restarted client keeps its ``client_id``, its query count and the
    replicated ``w_global`` (its generator lives in the draw source and is
    not touched); everything else restarts, and its flag is cleared."""
    template = init_states(dataclasses.replace(cfg, n_clients=1),
                           torch.zeros((cfg.dim,), dtype=torch.float32, device=device))
    opt_init, _ = make_optimizer(cfg.optimizer)

    def reset(states: ClientState, server_x: torch.Tensor) -> ClientState:
        flag = states.quarantined
        x = server_x.expand_as(states.x)
        fresh = template._replace(x=x, opt=opt_init(x))

        def sel(old, new):
            if not torch.is_tensor(old) or old.dim() == 0:
                return old
            f = flag.reshape(flag.shape + (1,) * (old.dim() - 1))
            return torch.where(f, new.expand_as(old), old)

        merged = pytree.tree_map(sel, states, fresh)
        return merged._replace(client_id=states.client_id, queries=states.queries,
                               w_global=states.w_global,
                               quarantined=torch.zeros_like(flag))

    return reset


def simulate(
    cfg: AlgoConfig,
    seed: int,
    cobjs,
    query_fn: QueryFn,
    global_value_fn: Callable[[Any, torch.Tensor], torch.Tensor],
    rounds: int,
    *,
    x0: Optional[torch.Tensor] = None,
    diag_global_grad: Optional[Callable[[torch.Tensor], torch.Tensor]] = None,
    draws=None,
    chunk: Optional[int] = None,
    eval_every: int = 1,
    checkpoint_dir: Optional[str] = None,
    checkpoint_every: int = 1,
    async_checkpoint: bool = True,
    faults: Optional[injector.FaultConfig] = None,
    max_rollbacks: int = 3,
    cohort: Optional[int] = None,
    cohort_seed: int = 0,
    identity: Optional[dict] = None,
    device="cuda",
) -> SimResult:
    """Run ``rounds`` communication rounds.

    ``chunk`` selects how the rounds run, as in the reference: ``None``
    (default) runs chunks of ``rounds.DEFAULT_CHUNK`` rounds
    (``core/rounds.py``; on the card the deferred engine's and the FD
    baselines' chunks are captured CUDA graphs), ``k > 0`` chunks of k, and
    ``0`` the per-round Python loop, the equivalence oracle.  The deferred
    engine's flagged clients are repaired after every chunk, or after every
    round of the loop.

    The draw source defaults to ``ClientDraws(seed, range(N), device)``; the
    RFF bank (fzoos) comes from it, and the clients start fresh at ``x0``
    (0.5 everywhere by default).  ``diag_global_grad`` maps the stacked
    iterates (N, d) to grad F (N, d) for the cos/disparity diagnostics.
    ``eval_every=k`` keeps F only every k-th round and the last (NaN
    elsewhere).  ``checkpoint_dir`` (chunked runs only) checkpoints the
    run every ``checkpoint_every`` chunks and at its end, and resumes it
    from the newest good step; ``async_checkpoint`` writes the files on a
    background thread (``core/rounds.py``).

    ``faults`` (a ``faults.FaultConfig``) runs the rounds under the
    reference's fault model (module docstring); a config that can never
    fire in ``[0, rounds)`` runs the faults-free engine
    (``effective_config``).  The loop resets the quarantined clients after
    every round and returns NaN rows where a run without tolerance is
    poisoned; chunks reset them at every boundary, where a poisoned
    iterate rolls the run back to its last good checkpoint, at most
    ``max_rollbacks`` times, or raises without a ``checkpoint_dir``
    (``core/rounds.py``).  ``identity`` adds the caller's fields (the
    command line's seed and objective arguments) to the run identity that
    a resume checks.

    ``cohort=K`` runs partial participation (``core/pool.py``): the N =
    ``cfg.n_clients`` clients live in a host pool and each chunk a cohort
    of K, drawn from ``cohort_seed`` and the chunk's first round, runs on
    the device, its means over the live members of the cohort; the draw
    source then has K generators (``ClientDraws(seed, range(K),
    device)`` by default), loaded with the cohort's states every chunk.
    K = N is the dense engine bit for bit.  The pooled engine has no loop:
    ``chunk=0`` raises.
    """
    from repro_torch.core import rounds as rounds_mod  # deferred: rounds imports this module

    dev = resolve_device(device)
    faults = injector.effective_config(faults, rounds)
    if chunk is not None and chunk < 0:
        raise ValueError(f"chunk must be None, 0 (loop oracle) or positive, got {chunk}")
    if eval_every < 1:
        raise ValueError(f"eval_every must be >= 1, got {eval_every}")
    if chunk == 0 and checkpoint_dir:
        raise ValueError("checkpoint_dir requires the scan driver (chunk != 0)")
    if cohort is not None and chunk == 0:
        raise ValueError("cohort (partial participation) requires chunks (chunk != 0); the "
                         "dense engine at cohort == n_clients is the equivalence oracle")
    if x0 is None:
        x0 = torch.full((cfg.dim,), 0.5, dtype=torch.float32, device=dev)
    x0 = x0.to(dev)
    if draws is None:
        draws = ClientDraws(seed, range(cfg.n_clients if cohort is None else cohort), dev)
    rff = rfflib.make_rff(draws, cfg.n_features, cfg.dim, cfg.lengthscale) \
        if cfg.is_fzoos else None
    engine = dict(diag_global_grad=diag_global_grad, eval_every=eval_every,
                  checkpoint_dir=checkpoint_dir, checkpoint_every=checkpoint_every,
                  async_checkpoint=async_checkpoint, faults=faults,
                  max_rollbacks=max_rollbacks, identity=identity)
    chunk = rounds_mod.DEFAULT_CHUNK if chunk is None else chunk
    if cohort is not None:
        from repro_torch.core import pool as pool_mod  # deferred: pool imports rounds

        pool = pool_mod.init_pool(cfg, x0, seed)
        _, res = pool_mod.run_pooled_rounds(
            cfg, rff, query_fn, cobjs, pool, x0, global_value_fn, rounds, chunk,
            cohort=cohort, cohort_seed=cohort_seed, draws=draws, **engine)
        return res
    states = init_states(cfg, x0)
    if chunk != 0:
        _, res = rounds_mod.run_rounds(cfg, rff, query_fn, cobjs, states, x0, global_value_fn,
                                       rounds, chunk, draws=draws, **engine)
        return res

    xs, fvals = [x0], [global_value_fn(cobjs, x0)]
    hist = {k: [] for k in ("queries", "cos", "disp", "refactor", "repair", "drop", "quar")}
    sx = x0
    schedule = reset = None
    if faults is not None:
        schedule = injector.FaultSchedule(faults, rounds, cfg.n_clients, dev)
        if faults.tolerate:
            reset = make_quarantine_reset(cfg, dev)
    for r in range(rounds):
        r_idx = None if schedule is None else torch.full((), r, dtype=torch.int64, device=dev)
        states, stats = run_round(cfg, rff, query_fn, cobjs, states, sx, draws, diag_global_grad,
                                  faults=schedule, round_idx=r_idx)
        states, _ = rounds_mod.repair_flagged_clients(states, cfg)
        sx = stats.server_x
        if reset is not None:
            states, _ = rounds_mod.quarantine_reset_flagged(states, cfg, sx, reset)
        xs.append(sx)
        r1 = r + 1
        if r1 % eval_every == 0 or r1 == rounds:
            fvals.append(global_value_fn(cobjs, sx))
        else:
            fvals.append(torch.full((), float("nan"), dtype=torch.float32, device=dev))
        for k, v in zip(hist, (stats.queries_per_client, stats.mean_cos, stats.mean_disparity,
                               stats.refactor_rate, stats.repair_rate, stats.drop_rate,
                               stats.quarantine_rate)):
            hist[k].append(v)
    stack = lambda vs: torch.stack([v.to(torch.float32) for v in vs])
    return SimResult(
        xs=torch.stack(xs), f_values=stack(fvals), queries=stack(hist["queries"]),
        mean_cos=stack(hist["cos"]), mean_disparity=stack(hist["disp"]),
        refactor_rate=stack(hist["refactor"]), repair_rate=stack(hist["repair"]),
        drop_rate=stack(hist["drop"]), quarantine_rate=stack(hist["quar"]),
    )
