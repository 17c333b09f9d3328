"""The federated FZooS round engine (port of ``repro.core.algorithms``,
the deferred client-batched fzoos path of ``simulate(..., chunk=0)``).

Each round: T collective-free local steps for the whole client batch
(query, append + deferred factor update, active-query scoring, surrogate
gradient mean + RFF correction, Adam), one mean of the iterates, the
round-end active queries, the eq. 6 RFF fit and one mean of the weights.
The FD baselines, the non-deferred engines, faults, the scan, pool and
distributed engines are not ported yet: ``run_round`` raises for them.

Every random draw of the engine goes through one draw source
(``ClientDraws``): per client, candidate deltas and query noise, and the
RFF bank.  It is backed by one ``torch.Generator`` per client, seeded
from ``(seed, client_id)``; tests substitute recorded draws.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, NamedTuple, Optional

import numpy as np
import torch

from repro_torch.core import fd as fdlib
from repro_torch.core import gp_surrogate as gp
from repro_torch.core import rff as rfflib
from repro_torch.core import rounds as rounds_mod
from repro_torch.device import resolve_device
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
    # Block-size pins of the scoring / gradient-mean kernels (kernels/ops.py);
    # None leaves them to kernels/autotune.py.
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


def _local_phase_clients(cfg, rff, query_fn, cobjs, sts: ClientState, draws, diag_global_grad):
    """T local FZooS steps for the whole client batch (deferred factors)."""
    _, opt_update = make_optimizer(cfg.optimizer)
    hyper = _hyper_of(cfg)
    n, d = sts.x.shape
    sum_cos = torch.zeros((n,), dtype=torch.float32, device=sts.x.device)
    sum_disp = torch.zeros_like(sum_cos)
    for t in range(1, cfg.local_steps + 1):
        y = query_fn(cobjs, sts.x[:, None, :], draws.noise(1))
        traj, factor = gp.traj_extend_clients(sts.traj, sts.factor, sts.x[:, None, :], y, hyper)
        n_q = 1
        if cfg.active_per_iter > 0:
            cands = gp.select_active_queries_cached_clients(
                draws.deltas(cfg.active_candidates, d, cfg.active_radius), traj, factor, hyper,
                sts.x, cfg.active_per_iter, cfg.lo, cfg.hi,
                block_n=cfg.score_block_n, block_cap=cfg.score_block_cap)
            ys = query_fn(cobjs, cands, draws.noise(cfg.active_per_iter))
            traj, factor = gp.traj_extend_clients(traj, factor, cands, ys, hyper)
            n_q += cfg.active_per_iter
        sts = sts._replace(traj=traj, factor=factor, queries=sts.queries + n_q)

        # eq. (2): batched surrogate mean + per-client RFF correction
        g_loc = gp.grad_mean_cached_clients(traj, factor, hyper, sts.x,
                                            block_n=cfg.grad_block_n, block_cap=cfg.grad_block_cap)
        corr = (rfflib.grad_features_t_w_rows(rff, sts.x, sts.w_global)
                - rfflib.grad_features_t_w_rows(rff, sts.x, sts.w_local))
        gamma = np.float32(1.0) / np.float32(t) if cfg.gamma_mode == "inv_t" \
            else np.float32(cfg.gamma_const)
        ghat = g_loc + float(gamma) * corr

        new_x, new_opt = opt_update(sts.opt, ghat, sts.x, cfg.eta)
        new_x = torch.clamp(new_x, cfg.lo, cfg.hi)
        if diag_global_grad is not None:
            gf = diag_global_grad(sts.x)
            sum_cos = sum_cos + torch.sum(ghat * gf, -1) / (
                torch.linalg.norm(ghat, dim=-1) * torch.linalg.norm(gf, dim=-1) + 1e-12)
            sum_disp = sum_disp + torch.sum((ghat - gf) ** 2, -1)
        sts = sts._replace(x=new_x, opt=new_opt)
    return sts, sum_cos, sum_disp


def _post_phase_clients(cfg, rff, query_fn, cobjs, sts: ClientState, new_server_x, draws):
    """Round-end active queries and the eigh-free RFF fit of every client."""
    hyper = _hyper_of(cfg)
    sts = sts._replace(x=new_server_x.expand_as(sts.x).clone())
    traj, factor = sts.traj, sts.factor
    if cfg.active_round_end > 0:
        cands = gp.select_active_queries_cached_clients(
            draws.deltas(cfg.active_candidates, cfg.dim, cfg.active_radius), traj, factor, hyper,
            sts.x, cfg.active_round_end, cfg.lo, cfg.hi,
            block_n=cfg.score_block_n, block_cap=cfg.score_block_cap)
        ys = query_fn(cobjs, cands, draws.noise(cfg.active_round_end))
        traj, factor = gp.traj_extend_clients(traj, factor, cands, ys, hyper)
        sts = sts._replace(traj=traj, factor=factor, queries=sts.queries + cfg.active_round_end)
    return sts._replace(w_local=rfflib.fit_w_chol(rff, traj, hyper, factor))


def run_round(
    cfg: AlgoConfig,
    rff: rfflib.RFFParams,
    query_fn: QueryFn,
    cobjs,
    states: ClientState,
    server_x: torch.Tensor,
    draws,
    diag_global_grad: Optional[Callable[[torch.Tensor], torch.Tensor]] = None,
) -> tuple[ClientState, RoundStats]:
    """One communication round with mean aggregation over all clients.

    ``diag_global_grad`` maps the stacked iterates (N, d) to grad F (N, d).
    """
    if not cfg.deferred or cfg.rff_fit_exact:
        raise NotImplementedError(
            "repro_torch ports the deferred fzoos engine only (name='fzoos', "
            "use_factor_cache, defer_repair, rff_fit_exact=False)")
    opt_init, _ = make_optimizer(cfg.optimizer)
    x = server_x.expand_as(states.x).clone()
    states = states._replace(x=x, opt=opt_init(x), fd_accum=torch.zeros_like(x))

    states, sum_cos, sum_disp = _local_phase_clients(
        cfg, rff, query_fn, cobjs, states, draws, diag_global_grad)
    new_server_x = torch.mean(states.x, dim=0)
    states = _post_phase_clients(cfg, rff, query_fn, cobjs, states, new_server_x, draws)
    w_glob = torch.mean(states.w_local, dim=0)
    states = states._replace(w_global=w_glob.expand_as(states.w_global).clone())

    f32 = lambda v: v.to(torch.float32)
    zero = torch.zeros((), dtype=torch.float32, device=x.device)
    fac = states.factor
    stats = RoundStats(
        server_x=new_server_x,
        mean_cos=torch.mean(sum_cos) / cfg.local_steps,
        mean_disparity=torch.mean(sum_disp) / cfg.local_steps,
        queries_per_client=torch.mean(f32(states.queries)),
        refactor_rate=torch.mean(f32(fac.n_refactors) / torch.clamp(f32(fac.n_updates), min=1.0)),
        repair_rate=torch.mean(f32(fac.needs_repair)),
        drop_rate=zero,
        quarantine_rate=zero,
    )
    return states, stats


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
    eval_every: int = 1,
    device="cuda",
) -> SimResult:
    """Run ``rounds`` communication rounds, one Python loop iteration each.

    The draw source defaults to ``ClientDraws(seed, range(N), device)``; the
    RFF bank comes from it, and the clients start fresh at ``x0`` (0.5
    everywhere by default).  ``diag_global_grad`` maps the stacked iterates
    (N, d) to grad F (N, d) for the cos/disparity diagnostics.  After every
    round the clients flagged ``needs_repair`` are repaired.
    """
    dev = resolve_device(device)
    if eval_every < 1:
        raise ValueError(f"eval_every must be >= 1, got {eval_every}")
    if x0 is None:
        x0 = torch.full((cfg.dim,), 0.5, dtype=torch.float32, device=dev)
    x0 = x0.to(dev)
    if draws is None:
        draws = ClientDraws(seed, range(cfg.n_clients), dev)
    rff = rfflib.make_rff(draws, cfg.n_features, cfg.dim, cfg.lengthscale)
    states = init_states(cfg, x0)

    xs, fvals = [x0], [global_value_fn(cobjs, x0)]
    hist = {k: [] for k in ("queries", "cos", "disp", "refactor", "repair", "drop", "quar")}
    sx = x0
    for r in range(rounds):
        states, stats = run_round(cfg, rff, query_fn, cobjs, states, sx, draws, diag_global_grad)
        states, _ = rounds_mod.repair_flagged_clients(states, cfg)
        sx = stats.server_x
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
