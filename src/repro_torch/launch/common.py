"""Shared ``AlgoConfig`` plumbing of the launcher (port of
``repro.launch.common``).

* ``add_algo_flags(parser)`` installs the algorithm flag set;
* ``config_from_args(args, dim=..., n_clients=...)`` builds the config
  from the parsed flags;
* ``make_config(name, dim=..., n_clients=..., **overrides)`` is the same
  builder for programmatic callers;
* ``add_engine_flags`` installs the round driver's flags (``--chunk``,
  ``--ckpt-dir``, ``--ckpt-every``, ``--sync-ckpt``, ``--eval-every``) and
  the pool and fault flags.

``add_arch_flag`` installs ``--arch`` (the serving launcher's too).
Every flag keeps the reference's name, type and default.
``pool_from_args`` and ``faults_from_args`` read the pool flags
(``--pool-size``, ``--cohort``, ``--cohort-seed``) and the fault flags
(the ``FaultConfig`` fields, ``--fault-tolerance``, ``--max-rollbacks``)
as the reference's do.
"""

from __future__ import annotations

import argparse

from repro_torch.configs import ARCH_IDS, _norm
from repro_torch.core import algorithms as alg

#: argparse flag -> AlgoConfig field for the plain value flags.
_FLAG_FIELDS = {
    "algo": "name",
    "eta": "eta",
    "local_steps": "local_steps",
    "q": "q",
    "features": "n_features",
    "traj_cap": "traj_capacity",
    "lengthscale": "lengthscale",
    "gp_noise": "noise",
    "gamma_mode": "gamma_mode",
    "gamma_const": "gamma_const",
}


class ArchChoices(list):
    """The choices of ``--arch``: the reference's ids, with dashes or
    underscores; membership also admits a config's published name
    (``qwen1.5-0.5b``), which names the same module."""

    def __contains__(self, arch) -> bool:
        return list.__contains__(self, arch) or _norm(str(arch)) in ARCH_IDS


def add_arch_flag(ap: argparse.ArgumentParser) -> None:
    ap.add_argument("--arch", default="qwen1_5_0_5b",
                    choices=ArchChoices([a.replace("_", "-") for a in ARCH_IDS] + list(ARCH_IDS)))


def add_algo_flags(ap: argparse.ArgumentParser) -> None:
    """Install the shared per-algorithm flag set (the AlgoConfig surface)."""
    ap.add_argument("--algo", default="fzoos", choices=list(alg.ALGORITHMS))
    ap.add_argument("--local-steps", type=int, default=10, help="T")
    ap.add_argument("--eta", type=float, default=0.01)
    ap.add_argument("--q", type=int, default=20, help="FD directions per step")
    ap.add_argument("--features", type=int, default=1000, help="RFF features M")
    ap.add_argument("--traj-cap", type=int, default=192)
    ap.add_argument("--lengthscale", type=float, default=0.5,
                    help="GP/RFF kernel lengthscale (AlgoConfig.lengthscale)")
    ap.add_argument("--gp-noise", "--noise", dest="gp_noise", type=float, default=1e-5,
                    help="GP observation-noise variance (AlgoConfig.noise)")
    ap.add_argument("--gamma-mode", default="inv_t", choices=["inv_t", "const"],
                    help="correction-length schedule (Cor. C.1 practical choice)")
    ap.add_argument("--gamma-const", type=float, default=1.0,
                    help="gamma value when --gamma-mode const")
    ap.add_argument("--no-factor-cache", action="store_true",
                    help="seed eigh-from-scratch surrogate path (equivalence oracle)")
    ap.add_argument("--no-defer-repair", action="store_true",
                    help="inline clamped-eigh fallback per append event "
                         "(the per-client engine, the deferred-repair oracle)")


def add_engine_flags(ap: argparse.ArgumentParser) -> None:
    """Round-driver knobs, then the pool and fault flags."""
    ap.add_argument("--chunk", type=int, default=None,
                    help="rounds per chunk (core/rounds.py; on the card one captured "
                         "CUDA graph); 0 = the per-round loop")
    ap.add_argument("--ckpt-dir", default="",
                    help="chunk-boundary checkpoint/resume dir (chunked runs); a second "
                         "run with the same dir resumes from its newest good step")
    ap.add_argument("--ckpt-every", type=int, default=1,
                    help="checkpoint every k-th chunk boundary (plus the end)")
    ap.add_argument("--sync-ckpt", action="store_true",
                    help="write checkpoints synchronously at the boundary "
                         "(default: background write overlapped with the "
                         "next chunk's compute)")
    ap.add_argument("--eval-every", type=int, default=1,
                    help="evaluate global F only every k-th round (+ final); "
                         "skipped history rows hold NaN")
    add_pool_flags(ap)
    add_fault_flags(ap)


def add_pool_flags(ap: argparse.ArgumentParser) -> None:
    """Partial-participation knobs (the reference's client pool)."""
    ap.add_argument("--pool-size", type=int, default=None,
                    help="total client population N held in the host-resident "
                         "pool (overrides --clients; requires --cohort)")
    ap.add_argument("--cohort", type=int, default=None,
                    help="clients gathered per chunk (K <= N); "
                         "enables the partial-participation engine")
    ap.add_argument("--cohort-seed", type=int, default=0,
                    help="seed of the deterministic cohort sampler")


def pool_from_args(args: argparse.Namespace) -> tuple[int | None, int | None]:
    """(n_clients override, cohort) from the pool flags, validated: an exit
    on ``--pool-size`` without ``--cohort`` or on a size below 1."""
    if args.pool_size is not None:
        if args.cohort is None:
            raise SystemExit("--pool-size requires --cohort (K clients per round out of the "
                             "N pooled)")
        if args.pool_size < 1:
            raise SystemExit(f"--pool-size {args.pool_size} must be >= 1")
    if args.cohort is not None and args.cohort < 1:
        raise SystemExit(f"--cohort {args.cohort} must be >= 1")
    return args.pool_size, args.cohort


def add_fault_flags(ap: argparse.ArgumentParser) -> None:
    """Deterministic fault-injection knobs (the reference's FaultConfig)."""
    ap.add_argument("--fault-seed", type=int, default=0,
                    help="seed of the deterministic fault schedule")
    ap.add_argument("--drop-rate", type=float, default=0.0,
                    help="per-(round, client) dropout probability")
    ap.add_argument("--straggle-rate", type=float, default=0.0,
                    help="per-(round, client) straggler (stale update) prob.")
    ap.add_argument("--nan-rate", type=float, default=0.0,
                    help="per-(round, client) NaN-payload probability")
    ap.add_argument("--inf-rate", type=float, default=0.0,
                    help="per-(round, client) Inf-payload probability")
    ap.add_argument("--fault-from", type=int, default=0,
                    help="first absolute round faults are active (default 0)")
    ap.add_argument("--fault-until", type=int, default=None,
                    help="faults stop at this round (half-open; default: never)")
    ap.add_argument("--no-fault-tolerance", action="store_true",
                    help="inject WITHOUT the masking/quarantine response "
                         "(demonstrates the poisoning failure mode; the "
                         "engine recovers via chunk rollback)")
    ap.add_argument("--fault-tolerance", action="store_true",
                    help="enable the fault-tolerant engine even with all "
                         "fault rates 0 (measures pure masking overhead)")
    ap.add_argument("--max-rollbacks", type=int, default=3,
                    help="chunk-rollback budget before the run fails loudly")


def faults_from_args(args: argparse.Namespace):
    """The ``FaultConfig`` of the fault flags; None (the faults-free engine)
    unless a fault can fire or ``--fault-tolerance`` asks for the masked
    engine with nothing injected."""
    from repro_torch.faults import FaultConfig

    fcfg = FaultConfig(seed=args.fault_seed, drop_rate=args.drop_rate,
                       straggle_rate=args.straggle_rate, nan_rate=args.nan_rate,
                       inf_rate=args.inf_rate, first_round=args.fault_from,
                       last_round=args.fault_until, tolerate=not args.no_fault_tolerance)
    if not fcfg.injects and not args.fault_tolerance:
        return None
    return fcfg


def config_from_args(args: argparse.Namespace, *, dim: int, n_clients: int) -> alg.AlgoConfig:
    """Build AlgoConfig from flags installed by ``add_algo_flags``."""
    kw = {field: getattr(args, flag) for flag, field in _FLAG_FIELDS.items()}
    if getattr(args, "no_factor_cache", False):
        kw["use_factor_cache"] = False
    if getattr(args, "no_defer_repair", False):
        kw["defer_repair"] = False
    return make_config(kw.pop("name"), dim=dim, n_clients=n_clients, **kw)


def make_config(name: str, *, dim: int, n_clients: int, **overrides) -> alg.AlgoConfig:
    """Programmatic twin of ``config_from_args``; an unknown override key
    raises (AlgoConfig is frozen)."""
    return alg.AlgoConfig(name=name, dim=dim, n_clients=n_clients, **overrides)
