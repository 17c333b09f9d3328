"""The port's experiment launcher (port of ``repro.launch.fedzoo``): run
FZooS or a baseline on a synthetic or model-backed objective, on the card
by default.

    # paper Fig. 1 setting (synthetic quadratics, d=300, N=5)
    python -m repro_torch.launch.fedzoo --objective quadratic \\
        --algo fzoos --dim 300 --clients 5 --het 5.0 --rounds 50

    # federated black-box adversarial attack (Sec. 6.2)
    python -m repro_torch.launch.fedzoo --objective attack --clients 10

    # non-differentiable metric optimization (Sec. 6.3)
    python -m repro_torch.launch.fedzoo --objective metric --clients 7

    # FZooS over an architecture-zoo backbone (its SMOKE variant)
    python -m repro_torch.launch.fedzoo --objective lm --arch mamba2-370m

    # checkpoint every chunk boundary; the same command again resumes
    python -m repro_torch.launch.fedzoo --rounds 10 --chunk 5 --ckpt-dir ckpt

    # on the CPU (every kernel wrapper runs its plain torch version)
    python -m repro_torch.launch.fedzoo --device cpu --dim 8 --clients 3

    # faults; without tolerance a poisoned chunk rolls back to its last
    # good step and runs again with tolerance on
    python -m repro_torch.launch.fedzoo --nan-rate 0.1 --no-fault-tolerance \
        --chunk 4 --ckpt-dir ckpt

    # partial participation: a pool of 256 clients, 5 of them a chunk
    python -m repro_torch.launch.fedzoo --pool-size 256 --cohort 5 --chunk 2

Run from the repository root with ``PYTHONPATH=src``.  ``--device``
(default ``cuda``, which raises when no card is present) is the one flag
the reference does not have.  ``--seed`` gives two streams through
``algorithms.stream_seed``: the words ``(seed, 0)`` seed the objective's
draws and ``(seed, 1)`` the run's ``ClientDraws``, as the reference
splits one key into the objective's and the run's.

The attack and the metric train their victims on the run's device and
ignore ``--dim`` and ``--het``, as the reference's do.  ``--objective lm``
builds the SMOKE variant of ``--arch`` with random parameters on the run's
device (``models.init_params`` from the objective's seed) and runs at
d = d_model; the dense, moe, ssm, hybrid and vlm families run, and
whisper (encoder-decoder) exits naming the reference's gap (its forward
needs encoder frames the objective never makes).  ``--arch`` takes the reference's ids and also the
configs' published names (``qwen1.5-0.5b``).  ``--pool-size`` overrides
``--clients``: the objective and the config are built for the pool, and
``--cohort`` clients of it run each chunk.  The run's identity holds the
seed and the objective's arguments, so a resume with another ``--seed``,
``--het``, ``--noise-std``, ``--p-shared`` or ``--arch`` raises instead
of joining two runs.  ``--distributed`` (ROADMAP Queue A, A11) keeps its
place in the command line and exits, naming its item, until it is ported.
"""

from __future__ import annotations

import argparse
import time

import numpy as np

from repro_torch.configs import _norm, get_config
from repro_torch.core import algorithms as alg
from repro_torch.core import model_objectives as mobj
from repro_torch.core import objectives as obj
from repro_torch.device import resolve_device
from repro_torch.launch import common
from repro_torch.models.model import check_ported
from repro_torch.models.params import init_params


def build_objective(args, seed: int, device):
    """(client objectives, query_fn, global_value_fn, dim) of ``--objective``."""
    if args.objective == "quadratic":
        cobjs = obj.make_quadratic(seed, args.clients, args.dim, args.het, args.noise_std,
                                   device=device)
        return cobjs, obj.quadratic_query, obj.quadratic_global_value, args.dim
    if args.objective == "sinquad":
        cobjs = obj.make_sinquad(seed, args.clients, args.dim, args.het, args.noise_std,
                                 device=device)
        return cobjs, obj.sinquad_query, obj.sinquad_global_value, args.dim
    if args.objective == "attack":
        cobjs, _ = mobj.make_attack_objective(seed, args.clients, p_shared=args.p_shared,
                                              device=device)
        return cobjs, mobj.attack_query, mobj.attack_global_value, cobjs.z.shape[-1]
    if args.objective == "metric":
        cobjs, d = mobj.make_metric_objective(seed, args.clients, p_shared=args.p_shared,
                                              device=device)
        return cobjs, mobj.metric_query, mobj.metric_global_value, d
    if args.objective == "lm":
        # the SMOKE variant of --arch, as the reference's launcher builds it
        cfg = get_config(args.arch, "smoke")
        try:
            check_ported(cfg)
        except NotImplementedError as e:
            raise SystemExit(f"--objective lm --arch {args.arch}: {e}") from None
        query, global_value, d, _ = mobj.make_lm_query(cfg, init_params(seed, cfg, device))
        cobjs = mobj.make_lm_objective(seed, cfg, args.clients, device=device)
        return cobjs, query, global_value, d
    raise ValueError(args.objective)


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.launch.fedzoo")
    ap.add_argument("--objective", default="quadratic",
                    choices=["quadratic", "sinquad", "attack", "metric", "lm"])
    common.add_arch_flag(ap)
    ap.add_argument("--dim", type=int, default=300)
    ap.add_argument("--clients", type=int, default=5)
    ap.add_argument("--het", type=float, default=5.0, help="C for synthetic objectives")
    ap.add_argument("--p-shared", type=float, default=0.5, help="P for attack/metric")
    ap.add_argument("--noise-std", type=float, default=0.001)
    ap.add_argument("--rounds", type=int, default=50)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--distributed", action="store_true",
                    help="shard clients over the local devices (not ported yet: A11)")
    ap.add_argument("--device", default="cuda",
                    help="torch device of the run (default cuda; cpu runs the kernels' "
                         "plain torch versions)")
    common.add_algo_flags(ap)
    common.add_engine_flags(ap)
    return ap


def run_identity(args) -> dict:
    """The command line's part of the run identity: the seed and the
    objective's arguments (those ``build_objective`` reads; for ``lm`` the
    architecture, by its module name)."""
    objective = {"objective": args.objective, "clients": args.clients}
    if args.objective in ("quadratic", "sinquad"):
        objective.update(noise_std=args.noise_std, dim=args.dim, het=args.het)
    elif args.objective == "lm":
        objective.update(arch=_norm(args.arch))
    else:
        objective.update(noise_std=args.noise_std, p_shared=args.p_shared)
    return {"seed": args.seed, "objective": objective}


def main(argv=None) -> None:
    args = parser().parse_args(argv)
    pool_size, cohort = common.pool_from_args(args)
    if pool_size is not None:
        args.clients = pool_size  # the pool is the population
    faults = common.faults_from_args(args)
    if args.distributed:
        raise SystemExit("--distributed: the distributed engine is not ported yet "
                         "(ROADMAP Queue A, A11)")
    device = resolve_device(args.device)

    cobjs, query, global_value, dim = build_objective(args, alg.stream_seed(args.seed, 0),
                                                      device)
    print(f"objective={args.objective} dim={dim} clients={args.clients} algo={args.algo}"
          + (f" cohort={cohort}" if cohort is not None else ""))
    cfg = common.config_from_args(args, dim=dim, n_clients=args.clients)
    print(f"queries/round/client = {cfg.queries_per_round()}  "
          f"uplink floats/round/client = {cfg.comm_floats_per_round()}")
    if faults is not None:
        print(f"faults: {faults}")

    t0 = time.time()
    res = alg.simulate(cfg, alg.stream_seed(args.seed, 1), cobjs, query, global_value,
                       args.rounds, chunk=args.chunk, eval_every=args.eval_every,
                       checkpoint_dir=args.ckpt_dir or None, checkpoint_every=args.ckpt_every,
                       async_checkpoint=not args.sync_ckpt, faults=faults,
                       max_rollbacks=args.max_rollbacks, cohort=cohort,
                       cohort_seed=args.cohort_seed, identity=run_identity(args),
                       device=device)
    f = res.f_values.cpu().numpy()
    queries = res.queries.cpu().numpy()
    dt = time.time() - t0

    best = float(np.nanmin(f))  # eval-every leaves NaN rows for skipped rounds
    print(f"F(x_0) = {float(f[0]):+.5f}   F(x_R) = {float(f[-1]):+.5f}   "
          f"best = {best:+.5f}   ({dt:.1f}s, "
          f"{args.rounds / max(dt, 1e-9):.1f} rounds/s)")
    if faults is not None:
        print(f"mean drop_rate = {float(res.drop_rate.mean()):.3f}   "
              f"mean quarantine_rate = {float(res.quarantine_rate.mean()):.3f}")
    stride = max(args.rounds // 10, 1)
    shown = sorted(set(range(0, args.rounds + 1, stride)) | {args.rounds})
    for r in shown:
        q = int(queries[r - 1]) if r > 0 else 0
        print(f"  round {r:4d}  F = {float(f[r]):+.5f}  queries/client = {q}")


if __name__ == "__main__":
    main()
