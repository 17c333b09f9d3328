#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one GPU.

    python3 chip_smoke.py

Phases, each a hard check (any failure exits non-zero):

1. the card: its name, and name and power limit from ``nvidia-smi``;
2. the build: the CUDA kernels are compiled from ``src/repro_torch/kernels/csrc``;
3. every kernel against its plain torch version on inputs built by the
   port's own GP code, with kernel and plain times (CUDA events; and the
   kernel's device time from the profiler) and the least time the card
   could take: the client-batched kernels at the main path's shapes
   (N=5 clients, n=50 candidates, cap=192, d=300; one query point per
   client for the gradient mean), the single-client ones at the per-client
   engine's (one client, the same n, cap and d), the RFF gradient (B5),
   the RFF features (B6) and the SE Gram (B9) at the main path's shapes
   (see ``rff_and_gram_specs``; B9 at an append event of 5 rows and of 1
   row, and at factor_init's init Gram); the cluster kernels of B1 and B3,
   the single-client scoring (B7a) and the cap-tiled scoring (B2, B7b),
   every gradient route (B3, B4, B8a, B8b), B5, B6 and B9 launched twice
   for the same bits (``REPEATED``), B1 and B3 beside the cuBLAS products
   inside them (``cluster_yardsticks``); the cap-tiled scoring and the
   cap-tiled gradient against float64 at large and ragged sizes, each no
   less accurate than its plain version, with its device time against its
   bound at cap 1000 and more (``check_tiled_accuracy``,
   ``check_tiled_grad_accuracy``); the projection's tile kernel (B6 and
   the init Gram) against float64 at the main path's, large, ragged and
   small sizes, no less accurate than its plain version, with its device
   time against its bound (``check_projection_accuracy``);
4. the main path: ``simulate(..., chunk=0)`` (the per-round loop, as every
   phase but 4b runs it) of deferred FZooS at the paper's synthetic
   width (Appx. E.1: d=300, N=5; benchmarks/fig1_synthetic.py full
   settings: M=512, cap=192, T=10, 50 candidates, 5+5 active queries), 5
   rounds on the card, with the kernel launch counts of that run (B5, B6
   and B9 included, ``fzoos_counts``); then the same engine at a small size
   on the card and on the CPU (plain versions) with the same draws, which
   must agree (printed beside it: each side's eigh fallbacks per round and
   the coordinates of x that differ by more than eta/2); B1, B3, B5, B6 and
   B9 on that small engine's own inputs, each no less accurate than its
   plain version against float64 (``check_engine_inputs``), B2 there
   with cap tiles of 8 and B4 with gradient cap tiles of 8;
4b. the main path in captured chunks (``simulate(..., chunk=CHUNK)``,
   ``core/graphs.py``): 10 rounds in chunks of 5, one capture and two
   replays, with the capture's seconds, ms/round over the replays, the
   result and the launches counted at the warm-up round and the capture;
   the same seed and rounds in the loop (``chunk=0``), bit for bit where
   no client is flagged (``hold_to_loop``); one replayed chunk under
   ``torch.profiler``, each ``fz::`` kernel's launches equal to one
   chunk's and the card's busy share; the same 10 rounds in captured
   chunks of 2 bit for bit the same chunks run eagerly, the Cholesky
   factor's strides at init those of an eager boundary
   (``check_chunk_layout``); the whole ``simulate`` call, the
   default (``chunk=None``, captured chunks of 16) against the loop at 10,
   35 and 50 rounds (``time_whole_runs``); the small card-vs-CPU check in
   chunks of 2, captured on the card (the other phases run the loop,
   but for phase 8's second run of each FD baseline);
4c. checkpoint and resume (``core/rounds.py``, ``checkpoint/io.py``):
   phase 4b's 10 rounds in captured chunks of 5 with ``checkpoint_dir``,
   blocking writes, then the background writer: each run bit for bit phase
   4b's; step 10 removed, the resumed run makes one capture and one replay
   and is bit for bit phase 4b's run (every history row, the generators'
   states) and the same run through ``run_rounds`` without checkpoints
   (the final state, read back from step 10); the step's bytes, the
   snapshot's and the write's ms, and the whole ``simulate`` call without
   checkpoints, with blocking writes and with the background writer, in
   ``COST_TURNS`` turns; then the command line, ``python -m
   repro_torch.launch.fedzoo --rounds 10 --chunk 5 --ckpt-dir D`` at its
   defaults (d=300, N=5, M=1000, cap=192), run again with step 10
   removed: the same step 10, arrays and checksums, and the same printed
   F(x_R);
4d. the paper's real-world objectives (``core/model_objectives.py``) at
   the command line's defaults (M=1000, cap=192, T=10, l=0.5, 100
   candidates, 5+5 active queries): the federated black-box attack (N=10,
   P=0.5, 16 x 16 images: d=256) on seeds 0, 1 and 2 and the
   non-differentiable metric (N=7, P=0.5: d=119) on seed 0, 5 rounds each
   in the loop: F finite, exact queries, the deferred engine's launches,
   the objective's build seconds (the victims' training) and ms/round,
   and min F over rounds 1-5 below F(x_0) (the attack) or not above it
   (the metric), ``attack_success`` of the best iterate printed; each on
   seed 0 in captured chunks (10 rounds in chunks of 5) bit for bit its
   loop, and one replayed chunk profiled; ``python -m repro_torch.launch.fedzoo --objective attack
   --clients 10`` and ``--objective metric --clients 7`` at the defaults
   (50 rounds, captured chunks of 16); the small attack engine (d=16, N=3,
   built once on the CPU) on the card against the CPU, and B1, B3, B5, B6
   and B9 on the small attack and metric engines' inputs against float64;
4e. the main path under faults (``faults.FaultConfig``; ``check_faults``):
   ``FAULTS_MIXED`` (every kind) 10 rounds in captured chunks of 5, bit for
   bit the same chunks run eagerly (history, final state and quarantine
   flags, generators), each round's drop and quarantine rates and mean
   queries and each client's final queries those of the host's schedule
   and quarantine rule, F finite with its minimum below F(x_0); the loop,
   bit for bit the chunks up to the first quarantine inside a chunk (the
   loop restarts it after its round, the chunks at the boundary) and
   within the reference's faulted scan-vs-loop bounds after it; every rate
   0 with tolerance against no faults, ms/round over the replays in turns
   (the cost of the masking); a window that never opens, bit for bit no
   faults; no tolerance with every payload NaN: ``FloatingPointError`` in
   chunks, NaN rows in the loop; one replayed faulted chunk profiled
   (``fz::`` launches those of a chunk, device kernels, busy share); the
   small faulted engine (d=8, N=5) on the card against the CPU;
4f. chunk rollback (``check_rollback``): ``ROLLBACK_FAULTS`` (no
   tolerance; a NaN payload in round 9) on the main path, 10 rounds in
   captured chunks of 5 with a ``checkpoint_dir``: the ROLLBACK line at
   the round the host's schedule gives, the restore to the step before,
   tolerance forced on (two captures, three replays), F finite, the
   rolled-back round and the re-run's seconds; bit for bit the same run
   in eager chunks (history, generators);
4g. the client pool (``check_pool``): a pool of ``POOL_N`` = 256 at the
   main path's width, cohorts of ``POOL_K`` = 5, 10 rounds in captured
   chunks of 2: one capture and five replays whatever the cohort, ms/round
   over the replays, the gather and scatter ms per boundary, the pool's
   host bytes, the queries of the cohorts' members, min F below F(x_0);
   bit for bit the same chunks run eagerly (history, the pool, its
   generator states); the kernels' launches those of the dense 5-client
   engine; K = N = 5 bit for bit phase 4b's run; a pooled run without
   tolerance rolled back; the command line with ``--pool-size 256
   --cohort 5``, fault flags and ``--max-rollbacks`` in a child process;
4h. the LM objective (``check_lm``; ``models/``, ``configs/``): Qwen1.5-0.5B
   at full width (``FULL``: 24 layers, d_model=1024, vocab 151,936, bf16,
   random parameters from ``models.init_params``) with N=5 clients of
   ``make_lm_objective``'s batches (2 x 32 tokens) at the command line's
   engine defaults (d = d_model, M=1000, cap=192, T=10, 100 candidates,
   5+5 active queries; B5 takes its chunked route there): 3 rounds in the
   loop (F finite, exact queries, the deferred engine's launches, min F
   not above F(x_0), the build seconds and the parameters' bytes,
   ms/round), 10 rounds in captured chunks of 5 bit for bit the loop
   (``hold_to_loop``) with ms/round over the replays, one replayed chunk
   profiled beside the device time of the round's forward passes and
   their bound at the bf16 peak, B1, B3, B5, B6 and B9 on two loop rounds'
   inputs against float64 (``check_engine_inputs``), the peak of
   ``torch.cuda.max_memory_allocated``; Mamba2-370m ``FULL`` (48 layers)
   2 rounds in the loop and 2 in a captured chunk, bit for bit;
   Qwen2-VL-7B ``FULL`` whole (28 layers, d_model=3584, M-RoPE) and
   Llama-4-Scout at full width with its depth cut to 4 layers (d_model=
   5120, 16 experts of d_ff 8192, top-1 and a shared expert; parameters
   drawn on the card), 2 rounds in the loop and 4 in captured chunks of 2,
   bit for bit; for each one replay profiled beside its forward passes'
   device time and bound (Scout's experts' E x C slots a query counted),
   B2, B4, B5, B6 and B9 (the tuner tiles the cap at these widths) on two
   loop rounds' inputs at d=3584 and 5120, and Scout's share of slots
   dropped in an active-query call; the SMOKE forward and
   objective of every family the objective runs (qwen1.5, mamba2, scout,
   maverick, jamba, qwen2-vl) on the card against the CPU (float32 within
   1e-4, bf16 by ``LM_BF16_MULTIPLE``; a bf16 MoE stack pinned to its
   float64 run's routing, its own routing off it only at near-ties,
   ``layers.flip_margins``); ``python -m
   repro_torch.launch.fedzoo --objective lm --arch A --rounds 10`` for
   each (the SMOKE variant, as the reference's launcher) in child
   processes started together;
4i. serving (``check_serve``; ``prefill``, ``decode_step``, the caches,
   ``launch/serve.py``): Qwen1.5-0.5B and Mamba2-370m ``FULL`` (16 prompts
   of 512 tokens, 128 generated greedily, ``cache_len`` 641) and
   whisper-base ``FULL`` (4 prompts of 32 tokens, 1,500 stub frames, 64
   generated), bf16, random parameters: the build seconds, the prefill's
   ms against its bound, the decode ms a token eagerly and replayed from
   one captured graph (``serve.Decoder``) against a step's bound, tokens/s,
   the capture's seconds, the cache's bytes, the peak memory; the replayed
   tokens and last logits bit for bit the eager loop's; the first decode
   step against ``forward`` at L (exact in float32, the bf16 decode no
   further from the float32 forward than the bf16 forward); every family
   at SMOKE (LM_SMOKE and whisper) on the card against the CPU, the
   prefill's logits and cache leaves, 4 decode steps and the final cache;
   no launch of the port's kernels over the phase; ``python -m
   repro_torch.launch.serve`` for one SMOKE family of each kind
   and Qwen1.5-0.5B ``--variant full`` in child processes started
   together; the phase's seconds;
5. the other route: 2 rounds with the cap tiles pinned below cap, so the
   cap-tiled kernels run;
6. one main-path round under ``torch.profiler``: device time by kernel,
   each of the port's kernels by name, and the device's busy share of the
   round;
7. the per-client engine (``defer_repair=False``) at the main path's width,
   3 rounds, and 1 round on the pinned cap tiles, with exact launch counts
   of the single-client kernels; the small card-vs-CPU check for it and for
   the seed engine (``use_factor_cache=False``); B5, B6, B9, B7a and B8a on
   the small per-client engine's own inputs (``check_engine_inputs``), B7b
   there with cap tiles of 8 and B8b with gradient cap tiles of 8; one of
   its rounds profiled;
8. the FD baselines (fedzo, fedprox, scaffold1, scaffold2) at d=300, N=5,
   q=20, 2 rounds each, with no launch but factor_init's SE Gram; each
   then in its default captured chunk, bit for bit the loop;
9. one JSON line describing every kernel, and the result line.

It imports nothing of JAX or of the JAX package.
"""

from __future__ import annotations

import contextlib
import dataclasses
import functools
import gc
import json
import os
import shutil
import subprocess
import sys
import tempfile
import time
from pathlib import Path
from typing import NamedTuple, Optional

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

#: H100 SXM peaks (NVIDIA data sheet): HBM bytes/s and f32 FLOP/s outside
#: the tensor cores, which is also the f64 tensor cores' rate (the
#: projection's tile kernel; the other kernels run f32 and f64 FMAs).
HBM_BYTES_S = 3.35e12
F32_FLOPS_S = 67e12

# Main path: Appx. E.1 width and the fig1 full settings.
D, N_CLIENTS, CAP, CANDS, M = 300, 5, 192, 50, 512
ROUNDS, OTHER_ROUNDS = 5, 2
#: Kernels phase 3 launches a second time to show the same bits (the
#: cluster kernels, the cap-tiled scoring and every gradient route reduce
#: across blocks in a fixed order, with no atomics; so do the RFF
#: gradient's kernel, the SE Gram's rows kernel and the projection's tile
#: kernel).
REPEATED = ("score_resident", "grad_resident", "rff_grad", "rff_features", "sqexp",
            "sqexp[1 row]", "sqexp[init Gram]", "score_tiled", "score_single_resident",
            "score_single_tiled", "grad_tiled", "grad_single_resident", "grad_single_tiled")
#: Sizes of the cap-tiled scoring's accuracy check (clients, candidates,
#: cap, d, cap tile): one client and five at cap 1000, one at 4096, d=1500,
#: and ragged ones (cap and n not multiples of the tiles), the main path's
#: pinned tile and the small engines' width.
TILED_ACCURACY = ((1, 50, 1000, 300, 256), (1, 50, 4096, 300, 256), (5, 50, 1000, 300, 256),
                  (1, 50, 1024, 1500, 256), (2, 9, 45, 1029, 8), (5, 7, 192, 300, 64),
                  (1, 12, 16, 8, 8))
#: Sizes of the cap-tiled gradient's accuracy check (clients, query points,
#: cap, d, cap tile): as ``TILED_ACCURACY``, with the engines' one query
#: point per client where they take one.
TILED_GRAD_ACCURACY = ((1, 1, 1000, 300, 256), (1, 1, 4096, 300, 256), (5, 1, 1000, 300, 256),
                       (1, 1, 1024, 1500, 256), (2, 7, 45, 1029, 8), (5, 1, 192, 300, 64),
                       (1, 1, 16, 8, 8))
#: Sizes of the projection tile kernel's accuracy check: B6 (rows, M, d)
#: at the main path's 960 rows, at 4096, ragged in all three and at the
#: small engines' width; the SE Gram (clients, rows, cols, d) at
#: factor_init's (5, 192, 192), one client at 1000 and ragged at d=1029.
PROJ_ACCURACY = (("rff_features", 1, 960, 512, 300), ("rff_features", 1, 4096, 512, 300),
                 ("rff_features", 1, 961, 500, 301), ("rff_features", 1, 48, 32, 8),
                 ("sqexp", 5, 192, 192, 300), ("sqexp", 1, 1000, 1000, 300),
                 ("sqexp", 2, 45, 45, 1029))
PER_CLIENT_ROUNDS, FD_ROUNDS = 3, 2
TILE = 64  # the cap tile pinned for the other route


def fail(msg: str) -> None:
    raise SystemExit(f"chip_smoke FAILED: {msg}")


def cuda_ms(fn, reps: int = 100, warmup: int = 10) -> float:
    """Mean device time of ``fn()`` over ``reps`` calls, by CUDA events."""
    for _ in range(warmup):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def device_ms(fn, reps: int = 20) -> float:
    """Device time of the kernels ``fn()`` launches, per call, summed from a
    ``torch.profiler`` trace of ``reps`` calls.  Unlike ``cuda_ms`` it does
    not count the host's time between launches, which bounds ``cuda_ms``
    from below for kernels shorter than a call's Python and ctypes work."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    cuda = torch.autograd.DeviceType.CUDA
    us = sum(e.self_device_time_total for e in prof.key_averages() if e.device_type == cuda)
    return us / 1e3 / reps


def path_inputs(dev, nb=N_CLIENTS, n=CANDS, cap=CAP, d=D):
    """Scoring and gradient-mean inputs as the main path builds them: a
    full ring of points near the iterate, its factor, the masked inverse,
    the centroid-shifted coordinates and candidates in the 0.01 ball; by
    default at the main path's shapes, else at (nb clients, n candidates,
    cap, d) from the same seed."""
    from repro_torch.core import gp_surrogate as gp

    g = torch.Generator(device=dev).manual_seed(0)
    hyper = gp.GPHyper(0.5, 1e-5)
    center = 0.5 + 0.02 * torch.rand(nb, 1, d, generator=g, device=dev)
    walk = 0.01 * torch.randn(nb, cap, d, generator=g, device=dev).cumsum(1) / cap**0.5
    xs = (center + walk).clamp(0, 1)
    ys = torch.randn(nb, cap, generator=g, device=dev)
    traj = gp.Trajectory(xs, ys, torch.full((nb,), cap, dtype=torch.int32, device=dev))
    factor = gp.factor_init(traj, hyper)
    cands = (xs[:, -1:] + 0.01 * (2 * torch.rand(nb, n, d, generator=g, device=dev)
                                  - 1)).clamp(0, 1)
    masks = traj.valid_mask()
    binv = gp.factor_inverse(factor) * (masks[:, :, None] * masks[:, None, :])
    c0 = cands.mean(1)
    xs_sh = ((xs - c0[:, None]) * masks[:, :, None]).contiguous()
    pmat = (binv * (xs_sh @ xs_sh.transpose(-1, -2))).contiguous()
    alpha = gp.gp_alpha_cached_clients(traj, factor).contiguous()
    prior = d / hyper.lengthscale**2
    return dict(cands=(cands - c0[:, None]).contiguous(), xs_sh=xs_sh, binv=binv.contiguous(),
                pmat=pmat, xs=xs.contiguous(), alpha=alpha, query=xs[:, -1:].contiguous(),
                ls=hyper.lengthscale, prior=prior)


def check_kernels(dev):
    """Phase 3: each kernel against its plain version; returns the rows of
    the kernels line (without launch counts)."""
    from repro_torch.kernels import autotune, gp_grad, gp_score, ops, ref

    p = path_inputs(dev)
    ls, prior = p["ls"], p["prior"]
    # block sizes as kernels.ops picks them: the client-batched kernels
    # (their resident route is the cluster kernel) and the single-client ones
    bn_s, _ = autotune.select_blocks("score_clients", n=CANDS, cap=CAP, d=D)
    bn_g, _ = autotune.select_blocks("grad_clients", n=1, cap=CAP, d=D)
    bn_s1, _ = autotune.select_blocks("score", n=CANDS, cap=CAP, d=D)
    bn_g1, _ = autotune.select_blocks("grad", n=1, cap=CAP, d=D)
    pad = lambda bn: ops._pad_axis(p["cands"], 1, -(-CANDS // bn) * bn).contiguous()
    score_args = (pad(bn_s), p["xs_sh"], p["binv"], p["pmat"])
    grad_args = (p["query"], p["xs"], p["alpha"])
    f64 = lambda args: tuple(a.double() for a in args)

    # one client's inputs for the single-client kernels
    score_one = (pad(bn_s1)[0], *(a[0] for a in score_args[1:]))
    grad_one = tuple(a[0] for a in grad_args)
    batched = lambda plain: (lambda a: plain(tuple(t[None] for t in a))[0])

    # bytes and operations of one client; the client-batched kernels do N times as much
    score_bytes = 4 * (2 * CAP * CAP + CAP * D + CANDS * D + CANDS)
    score_flops = CANDS * (2 * CAP * D + 4 * CAP * CAP + 6 * CAP + 2 * D)
    grad_bytes = 4 * (CAP * D + CAP + 2 * D)
    grad_flops = 4 * CAP * D + 6 * CAP + 2 * D
    nc = N_CLIENTS
    specs = [
        ("score_resident", "gp_score.cu", "src/repro/kernels/gp_score.py:180",
         lambda: gp_score.uncertainty_scores_resident(*score_args, lengthscale=ls, prior=prior,
                                                      block_n=bn_s),
         lambda a: ref.uncertainty_scores_clients_fused(*a, ls, prior),
         score_args, nc * score_bytes, nc * score_flops),
        ("score_tiled", "gp_score.cu", "src/repro/kernels/gp_score.py:381",
         lambda: gp_score.uncertainty_scores_tiled(*score_args, lengthscale=ls, prior=prior,
                                                   block_n=bn_s, block_cap=TILE),
         lambda a: gp_score.scores_tiled_plain(*a, ls, prior, TILE),
         score_args, nc * score_bytes, nc * score_flops),
        ("grad_resident", "gp_grad.cu", "src/repro/kernels/gp_grad.py:142",
         lambda: gp_grad.grad_mean_resident(*grad_args, lengthscale=ls, block_n=bn_g),
         lambda a: ref.grad_mean_clients(*a, ls),
         grad_args, nc * grad_bytes, nc * grad_flops),
        ("grad_tiled", "gp_grad.cu", "src/repro/kernels/gp_grad.py:317",
         lambda: gp_grad.grad_mean_tiled(*grad_args, lengthscale=ls, block_n=bn_g,
                                         block_cap=TILE),
         lambda a: gp_grad.grad_mean_tiled_plain(*a, ls, TILE),
         grad_args, nc * grad_bytes, nc * grad_flops),
        ("score_single_resident", "gp_score.cu", "src/repro/kernels/gp_score.py:118",
         lambda: gp_score.uncertainty_scores_single_resident(*score_one, lengthscale=ls,
                                                             prior=prior, block_n=bn_s1),
         lambda a: ref.uncertainty_scores(*a, ls, prior),
         score_one, score_bytes, score_flops),
        ("score_single_tiled", "gp_score.cu", "src/repro/kernels/gp_score.py:298",
         lambda: gp_score.uncertainty_scores_single_tiled(*score_one, lengthscale=ls,
                                                          prior=prior, block_n=bn_s1,
                                                          block_cap=TILE),
         batched(lambda a: gp_score.scores_tiled_plain(*a, ls, prior, TILE)),
         score_one, score_bytes, score_flops),
        ("grad_single_resident", "gp_grad.cu", "src/repro/kernels/gp_grad.py:92",
         lambda: gp_grad.grad_mean_single_resident(*grad_one, lengthscale=ls, block_n=bn_g1),
         lambda a: ref.grad_mean_batch(*a, ls),
         grad_one, grad_bytes, grad_flops),
        ("grad_single_tiled", "gp_grad.cu", "src/repro/kernels/gp_grad.py:242",
         lambda: gp_grad.grad_mean_single_tiled(*grad_one, lengthscale=ls, block_n=bn_g1,
                                                block_cap=TILE),
         batched(lambda a: gp_grad.grad_mean_tiled_plain(*a, ls, TILE)),
         grad_one, grad_bytes, grad_flops),
        *rff_and_gram_specs(dev, p),
    ]
    cluster_yardsticks(p, score_args, grad_args)
    rows = []
    for name, src, replaces, kernel, plain, args, nbytes, flops in specs:
        got = kernel()
        torch.cuda.synchronize()
        want = plain(args)
        truth = plain(f64(args))
        err = (got - want).abs().max().item()
        plain_err = (want.double() - truth).abs().max().item()
        scale = max(truth.abs().max().item(), 1.0)
        # Both are f32 sums of the same terms in other orders: the kernel may
        # differ from the plain version by 3x the plain version's own f32
        # error against float64 (each at most that far from the truth, the
        # kernel allowed twice as far), plus 1e-6 of the output scale.
        tol = 3.0 * plain_err + 1e-6 * scale
        kernel_err = (got.double() - truth).abs().max().item()
        ok = bool(torch.isfinite(got).all()) and got.shape == want.shape and err <= tol
        print(f"[kernel] {name}: shape {tuple(got.shape)} max|kernel-plain|={err:.3e} "
              f"tol={tol:.3e} (plain vs f64 {plain_err:.3e}, kernel vs f64 {kernel_err:.3e}, "
              f"scale {scale:.4g}) {'ok' if ok else 'MISMATCH'}", flush=True)
        if not ok:
            fail(f"{name} disagrees with its plain version")
        if name in REPEATED:  # no float atomics: a second launch gives the same bits
            same = torch.equal(got, kernel())
            print(f"[kernel] {name}: second launch bitwise the same: {same}", flush=True)
            if not same:
                fail(f"{name} gave other bits on a second launch")
        if not nbytes:  # a further shape of a kernel, held but not timed
            continue
        ms = cuda_ms(kernel)
        plain_ms = cuda_ms(lambda: plain(args))
        dev_ms = device_ms(kernel)
        bound_b, bound_f = nbytes / HBM_BYTES_S * 1e3, flops / F32_FLOPS_S * 1e3
        rows.append({
            "name": name, "route": "cuda",
            "source": f"src/repro_torch/kernels/csrc/{src}", "replaces": replaces,
            "launches": 0, "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": max(bound_b, bound_f),
            "bound_by": "bytes" if bound_b >= bound_f else "operations",
            "library_ms": None, "device_ms": dev_ms,
        })
        print(f"[kernel] {name}: {ms:.6f} ms, plain {plain_ms:.6f} ms, bound "
              f"{max(bound_b, bound_f):.6f} ms ({rows[-1]['bound_by']}); device time "
              f"{dev_ms:.6f} ms per call (profiler)", flush=True)
    return rows


def check_tiled_accuracy(dev) -> None:
    """Phase 3, the cap-tiled scoring through ``kernels.ops`` (B7b for one
    client, B2 for more) at each size of ``TILED_ACCURACY`` on
    ``path_inputs`` of that shape: against the plain version on float64
    copies of the same inputs (the truth), the kernel's max error over the
    candidates must be no more than the plain version's on the card (f32).
    Prints each side's max and mean error and the candidates where the
    kernel is further off; at cap 1000 and more also the kernel's device
    time against its bound."""
    from repro_torch.kernels import gp_score, ops

    for nb, n, cap, d, tile in TILED_ACCURACY:
        p = path_inputs(dev, nb, n, cap, d)
        args = (p["cands"], p["xs_sh"], p["binv"], p["pmat"])
        kw = dict(lengthscale=p["ls"], prior=p["prior"], block_cap=tile)
        if nb == 1:
            kernel = lambda: ops.uncertainty_scores(*(a[0] for a in args), **kw)[None]
        else:
            kernel = lambda: ops.uncertainty_scores_clients(*args, **kw)
        got = kernel()
        plain = gp_score.scores_tiled_plain(*args, p["ls"], p["prior"], tile)
        truth = gp_score.scores_tiled_plain(*(a.double() for a in args), p["ls"], p["prior"],
                                            tile)
        k_err, p_err = (got.double() - truth).abs(), (plain.double() - truth).abs()
        ok = (bool(torch.isfinite(got).all()) and got.shape == truth.shape
              and k_err.max().item() <= p_err.max().item())
        print(f"[tiled accuracy] N={nb} n={n} cap={cap} d={d} tile={tile}: max|out-f64| kernel "
              f"{k_err.max().item():.4e} (mean {k_err.mean().item():.4e}), plain "
              f"{p_err.max().item():.4e} (mean {p_err.mean().item():.4e}), largest score "
              f"{truth.max().item():.6g}; kernel further off in {int((k_err > p_err).sum())} of "
              f"{k_err.numel()} candidates; {'ok' if ok else 'LESS ACCURATE'}", flush=True)
        if not ok:
            fail(f"the tiled scoring at N={nb} n={n} cap={cap} d={d} is less accurate than its "
                 "plain version")
        if cap >= 1000:
            nbytes = 4 * nb * (2 * cap * cap + cap * d + n * d + n)
            flops = nb * n * (2 * cap * d + 4 * cap * cap + 6 * cap + 2 * d)
            bound_b, bound_f = nbytes / HBM_BYTES_S * 1e3, flops / F32_FLOPS_S * 1e3
            print(f"[tiled accuracy] N={nb} n={n} cap={cap} d={d} tile={tile}: device time "
                  f"{device_ms(kernel, reps=5):.6f} ms per call (profiler), bound "
                  f"{max(bound_b, bound_f):.6f} ms "
                  f"({'bytes' if bound_b >= bound_f else 'operations'})", flush=True)


def check_tiled_grad_accuracy(dev) -> None:
    """Phase 3, the cap-tiled gradient mean through ``kernels.ops`` (B8b
    for one client, B4 for more) at each size of ``TILED_GRAD_ACCURACY``
    on ``path_inputs`` of that shape, the query points its last rows of xs
    (one: the iterate, as the engines take it): against the tiled plain
    version on float64 copies of the same inputs (the truth), the kernel's
    max error must be no more than the plain version's on the card (f32).
    Prints each side's max and mean error and the elements where the
    kernel is further off; at cap 1000 and more also the kernel's device
    time against its bound."""
    from repro_torch.kernels import gp_grad, ops

    for nb, n, cap, d, tile in TILED_GRAD_ACCURACY:
        p = path_inputs(dev, nb, 1, cap, d)
        args = (p["xs"][:, -n:].contiguous(), p["xs"], p["alpha"])
        kw = dict(lengthscale=p["ls"], block_cap=tile)
        if nb == 1:
            kernel = lambda: ops.grad_mean_batch(*(a[0] for a in args), **kw)[None]
        else:
            kernel = lambda: ops.grad_mean_clients(*args, **kw)
        got = kernel()
        plain = gp_grad.grad_mean_tiled_plain(*args, p["ls"], tile)
        truth = gp_grad.grad_mean_tiled_plain(*(a.double() for a in args), p["ls"], tile)
        k_err, p_err = (got.double() - truth).abs(), (plain.double() - truth).abs()
        ok = (bool(torch.isfinite(got).all()) and got.shape == truth.shape
              and k_err.max().item() <= p_err.max().item())
        print(f"[tiled gradient accuracy] N={nb} n={n} cap={cap} d={d} tile={tile}: max|out-f64| "
              f"kernel {k_err.max().item():.4e} (mean {k_err.mean().item():.4e}), plain "
              f"{p_err.max().item():.4e} (mean {p_err.mean().item():.4e}), largest |grad| "
              f"{truth.abs().max().item():.6g}; kernel further off in {int((k_err > p_err).sum())} "
              f"of {k_err.numel()} elements; {'ok' if ok else 'LESS ACCURATE'}", flush=True)
        if not ok:
            fail(f"the tiled gradient at N={nb} n={n} cap={cap} d={d} is less accurate than its "
                 "plain version")
        if cap >= 1000:
            nbytes = 4 * nb * (cap * d + cap + 2 * n * d)
            flops = nb * n * (4 * cap * d + 6 * cap + 2 * d)
            bound_b, bound_f = nbytes / HBM_BYTES_S * 1e3, flops / F32_FLOPS_S * 1e3
            print(f"[tiled gradient accuracy] N={nb} n={n} cap={cap} d={d} tile={tile}: device "
                  f"time {device_ms(kernel, reps=5):.6f} ms per call (profiler), bound "
                  f"{max(bound_b, bound_f):.6f} ms "
                  f"({'bytes' if bound_b >= bound_f else 'operations'})", flush=True)


def projection_ops() -> dict:
    """{op: (its ``kernels.ops`` call, its plain version)} for the
    ``PROJ_ACCURACY`` ops, at l=0.5 for the SE Gram."""
    from repro_torch.kernels import ops, ref

    return {"rff_features": (ops.rff_features, ref.rff_features),
            "sqexp": (lambda x1, x2: ops.sqexp(x1, x2, 0.5),
                      lambda x1, x2: ref.sqexp(x1, x2, 0.5))}


def projection_inputs(dev, op, nb, rows, cols, d):
    """Inputs of one ``PROJ_ACCURACY`` size: for B6 points in [0, 1]^d
    (rows, d), the bank v ~ N(0, I/l^2) (M, d) at l=0.5 and b in [0, 2 pi)
    (M,); for the SE Gram ``path_inputs``' ring of that shape (points a few
    1e-2 apart near 0.5, where the expanded distance cancels) against
    itself when rows == cols, else its first rows."""
    if op == "sqexp":
        xs = path_inputs(dev, nb, 1, max(rows, cols), d)["xs"]
        return xs[:, :rows].contiguous(), xs[:, :cols].contiguous()
    g = torch.Generator(device=dev).manual_seed(rows + cols + d)
    x = torch.rand(rows, d, generator=g, device=dev)
    v = torch.randn(cols, d, generator=g, device=dev) / 0.5
    b = 2 * torch.pi * torch.rand(cols, generator=g, device=dev)
    return x, v, b


def projection_work(op, nb, rows, cols, d) -> tuple[int, int]:
    """Bytes (each input read once, the output written once) and operations
    of one call of B6 (rows x cols outputs, cols = M) or of the SE Gram (nb
    problems of rows x cols)."""
    if op == "sqexp":
        return 4 * nb * ((rows + cols) * d + rows * cols), nb * (2 * rows * cols * d
                                                                  + 2 * (rows + cols) * d)
    return 4 * (rows * d + cols * d + cols + rows * cols), 2 * rows * cols * d


def check_projection_accuracy(dev) -> None:
    """Phase 3, the projection's tile kernel (B6 ``rff_features``, B9's
    init Gram ``sqexp``) through ``kernels.ops`` at each size of
    ``PROJ_ACCURACY``: against the plain version on float64 copies of the
    same inputs (the truth), the kernel's max error must be no more than
    the plain version's on the card (f32), and a second launch must give
    the same bits.  Prints each side's max and mean error, the elements
    where the kernel is further off, and the kernel's device time against
    its bound."""
    for op, nb, rows, cols, d in PROJ_ACCURACY:
        args = projection_inputs(dev, op, nb, rows, cols, d)
        kernel_fn, plain_fn = projection_ops()[op]
        kernel = lambda: kernel_fn(*args)
        got = kernel()
        plain = plain_fn(*args)
        truth = plain_fn(*(a.double() for a in args))
        k_err, p_err = (got.double() - truth).abs(), (plain.double() - truth).abs()
        same = torch.equal(got, kernel())
        ok = (bool(torch.isfinite(got).all()) and got.shape == truth.shape and same
              and k_err.max().item() <= p_err.max().item())
        size = (f"N={nb} rows={rows} cols={cols} d={d}" if op == "sqexp"
                else f"rows={rows} M={cols} d={d}")
        nbytes, flops = projection_work(op, nb, rows, cols, d)
        bound_b, bound_f = nbytes / HBM_BYTES_S * 1e3, flops / F32_FLOPS_S * 1e3
        print(f"[projection accuracy] {op} {size}: max|out-f64| kernel {k_err.max().item():.4e} "
              f"(mean {k_err.mean().item():.4e}), plain {p_err.max().item():.4e} (mean "
              f"{p_err.mean().item():.4e}), largest |out| {truth.abs().max().item():.6g}; kernel "
              f"further off in {int((k_err > p_err).sum())} of {k_err.numel()} elements; second "
              f"launch bitwise the same: {same}; {'ok' if ok else 'LESS ACCURATE OR NOT REPEATED'}",
              flush=True)
        if not ok:
            fail(f"the projection's tile kernel ({op}, {size}) is less accurate than its plain "
                 "version or gave other bits on a second launch")
        print(f"[projection accuracy] {op} {size}: device time {device_ms(kernel):.6f} ms per call "
              f"(profiler), bound {max(bound_b, bound_f):.6f} ms "
              f"({'bytes' if bound_b >= bound_f else 'operations'})", flush=True)


def cluster_yardsticks(p, score_args, grad_args) -> None:
    """The cuBLAS products inside B1 and B3 at the main path's shapes,
    timed by CUDA events as a yardstick for the cluster kernels (the port
    never calls them; no single library call computes either function):
    for B1 H @ [P | B] (5, 56, 192) x (5, 192, 384) and C @ X^T
    (5, 56, 300) x (5, 300, 192), for B3 (h o alpha) @ X (5, 1, 192) x
    (5, 192, 300)."""
    from repro_torch.kernels import ref

    cands, xs_sh, binv, pmat = score_args
    h = ref._h_cross(cands, xs_sh, p["ls"])[0].contiguous()
    pb = torch.cat([pmat, binv], dim=-1).contiguous()
    xt = xs_sh.transpose(1, 2).contiguous()
    query, xs, alpha = grad_args
    w = (ref._h_cross(query, xs, p["ls"])[0] * alpha[:, None, :]).contiguous()
    for name, what, fn in (
        ("score_resident", "bmm H [P|B]", lambda: torch.bmm(h, pb)),
        ("score_resident", "bmm C X^T", lambda: torch.bmm(cands, xt)),
        ("grad_resident", "bmm (h o alpha) X", lambda: torch.bmm(w, xs)),
    ):
        print(f"[kernel] {name}: yardstick cuBLAS {what} at the same shapes {cuda_ms(fn):.6f} ms "
              f"(events), {device_ms(fn):.6f} ms (profiler)", flush=True)


def rff_and_gram_inputs(dev, p):
    """B5, B6 and B9 inputs at the main path's shapes, from ``path_inputs``'
    ring ``p``: the iterates x_it (5, 300), the bank v (512, 300) and b
    (512,), per-row weights ws (5, 512), the ring xs (5, 192, 300), its
    rows (960, 300), an append event's rows (5, 5, 300) and the iterate's
    (5, 1, 300)."""
    g = torch.Generator(device=dev).manual_seed(1)
    v = (torch.randn(M, D, generator=g, device=dev) / p["ls"]).contiguous()
    b = (2 * torch.pi * torch.rand(M, generator=g, device=dev)).contiguous()
    ws = torch.randn(N_CLIENTS, M, generator=g, device=dev).contiguous()
    xs = p["xs"]
    return (xs[:, -1].contiguous(), v, b, ws, xs, xs.reshape(-1, D).contiguous(),
            xs[:, -5:].contiguous(), xs[:, -1:].contiguous())


def rff_and_gram_specs(dev, p):
    """Phase 3 for B5, B6 and B9 at the main path's shapes: the RFF gradient
    at the N iterates with per-row w (n=5, M=512, d=300), the features of
    the whole ring (5 x 192 rows) and the SE Gram of an append event (5 new
    rows against the (5, 192, 300) ring) and of the iterate's append event
    (1 row) at l=0.5, and factor_init's (5, 192, 192) init Gram of the
    ring.  Also times the cuBLAS product inside each (the yardstick for a
    later redesign; no single library call computes these functions)."""
    from repro_torch.kernels import ref, rff_features, rff_grad, sqexp

    x_it, v, b, ws, xs, rows, k_new, k_one = rff_and_gram_inputs(dev, p)
    ls = p["ls"]
    n, nr, k = N_CLIENTS, N_CLIENTS * CAP, 5
    grad_bytes = 4 * (2 * n * D + M * D + M + n * M)
    gram = lambda a, c: projection_work("sqexp", n, a, c, D)
    for name, fn in (
        ("rff_grad", lambda: torch.addmm(b, x_it, v.T)),
        ("rff_features", lambda: torch.addmm(b, rows, v.T)),
        ("sqexp", lambda: torch.bmm(k_new, xs.transpose(1, 2))),
        ("sqexp[init Gram]", lambda: torch.bmm(xs, xs.transpose(1, 2))),
    ):
        what = "addmm" if name.startswith("rff") else "bmm"
        print(f"[kernel] {name}: its cuBLAS product alone ({what} at the same shapes) "
              f"{cuda_ms(fn):.6f} ms", flush=True)
    return [
        ("rff_grad", "rff_grad.cu", "src/repro/kernels/rff_grad.py:52",
         lambda: rff_grad.rff_grad_rows(x_it, v, b, ws),
         lambda a: ref.rff_grad_rows(*a), (x_it, v, b, ws), grad_bytes, 4 * n * M * D),
        ("rff_features", "rff_features.cu", "src/repro/kernels/rff_features.py:38",
         lambda: rff_features.rff_features(rows, v, b),
         lambda a: ref.rff_features(*a), (rows, v, b),
         *projection_work("rff_features", 1, nr, M, D)),
        ("sqexp", "sqexp.cu", "src/repro/kernels/sqexp.py:33",
         lambda: sqexp.sqexp_clients(k_new, xs, lengthscale=ls),
         lambda a: ref.sqexp(*a, ls), (k_new, xs), *gram(k, CAP)),
        ("sqexp[1 row]", "sqexp.cu", "src/repro/kernels/sqexp.py:33",
         lambda: sqexp.sqexp_clients(k_one, xs, lengthscale=ls),
         lambda a: ref.sqexp(*a, ls), (k_one, xs), *gram(1, CAP)),
        ("sqexp[init Gram]", "sqexp.cu", "src/repro/kernels/sqexp.py:33",
         lambda: sqexp.sqexp_clients(xs, xs, lengthscale=ls),
         lambda a: ref.sqexp(*a, ls), (xs, xs), *gram(CAP, CAP)),
    ]


def fzoos_counts(cfg, rounds) -> dict:
    """B5, B6 and B9 launches of ``rounds`` rounds of any FZooS engine: two
    RFF gradients per local step (on w_global and on w_local), one RFF fit
    per round, and an SE Gram at factor_init and at every append event (the
    iterate and the active queries of each step, the round end's)."""
    t = cfg.local_steps
    return dict(rff_grad=2 * t * rounds, rff_features=rounds, sqexp=1 + (2 * t + 1) * rounds)


def main_config(name="fzoos", **kw):
    from repro_torch.core import algorithms as alg

    return alg.AlgoConfig(
        name=name, dim=D, n_clients=N_CLIENTS, local_steps=10, eta=0.005, q=20,
        fd_lambda=5e-3, n_features=M, traj_capacity=CAP, active_per_iter=5,
        active_candidates=CANDS, active_round_end=5, lengthscale=0.5, noise=1e-5, **kw)


def reset_counts():
    from repro_torch.kernels import gp_grad, gp_score, rff_features, rff_grad, sqexp

    for table in (gp_score.LAUNCHES, gp_grad.LAUNCHES, rff_features.LAUNCHES,
                  rff_grad.LAUNCHES, sqexp.LAUNCHES):
        for k in table:
            table[k] = 0
    sqexp.LAUNCHES_BY_ROWS.clear()


def read_counts() -> dict:
    from repro_torch.kernels import gp_grad, gp_score, rff_features, rff_grad, sqexp

    return {**gp_score.LAUNCHES, **gp_grad.LAUNCHES, **rff_features.LAUNCHES,
            **rff_grad.LAUNCHES, **sqexp.LAUNCHES}


def expect(**counts) -> dict:
    """The launch counts of a run: the named ones, every other kernel 0."""
    return {k: counts.get(k, 0) for k in read_counts()}


def run_path(cfg, cobjs, rounds, dev):
    """``simulate`` with the launch counts set to 0 just before and read just
    after; returns (result, seconds, counts)."""
    from repro_torch.core import algorithms as alg
    from repro_torch.core import objectives as obj

    reset_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = alg.simulate(cfg, 1, cobjs, obj.quadratic_query, obj.quadratic_global_value, rounds,
                       chunk=0, device=dev)
    torch.cuda.synchronize()
    return res, time.perf_counter() - t0, read_counts()


def check_result(res, cfg, rounds, label, must_fall=True):
    """F finite, falling over the run where ``must_fall``, and exactly
    ``queries_per_round()`` queries per client in every round."""
    f = res.f_values.cpu()
    print(f"[{label}] F per round: {[round(v, 6) for v in f.tolist()]}", flush=True)
    print(f"[{label}] queries/client: {res.queries.cpu().tolist()}", flush=True)
    print(f"[{label}] repair rate per round: {res.repair_rate.cpu().tolist()}", flush=True)
    print(f"[{label}] eigh-fallback rate per round: {res.refactor_rate.cpu().tolist()}",
          flush=True)
    if f.shape != (rounds + 1,) or not bool(torch.isfinite(f).all()):
        fail(f"{label}: F is not finite or has the wrong shape")
    if must_fall and not f[-1] < f[0]:
        fail(f"{label}: F did not decrease ({f[0].item()} -> {f[-1].item()})")
    want_q = [float((r + 1) * cfg.queries_per_round()) for r in range(rounds)]
    if res.queries.cpu().tolist() != want_q:
        fail(f"{label}: queries/client {res.queries.cpu().tolist()}, expected {want_q}")


class SameDraws:
    """Replays one draw source's draws on another device (in another
    floating type), so a run on the card and a run on the CPU see the same
    random numbers."""

    def __init__(self, base, device, dtype=torch.float32):
        self.base, self.device, self.dtype = base, device, dtype

    def bank(self, m, d):
        return tuple(t.to(self.device, self.dtype) for t in self.base.bank(m, d))

    def deltas(self, n, d, radius):
        return self.base.deltas(n, d, radius).to(self.device, self.dtype)

    def noise(self, k):
        return self.base.noise(k).to(self.device, self.dtype)


def small_config(dim=8, **engine):
    """The small engine of the card-vs-CPU and engine-input checks: d=8
    (the objective's d for the model-backed ones), N=3, cap=16, M=32, T=3,
    12 candidates, 2+2 active queries."""
    from repro_torch.core import algorithms as alg

    return alg.AlgoConfig(name="fzoos", dim=dim, n_clients=3, local_steps=3, eta=0.01,
                          n_features=32, traj_capacity=16, active_candidates=12,
                          active_per_iter=2, active_round_end=2, lengthscale=0.5, noise=1e-5,
                          **engine)


@functools.lru_cache(maxsize=None)
def small_model_objective(name):
    """The small engines' model-backed objective, built once on the CPU
    (the card's training would give other victims): the attack on 4 x 4
    images (d=16), the metric (d=119, 128 evaluation rows a client); N=3,
    P=0.6 and 64 training images a victim, seed 7.  Returns (objective on
    the CPU, d)."""
    from repro_torch.core import model_objectives as mobj

    if name == "attack":
        cobjs, img = mobj.make_attack_objective(7, 3, p_shared=0.6, side=4, train_per_client=64,
                                                device="cpu")
        return cobjs, img.shape[-1]
    return mobj.make_metric_objective(7, 3, p_shared=0.6, n_eval=128, device="cpu")


def small_objective(where, objective="quadratic"):
    """(objective on ``where``, query, global value, d) of the small
    engines: the quadratic (d=8), or the attack or the metric of
    ``small_model_objective`` moved to ``where``."""
    from repro_torch.core import model_objectives as mobj
    from repro_torch.core import objectives as obj

    if objective == "quadratic":
        return (obj.make_quadratic(0, 3, 8, 5.0, 0.001, device=where), obj.quadratic_query,
                obj.quadratic_global_value, 8)
    cobjs, d = small_model_objective(objective)
    moved = mobj.to(cobjs, where)
    if objective == "attack":
        return moved, mobj.attack_query, mobj.attack_global_value, d
    return moved, mobj.metric_query, mobj.metric_global_value, d


def small_run(where, dtype=torch.float32, objective="quadratic", **engine):
    """``small_config`` 3 rounds on ``where`` on the draws of
    ``ClientDraws(2, ...)`` (made on the CPU, replayed in ``dtype``), on
    ``small_objective``'s objective (the quadratic by default)."""
    from repro_torch.core import algorithms as alg

    cobjs, query, value, d = small_objective(where, objective)
    draws = SameDraws(alg.ClientDraws(2, range(3), "cpu"), where, dtype)
    return alg.simulate(small_config(d, **engine), 2, cobjs, query, value, 3, draws=draws,
                        chunk=0, device=where)


def fallback_events(res, cfg) -> list:
    """Eigh fallbacks of each round, summed over clients, from the history's
    cumulative rate (n_refactors / n_updates, every client updated at each
    append event): the per-client engine's inline fallbacks, the deferred
    engine's repairs; the seed engine keeps no factor (0)."""
    per_round = cfg.local_steps * (1 + (cfg.active_per_iter > 0)) + (cfg.active_round_end > 0)
    totals = [0] + [round(rate * cfg.n_clients * per_round * (r + 1))
                    for r, rate in enumerate(res.refactor_rate.cpu().tolist())]
    return [b - a for a, b in zip(totals, totals[1:])]


def check_small_against_cpu(dev, label="small", objective="quadratic", **engine):
    """An engine on the card (kernels) and on the CPU (plain versions) on
    the same small input and draws: F within 1e-3, x within 1e-2 per round,
    the bound tests/test_torch_algorithms.py holds the port to against the
    JAX reference.  ``objective`` as ``small_run``'s."""
    cfg = small_config(small_objective("cpu", objective)[3], **engine)
    cpu = small_run("cpu", objective=objective, **engine)
    gpu = small_run(dev, objective=objective, **engine)
    df = (cpu.f_values - gpu.f_values.cpu()).abs().max().item()
    dx = (cpu.xs - gpu.xs.cpu()).abs().max().item()
    print(f"[{label}] card vs CPU on the same draws: max|dF|={df:.3e} max|dx|={dx:.3e}",
          flush=True)
    for side, res in (("CPU", cpu), ("card", gpu)):
        print(f"[{label}] {side} eigh fallbacks per round: {fallback_events(res, cfg)}",
              flush=True)
    far = ((cpu.xs - gpu.xs.cpu()).abs() > cfg.eta / 2).sum(-1).tolist()
    print(f"[{label}] coordinates with |dx| > eta/2 per round: {far}", flush=True)
    if not (df <= 1e-3 and dx <= 1e-2) or not torch.equal(cpu.queries, gpu.queries.cpu()):
        fail("the engine on the card disagrees with the engine on the CPU")


@contextlib.contextmanager
def recording(names):
    """Within the block, every call of ``kernels.ops.<name>`` for the names
    given is recorded, keyword arguments included, with its output (all
    cloned); yields {name: [(args, kwargs, out), ...]}."""
    from repro_torch.kernels import ops

    real = {name: getattr(ops, name) for name in names}
    calls = {name: [] for name in names}

    def recorder(name):
        def call(*args, **kwargs):
            out = real[name](*args, **kwargs)
            keep = lambda a: a.clone() if torch.is_tensor(a) else a
            calls[name].append((tuple(map(keep, args)), kwargs, out.clone()))
            return out
        return call

    try:
        for name in names:
            setattr(ops, name, recorder(name))
        yield calls
    finally:
        for name in names:
            setattr(ops, name, real[name])


def check_engine_inputs(dev, label="engine inputs", objective="quadratic", run=None,
                        **engine) -> dict:
    """B5, B6, B9 and the scoring and gradient-mean ops (B1/B3 on the
    deferred engine, B7a/B8a on the per-client one; B2/B7b with
    ``score_block_cap`` pinned below cap, B4/B8b with ``grad_block_cap``)
    on the inputs the small engine of ``check_small_against_cpu`` gives
    them: every call of one
    card run is recorded, keyword arguments included, with the kernel's
    output, then the kernel's output and its plain version's on the card
    are held against a float64 evaluation of the same call.  A kernel less
    accurate than its plain version over the run (max error over the
    calls) fails; so is printed the eq. 8 correction, the difference of
    each step's two B5 calls.  ``objective`` as ``small_run``'s; ``run``, a
    function of no arguments, runs another card engine in its place (phase
    4h: the LM engine at full width).  Returns the recorded calls of each
    op."""
    from repro_torch.kernels import gp_grad, gp_score, ref

    plain = {
        "rff_features": lambda x, v, b: ref.rff_features(
            x.reshape(-1, x.shape[-1]), v, b).reshape(*x.shape[:-1], v.shape[0]),
        "rff_grad_rows": ref.rff_grad_rows,
        "sqexp": ref.sqexp,
        # the block pins (block_n, block_cap) choose a route, not the function;
        # a cap tile below cap (pinned, or the tuner's at a wide d) is held
        # against the tiled route's plain version, the same sum in its tiles
        "uncertainty_scores_clients": lambda *a, lengthscale, prior, block_cap=None, **_:
            gp_score.scores_tiled_plain(*a, lengthscale, prior, tile)
            if (tile := route_cap("score_clients", a[0].shape[-2], a[1].shape[-2],
                                  a[0].shape[-1], block_cap)) < a[1].shape[-2]
            else ref.uncertainty_scores_clients_fused(*a, lengthscale, prior),
        "grad_mean_clients": lambda *a, lengthscale, block_cap=None, **_:
            gp_grad.grad_mean_tiled_plain(*a, lengthscale, tile)
            if (tile := route_cap("grad_clients", a[0].shape[-2], a[1].shape[-2],
                                  a[0].shape[-1], block_cap)) < a[1].shape[-2]
            else ref.grad_mean_clients(*a, lengthscale),
        "uncertainty_scores": lambda *a, lengthscale, prior, block_cap=None, **_:
            gp_score.scores_tiled_plain(*(t[None] for t in a), lengthscale, prior, block_cap)[0]
            if block_cap and block_cap < a[1].shape[-2]
            else ref.uncertainty_scores(*a, lengthscale, prior),
        "grad_mean_batch": lambda *a, lengthscale, block_cap=None, **_:
            gp_grad.grad_mean_tiled_plain(*(t[None] for t in a), lengthscale, block_cap)[0]
            if block_cap and block_cap < a[1].shape[-2]
            else ref.grad_mean_batch(*a, lengthscale),
    }
    with recording(plain) as calls:
        if run is None:
            small_run(dev, objective=objective, **engine)
        else:
            run()
    f64 = lambda args: [a.double() if torch.is_tensor(a) else a for a in args]
    for name, recs in calls.items():
        if not recs:
            print(f"[{label}] {name}: 0 calls", flush=True)
            continue
        k_err, p_err = [], []
        for args, kwargs, out in recs:
            truth = plain[name](*f64(args), **kwargs)
            k_err.append((out.double() - truth).abs().max().item())
            p_err.append((plain[name](*args, **kwargs).double() - truth).abs().max().item())
        worse = sum(k > p for k, p in zip(k_err, p_err))
        print(f"[{label}] {name}: {len(recs)} calls, max|out-f64| kernel {max(k_err):.3e} "
              f"(mean {sum(k_err) / len(k_err):.3e}), plain on the card {max(p_err):.3e} "
              f"(mean {sum(p_err) / len(p_err):.3e}); kernel less accurate in {worse} calls",
              flush=True)
        if max(k_err) > max(p_err):
            fail(f"{label}: {name} is less accurate than its plain version on the engine's inputs")
    pairs = calls["rff_grad_rows"]
    k_err, p_err = [], []
    for (ag, _, yg), (al, _, yl) in zip(pairs[0::2], pairs[1::2]):
        truth = plain["rff_grad_rows"](*f64(ag)) - plain["rff_grad_rows"](*f64(al))
        k_err.append(((yg - yl).double() - truth).abs().max().item())
        diff = plain["rff_grad_rows"](*ag) - plain["rff_grad_rows"](*al)
        p_err.append((diff.double() - truth).abs().max().item())
    print(f"[{label}] eq. 8 correction (w_global call - w_local call): max|out-f64| kernel "
          f"{max(k_err):.3e}, plain on the card {max(p_err):.3e}", flush=True)
    return calls


def profile_round(cfg, cobjs, dev, label="profile") -> None:
    """One round under ``torch.profiler``: device time by kernel (top 25)
    and device busy time against the round's wall time."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.core import algorithms as alg
    from repro_torch.core import objectives as obj

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        alg.simulate(cfg, 3, cobjs, obj.quadratic_query, obj.quadratic_global_value, 1,
                     chunk=0, device=dev)
        torch.cuda.synchronize()
        wall_ms = 1e3 * (time.perf_counter() - t0)
    events = prof.key_averages()
    kernels = [e for e in events if e.device_type == torch.autograd.DeviceType.CUDA]
    busy_ms = sum(e.self_device_time_total for e in kernels) / 1e3
    launches = sum(e.count for e in kernels)
    print(events.table(sort_by="self_device_time_total", row_limit=25), flush=True)
    for e in kernels:  # the port's own kernels by name, wherever they rank
        name = e.key.split("(")[0].removeprefix("void ")
        if name.startswith("fz::"):
            print(f"[{label}] {name}: {e.count} launches, "
                  f"{e.self_device_time_total / 1e3:.3f} ms device", flush=True)
    print(f"[{label}] one round: wall {wall_ms:.3f} ms (profiled), device busy {busy_ms:.3f} ms "
          f"({100 * busy_ms / wall_ms:.1f}%), {launches} device kernels", flush=True)


#: The captured phase: the main path in chunks of CHUNK rounds, one capture
#: and CAPTURED_ROUNDS / CHUNK replays; the small card-vs-CPU check in
#: chunks of SMALL_CHUNK (3 rounds: one full chunk and a shorter one).
CAPTURED_ROUNDS, CHUNK, SMALL_CHUNK = 10, 5, 2
COST_TURNS = 3  # phase 4c: whole calls a mode, in turns
#: The port's kernels by the name the profiler gives them (``fz::<name><...>``)
#: and the counter of the wrapper that launches them on the main path.
FZ_KERNELS = {"score_cluster_kernel": "score_resident", "grad_cluster_kernel": "grad_resident",
              "rff_grad_kernel": "rff_grad", "proj_tile_kernel": "rff_features",
              "proj_rows_kernel": "sqexp"}


def route_cap(kind, n, cap, d, block_cap=None) -> int:
    """The cap tile the kernel wrappers take for ``kind`` at these shapes:
    ``block_cap`` where pinned, else the tuner's (the resident route when
    it is ``cap``, the cap-tiled one below it)."""
    from repro_torch.kernels import autotune

    return block_cap or autotune.select_blocks(kind, n=n, cap=cap, d=d)[1]


def deferred_counts(cfg, rounds) -> dict:
    """Launches of ``rounds`` rounds of the deferred engine, factor_init's
    SE Gram not included: ``fzoos_counts`` less that Gram, the scoring (B1,
    or B2 where the tuner tiles the cap: d=3584 and 5120 at cap 192) once
    per local step and at the round end, the gradient mean (B3, or B4) once
    per local step."""
    t, cap, d = cfg.local_steps, cfg.traj_capacity, cfg.dim
    counts = fzoos_counts(cfg, rounds)
    counts["sqexp"] -= 1
    tiled = lambda kind, n, pin: route_cap(kind, n, cap, d, pin) < cap
    score = ("score_tiled" if tiled("score_clients", cfg.active_candidates, cfg.score_block_cap)
             else "score_resident")
    grad = "grad_tiled" if tiled("grad_clients", 1, cfg.grad_block_cap) else "grad_resident"
    return dict(counts, **{score: (t + 1) * rounds, grad: t * rounds})


@contextlib.contextmanager
def timed_chunks(profile_replays=False):
    """Within the block, every capture and every replay of
    ``graphs.CapturedChunks`` is timed on the host between two
    synchronizations, the capture apart from its first replay; with
    ``profile_replays`` each replay runs under ``torch.profiler`` (its
    trace kept).  Yields {"capture": [s], "replay": [s], "profiles": [prof]}."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.core import graphs

    real_graph, real_run = graphs.CapturedChunks.graph, graphs.CapturedChunks.run
    log = {"capture": [], "replay": [], "profiles": []}

    def graph(self, length):
        if length in self._graphs:
            return real_graph(self, length)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = real_graph(self, length)
        torch.cuda.synchronize()
        log["capture"].append(time.perf_counter() - t0)
        return out

    def run(self, length, offset):
        self.graph(length)
        torch.cuda.synchronize()
        prof = (profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
                if profile_replays else contextlib.nullcontext())
        with prof:
            t0 = time.perf_counter()
            ys = real_run(self, length, offset)
            torch.cuda.synchronize()
            log["replay"].append(time.perf_counter() - t0)
        if profile_replays:
            log["profiles"].append(prof)
        return ys

    try:
        graphs.CapturedChunks.graph, graphs.CapturedChunks.run = graph, run
        yield log
    finally:
        graphs.CapturedChunks.graph, graphs.CapturedChunks.run = real_graph, real_run


def gen_states(draws) -> list:
    """The states of a ``ClientDraws``'s generators (clients', then the bank's)."""
    return [g.get_state() for g in (*draws.gens, draws.bank_gen)]


def hold_to_loop(loop, res, label, loop_draws=None, res_draws=None) -> None:
    """A chunked run against the loop (``chunk=0``) on the same seed and
    rounds.  Where neither run flagged a client the chunks are the loop's
    operations on the loop's numbers, so the two must be equal bit for bit
    (and, where the draw sources are given, every generator left in the
    same state: the replays drew what the loop drew).  With flagged
    clients the repairs fall at other rounds, and the reference's
    scan-vs-loop bounds hold (tests/test_rounds.py ``_assert_bounded``: x
    after round 1 within 5e-2, every x within 0.1, F within 5e-2, queries
    identical)."""
    df = (loop.f_values - res.f_values).abs().max().item()
    dx = (loop.xs - res.xs).abs().max().item()
    dx1 = (loop.xs[1] - res.xs[1]).abs().max().item()
    same = all(torch.equal(a, b) for a, b in zip(loop, res))
    flagged = max(loop.repair_rate.abs().max().item(), res.repair_rate.abs().max().item()) > 0
    gens_same = (loop_draws is None or all(
        torch.equal(a, b) for a, b in zip(gen_states(loop_draws), gen_states(res_draws))))
    print(f"[{label}] against the loop (chunk=0), same seed and rounds: max|dF|={df:.3e} "
          f"max|dx|={dx:.3e} (round 1: {dx1:.3e}); bitwise equal: {same}; clients flagged: "
          f"{flagged}" + ("" if loop_draws is None else f"; generators in the same state: "
                          f"{gens_same}"), flush=True)
    if not gens_same:
        fail(f"{label}: the chunked run's generators are not where the loop's are")
    if not flagged and not same:
        fail(f"{label}: no client flagged, yet the chunked run is not the loop bit for bit")
    if not (df <= 5e-2 and dx <= 0.1 and dx1 <= 5e-2) or not torch.equal(loop.queries,
                                                                          res.queries):
        fail(f"{label}: the chunked run disagrees with the loop beyond the reference's "
             "scan-vs-loop bounds")


def check_captured(cfg, cobjs, dev) -> None:
    """Phase 4b: the main path in captured chunks.  ``simulate(...,
    rounds=CAPTURED_ROUNDS, chunk=CHUNK)``: one capture and two replays,
    the capture's seconds and ms/round over the replays; the launches the
    wrappers counted (the warm-up round and the capture); the result
    (``check_result``); then the loop (``chunk=0``) on the same seed and
    rounds (``hold_to_loop``); then one
    replayed chunk under ``torch.profiler``: each ``fz::`` kernel's
    launches against one chunk's (``deferred_counts``) and the card's busy
    share of the replay."""
    from repro_torch.core import algorithms as alg
    from repro_torch.core import graphs
    from repro_torch.core import objectives as obj

    sim = lambda rounds, chunk, draws=None: alg.simulate(
        cfg, 1, cobjs, obj.quadratic_query, obj.quadratic_global_value, rounds, chunk=chunk,
        draws=draws, device=dev)
    main_draws = lambda: alg.ClientDraws(1, range(N_CLIENTS), dev)  # simulate's own, seed 1
    draws = main_draws()
    reset_counts()
    graphs.COUNTS.update(captures=0, replays=0)
    with timed_chunks() as log:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = sim(CAPTURED_ROUNDS, CHUNK, draws)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
    counts, runs = read_counts(), dict(graphs.COUNTS)
    ms_round = 1e3 * sum(log["replay"]) / CAPTURED_ROUNDS
    print(f"[captured] d={D} N={N_CLIENTS} M={M} cap={CAP} T={cfg.local_steps}: "
          f"{CAPTURED_ROUNDS} rounds in chunks of {CHUNK} in {secs:.3f} s; {runs['captures']} "
          f"capture(s) in {sum(log['capture']):.3f} s; replays "
          f"{[round(1e3 * s, 3) for s in log['replay']]} ms, {ms_round:.3f} ms/round over the "
          f"replays; launches counted at the warm-up round and the capture {counts}", flush=True)
    check_result(res, cfg, CAPTURED_ROUNDS, "captured")
    if runs != {"captures": 1, "replays": CAPTURED_ROUNDS // CHUNK}:
        fail(f"captured: {runs}, expected 1 capture and {CAPTURED_ROUNDS // CHUNK} replays")
    warm_and_capture = deferred_counts(cfg, 1 + CHUNK)
    want = expect(**dict(warm_and_capture, sqexp=warm_and_capture["sqexp"] + 1))
    if counts != want:
        fail(f"captured: launches {counts}, expected {want} (factor_init, the warm-up round "
             "and the capture)")

    loop_draws = main_draws()
    hold_to_loop(sim(CAPTURED_ROUNDS, 0, loop_draws), res, "captured", loop_draws, draws)

    with timed_chunks(profile_replays=True) as plog:
        sim(CHUNK, CHUNK)
    prof, wall_ms = plog["profiles"][0], 1e3 * plog["replay"][0]
    events = prof.key_averages()
    kernels = [e for e in events if e.device_type == torch.autograd.DeviceType.CUDA]
    busy_ms = sum(e.self_device_time_total for e in kernels) / 1e3
    print(events.table(sort_by="self_device_time_total", row_limit=20), flush=True)
    seen = {}
    for e in kernels:
        name = e.key.split("(")[0].removeprefix("void ")
        if name.startswith("fz::"):
            base = FZ_KERNELS.get(name.removeprefix("fz::").split("<")[0], name)
            seen[base] = seen.get(base, 0) + e.count
            print(f"[captured profile] {name}: {e.count} launches, "
                  f"{e.self_device_time_total / 1e3:.3f} ms device", flush=True)
    print(f"[captured profile] one replayed chunk of {CHUNK} rounds: wall {wall_ms:.3f} ms "
          f"(profiled), device busy {busy_ms:.3f} ms ({100 * busy_ms / wall_ms:.1f}%), "
          f"{sum(e.count for e in kernels)} device kernels", flush=True)
    chunk_want = {k: v for k, v in deferred_counts(cfg, CHUNK).items() if v}
    if seen != chunk_want:
        fail(f"captured profile: fz:: launches {seen} in one replay, expected {chunk_want}")
    return res, draws, secs


#: Chunk length of the layout check: short chunks meet the most boundaries.
LAYOUT_CHUNK = 2


def check_chunk_layout(cfg, cobjs, dev) -> None:
    """Phase 4b: the main path's ``CAPTURED_ROUNDS`` rounds in captured
    chunks of ``LAYOUT_CHUNK`` against the same chunks run eagerly on the
    same draws, and the Cholesky factor's strides at init and at the eager
    run's first boundary.  A captured chunk replays on static buffers laid
    out as the initial state; eager chunks start from the layouts the last
    chunk left, and an eager round's arithmetic follows its inputs'
    strides: the two runs are the same bits only where the layouts agree.
    Prints both and max|dx| per round, with the card's name and power
    limit, then fails unless the runs agree bit for bit and the strides
    are the same.  Uses only ``simulate``, ``init_states`` and
    ``rounds.repair_flagged_clients``, so it also measures an older
    tree's ``repro_torch`` (imported first)."""
    from repro_torch.core import algorithms as alg
    from repro_torch.core import objectives as obj
    from repro_torch.core import rounds

    x0 = torch.full((cfg.dim,), 0.5, dtype=torch.float32, device=dev)
    strides = {"init": list(alg.init_states(cfg, x0).factor.chol.stride())}
    real = rounds.repair_flagged_clients

    def first_boundary(states, c):
        strides.setdefault("eager boundary", list(states.factor.chol.stride()))
        return real(states, c)

    eager_type = type("EagerDraws", (alg.ClientDraws,), {})
    runs = {}
    for mode, draws in (("captured", alg.ClientDraws(1, range(cfg.n_clients), dev)),
                        ("eager", eager_type(1, range(cfg.n_clients), dev))):
        rounds.repair_flagged_clients = first_boundary if mode == "eager" else real
        try:
            runs[mode] = alg.simulate(cfg, 1, cobjs, obj.quadratic_query,
                                      obj.quadratic_global_value, CAPTURED_ROUNDS,
                                      chunk=LAYOUT_CHUNK, draws=draws, device=dev)
        finally:
            rounds.repair_flagged_clients = real
    a, b = runs["captured"], runs["eager"]
    out = {"bitwise": bitwise(a, b),
           "max_dx_per_round": [(a.xs[r] - b.xs[r]).abs().max().item()
                                for r in range(a.xs.shape[0])],
           "chol_strides": strides}
    print(f"[layout] {card_name()}: captured against eager chunks of {LAYOUT_CHUNK}, "
          f"{CAPTURED_ROUNDS} rounds: bitwise {out['bitwise']}; max|dx| per round "
          f"{[f'{v:.3e}' for v in out['max_dx_per_round']]}; Cholesky factor strides "
          f"{strides}", flush=True)
    if not (out["bitwise"] and strides["init"] == strides["eager boundary"]):
        fail(f"layout: captured chunks of {LAYOUT_CHUNK} are not their eager chunks bit for "
             f"bit, or the factor's layout moves: {out}")


#: Round counts of the whole-run timing: the captured phase's, the full
#: run of benchmarks/fig1_synthetic.py (the main path's settings) and the
#: paper's 50.
WHOLE_RUN_ROUNDS = (CAPTURED_ROUNDS, 35, 50)


def time_whole_runs(cfg, cobjs, dev) -> None:
    """Phase 4b: the whole ``simulate`` call on the main path, the
    default (``chunk=None``: chunks of ``DEFAULT_CHUNK``, captured; its
    warm-up round, captures, replays and boundary reads included) against
    the loop (``chunk=0``), in the order loop, default, default, loop at
    each of ``WHOLE_RUN_ROUNDS``: seconds of each call on the host clock
    between two synchronizations, the default's captures and replays; each
    default run held to its loop (``hold_to_loop``)."""
    from repro_torch.core import algorithms as alg
    from repro_torch.core import graphs, rounds as rounds_mod
    from repro_torch.core import objectives as obj

    for n_rounds in WHOLE_RUN_ROUNDS:
        secs, res = {0: [], None: []}, {}
        for chunk in (0, None, None, 0):
            graphs.COUNTS.update(captures=0, replays=0)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            res[chunk] = alg.simulate(cfg, 1, cobjs, obj.quadratic_query,
                                      obj.quadratic_global_value, n_rounds, chunk=chunk,
                                      device=dev)
            torch.cuda.synchronize()
            secs[chunk].append(time.perf_counter() - t0)
            if chunk is None:
                runs = dict(graphs.COUNTS)
        k = min(rounds_mod.DEFAULT_CHUNK, n_rounds)
        lengths = {k, n_rounds % k} - {0}
        want = {"captures": len(lengths), "replays": -(-n_rounds // k)}
        per = lambda ts: [round(1e3 * t / n_rounds, 3) for t in ts]
        print(f"[whole run] {n_rounds} rounds: loop (chunk=0) {[round(t, 3) for t in secs[0]]} s "
              f"({per(secs[0])} ms/round); default (chunk=None, chunks of {k}, "
              f"{runs['captures']} capture(s), {runs['replays']} replays) "
              f"{[round(t, 3) for t in secs[None]]} s ({per(secs[None])} ms/round); "
              f"default / loop {sum(secs[None]) / sum(secs[0]):.3f}", flush=True)
        if runs != want:
            fail(f"whole run of {n_rounds} rounds: {runs}, expected {want}")
        hold_to_loop(res[0], res[None], f"whole run {n_rounds}")


def check_small_captured(dev) -> None:
    """Phase 4b: the small card-vs-CPU check in chunks of SMALL_CHUNK: on the
    card captured, on its own ``ClientDraws(2, ...)``; on the CPU the eager
    chunks, replaying a second card ``ClientDraws(2, ...)`` through
    ``SameDraws``.  The bounds of ``check_small_against_cpu``."""
    from repro_torch.core import algorithms as alg
    from repro_torch.core import graphs
    from repro_torch.core import objectives as obj

    def run(where, draws):
        q = obj.make_quadratic(0, 3, 8, 5.0, 0.001, device=where)
        return alg.simulate(small_config(), 2, q, obj.quadratic_query,
                            obj.quadratic_global_value, 3, draws=draws, chunk=SMALL_CHUNK,
                            device=where)

    graphs.COUNTS.update(captures=0, replays=0)
    gpu = run(dev, alg.ClientDraws(2, range(3), dev))
    runs = dict(graphs.COUNTS)
    cpu = run("cpu", SameDraws(alg.ClientDraws(2, range(3), dev), "cpu"))
    df = (cpu.f_values - gpu.f_values.cpu()).abs().max().item()
    dx = (cpu.xs - gpu.xs.cpu()).abs().max().item()
    print(f"[small captured] chunks of {SMALL_CHUNK}, {runs}: card (captured) vs CPU (eager) on "
          f"the same draws: max|dF|={df:.3e} max|dx|={dx:.3e}", flush=True)
    if runs != {"captures": 2, "replays": 2}:
        fail(f"small captured: {runs}, expected 2 captures (chunks of 2 and 1) and 2 replays")
    if not (df <= 1e-3 and dx <= 1e-2) or not torch.equal(cpu.queries, gpu.queries.cpu()):
        fail("the captured engine on the card disagrees with the eager engine on the CPU")


@contextlib.contextmanager
def timed_checkpoints():
    """Within the block, every ``prepare_round_state`` (the host snapshot,
    after a synchronization) and every ``write_round_state`` (the files, on
    the writer thread where the write is async) is timed on the host
    clock.  Yields {"snapshot": [s], "write": [s], "bytes": [n]}, ``bytes``
    the snapshot's arrays."""
    from repro_torch.checkpoint import io as ckpt_io

    real_prepare, real_write = ckpt_io.prepare_round_state, ckpt_io.write_round_state
    log = {"snapshot": [], "write": [], "bytes": []}

    def prepare(*args, **kwargs):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        payload = real_prepare(*args, **kwargs)
        log["snapshot"].append(time.perf_counter() - t0)
        log["bytes"].append(sum(a.nbytes for a in payload["arrays"].values()))
        return payload

    def write(*args, **kwargs):
        t0 = time.perf_counter()
        out = real_write(*args, **kwargs)
        log["write"].append(time.perf_counter() - t0)
        return out

    try:
        ckpt_io.prepare_round_state, ckpt_io.write_round_state = prepare, write
        yield log
    finally:
        ckpt_io.prepare_round_state, ckpt_io.write_round_state = real_prepare, real_write


def step_files(root, step) -> tuple[dict, dict]:
    """(arrays, meta) of one checkpoint step, read with numpy and json."""
    path = Path(root) / f"step_{step:08d}"
    with np.load(path / "arrays.npz", allow_pickle=False) as data:
        arrays = {k: data[k].copy() for k in data.files}
    return arrays, json.loads((path / "meta.json").read_text())


def same_arrays(a: dict, b: dict) -> bool:
    return a.keys() == b.keys() and all(
        (a[k].dtype, a[k].shape, a[k].tobytes()) == (b[k].dtype, b[k].shape, b[k].tobytes())
        for k in a)


def bitwise(a, b) -> bool:
    return all(torch.equal(x, y) for x, y in zip(a, b))


def check_checkpoint(cfg, cobjs, dev, straight, straight_draws, straight_secs) -> None:
    """Phase 4c: checkpoint and resume on the main path in captured chunks,
    then through the command line (see the module docstring)."""
    from repro_torch.checkpoint import io as ckpt_io
    from repro_torch.core import algorithms as alg
    from repro_torch.core import graphs
    from repro_torch.core import objectives as obj
    from repro_torch.core import rff as rfflib
    from repro_torch.core import rounds as rounds_mod

    main_draws = lambda: alg.ClientDraws(1, range(N_CLIENTS), dev)  # phase 4b's, seed 1
    straight_gens = straight_draws.state()

    x0 = torch.full((D,), 0.5, dtype=torch.float32, device=dev)

    def plain():
        """Phase 4b's run once more, through run_rounds as simulate calls it,
        for its final state (simulate returns the history only) and its
        time; returns (final state, seconds)."""
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        draws = main_draws()
        rff = rfflib.make_rff(draws, cfg.n_features, cfg.dim, cfg.lengthscale)
        final, hist = rounds_mod.run_rounds(
            cfg, rff, obj.quadratic_query, cobjs, alg.init_states(cfg, x0), x0,
            obj.quadratic_global_value, CAPTURED_ROUNDS, CHUNK, draws=draws)
        torch.cuda.synchronize()
        if not bitwise(hist, straight):
            fail("checkpoint: run_rounds is not phase 4b's simulate bit for bit")
        return final, time.perf_counter() - t0

    final, plain_secs = plain()
    boundary = {"snapshot": [], "write": []}

    def sim(root, draws, async_write):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = alg.simulate(cfg, 1, cobjs, obj.quadratic_query, obj.quadratic_global_value,
                           CAPTURED_ROUNDS, chunk=CHUNK, draws=draws, checkpoint_dir=root,
                           async_checkpoint=async_write, device=dev)
        torch.cuda.synchronize()
        return res, time.perf_counter() - t0

    for mode, async_write in (("blocking", False), ("async", True)):
        with tempfile.TemporaryDirectory() as root:
            draws = main_draws()
            with timed_checkpoints() as clog:
                res, secs = sim(root, draws, async_write)
            steps = ckpt_io.list_steps(root)
            arrays, meta = step_files(root, CAPTURED_ROUNDS)
            npz_bytes = (Path(root) / f"step_{CAPTURED_ROUNDS:08d}" / "arrays.npz").stat().st_size
            print(f"[checkpoint {mode}] {CAPTURED_ROUNDS} rounds in captured chunks of {CHUNK} "
                  f"with checkpoint_dir: steps {steps}; a step {clog['bytes'][-1]} bytes of "
                  f"arrays ({npz_bytes} bytes of npz); snapshot "
                  f"{[round(1e3 * t, 3) for t in clog['snapshot']]} ms, write "
                  f"{[round(1e3 * t, 3) for t in clog['write']]} ms; the whole call "
                  f"{secs:.3f} s against {plain_secs:.3f} s without checkpoints here "
                  f"({secs / plain_secs:.3f}x) and phase 4b's {straight_secs:.3f} s",
                  flush=True)
            if steps != [CHUNK, CAPTURED_ROUNDS]:
                fail(f"checkpoint {mode}: steps {steps}, expected {[CHUNK, CAPTURED_ROUNDS]}")
            if not bitwise(res, straight) or not bitwise(draws.state(), straight_gens):
                fail(f"checkpoint {mode}: the checkpointed run is not phase 4b's bit for bit")
            for k in boundary:
                boundary[k] += clog[k]

            shutil.rmtree(Path(root) / f"step_{CAPTURED_ROUNDS:08d}")
            graphs.COUNTS.update(captures=0, replays=0)
            draws = main_draws()
            with timed_checkpoints() as rlog:
                resumed, rsecs = sim(root, draws, async_write)
            for k in boundary:
                boundary[k] += rlog[k]
            runs = dict(graphs.COUNTS)
            again, again_meta = step_files(root, CAPTURED_ROUNDS)
            s_like = graphs.clone(final)
            h_like = rounds_mod.history_init(CAPTURED_ROUNDS, x0, torch.zeros((), device=dev))
            r_states, _, _, _ = ckpt_io.restore_round_state(root, s_like, h_like,
                                                            draws_like=draws.state())
            same = {"history": bitwise(resumed, straight),
                    "generators": bitwise(draws.state(), straight_gens),
                    "final state": bitwise(graphs.tensors(r_states), graphs.tensors(final)),
                    "step 10": same_arrays(arrays, again)
                    and meta["checksums"] == again_meta["checksums"]}
            print(f"[checkpoint {mode}] step {CAPTURED_ROUNDS} removed, resumed from step "
                  f"{CHUNK}: {runs}, {rsecs:.3f} s (snapshot "
                  f"{[round(1e3 * t, 3) for t in rlog['snapshot']]} ms, write "
                  f"{[round(1e3 * t, 3) for t in rlog['write']]} ms); bit for bit phase 4b's "
                  f"uncheckpointed run: {same}", flush=True)
            if runs != {"captures": 1, "replays": 1}:
                fail(f"checkpoint {mode}: the resume made {runs}, expected 1 capture and 1 "
                     "replay")
            if not all(same.values()):
                fail(f"checkpoint {mode}: the resumed run is not the run without a stop bit "
                     f"for bit: {same}")
    # The whole call in turns, each mode through simulate, after the runs
    # above have warmed every path: one call a mode is within the spread
    # of such calls, so the cost is read from COST_TURNS calls a mode.
    turns = {"without": [], "blocking": [], "async": []}
    for _ in range(COST_TURNS):
        for mode in turns:
            with tempfile.TemporaryDirectory() as root, timed_checkpoints() as tlog:
                res, secs = sim(None if mode == "without" else root, main_draws(),
                                mode == "async")
            if not bitwise(res, straight):
                fail(f"checkpoint cost: the {mode} run is not phase 4b's bit for bit")
            turns[mode].append(secs)
            for k in boundary:
                boundary[k] += tlog[k]
    med = lambda ts: sorted(ts)[len(ts) // 2]
    ms = lambda ts: round(1e3 * med(ts), 3)
    n_bounds = CAPTURED_ROUNDS // CHUNK
    per_call = n_bounds * (med(boundary["snapshot"]) + med(boundary["write"]))
    print(f"[checkpoint cost] {card_name()}: the whole simulate call of {CAPTURED_ROUNDS} "
          f"rounds in captured chunks of {CHUNK}, {COST_TURNS} turns of (without, blocking, "
          f"background): without checkpoints {[round(t, 3) for t in turns['without']]} s, "
          f"blocking writes {[round(t, 3) for t in turns['blocking']]} s, background writes "
          f"{[round(t, 3) for t in turns['async']]} s; medians {ms(turns['without'])} / "
          f"{ms(turns['blocking'])} / {ms(turns['async'])} ms, blocking - without "
          f"{round(1e3 * (med(turns['blocking']) - med(turns['without'])), 3)} ms against "
          f"{n_bounds} boundaries x (snapshot + write) = {round(1e3 * per_call, 3)} ms; the "
          f"{len(boundary['write'])} written boundaries of this phase: snapshot median "
          f"{ms(boundary['snapshot'])} ms, write median {ms(boundary['write'])} ms",
          flush=True)
    check_cli_resume()


#: Phase 4e: the main path under the reference's fault model.  The mixed
#: configuration (every kind; a straggler and a NaN payload among the 5
#: clients in round 1, quarantines in rounds 1, 3, 7 and 8), and the small
#: faulted engine's clients and rounds (drops, stragglers and a NaN
#: payload in 5 rounds).
FAULTS_MIXED = dict(seed=3, drop_rate=0.2, straggle_rate=0.1, nan_rate=0.05, inf_rate=0.05)
SMALL_FAULT_N, SMALL_FAULT_ROUNDS = 5, 5


def fault_expectations(fcfg, rounds, n, chunk, per_round):
    """What the tolerant engine must report under ``fcfg``, from the host's
    ``schedule_table`` and the quarantine rule alone: a client whose update
    is not finite (nan or inf, not dropped, not straggling) is quarantined
    until the boundary (every ``chunk`` rounds; every round in the loop,
    ``chunk=0``); a client is live when not dropped, not quarantined before
    the round and its update finite; a dropped, straggling or quarantined
    client's state (its query count too) rolls back.  Returns per round
    the drop rate, the quarantine rate and the mean queries over live
    clients, as float32 (true divisions, as the port's), and each client's
    queries at the end (``per_round`` queries a completed round)."""
    from repro_torch.faults import schedule_table

    tab = schedule_table(fcfg, rounds, n)
    quar, done = np.zeros(n, bool), np.zeros(n, np.int64)
    f32 = np.float32
    drop, quarantine, queries = [], [], []
    for r in range(rounds):
        poisoned = (tab["nan"][r] | tab["inf"][r]) & ~tab["straggle"][r]
        live = ~tab["drop"][r] & ~quar & ~poisoned
        quar = quar | poisoned
        done += ~(tab["drop"][r] | tab["straggle"][r] | quar)
        counts = per_round * done
        drop.append(f32(n - live.sum()) / f32(n))
        quarantine.append(f32(quar.sum()) / f32(n))
        queries.append(f32(counts[live].sum()) / f32(max(live.sum(), 1)))
        if chunk == 0 or (r + 1) % chunk == 0:
            quar = np.zeros(n, bool)
    return (np.array(drop, np.float32), np.array(quarantine, np.float32),
            np.array(queries, np.float32), per_round * done)


def check_fault_history(res, fcfg, cfg, rounds, chunk, label, final_queries=None) -> None:
    """A tolerant faulted run's history against ``fault_expectations``:
    each round's drop and quarantine rates and mean queries exactly, each
    client's final queries (exact integers) where given; F finite, and its
    minimum over rounds 1..R below F(x_0)."""
    drop, quar, queries, counts = fault_expectations(fcfg, rounds, cfg.n_clients, chunk,
                                                     cfg.queries_per_round())
    f = res.f_values.cpu()
    print(f"[{label}] F per round: {[round(v, 6) for v in f.tolist()]}", flush=True)
    print(f"[{label}] drop rate {res.drop_rate.cpu().tolist()}, quarantine rate "
          f"{res.quarantine_rate.cpu().tolist()}, mean queries of live clients "
          f"{res.queries.cpu().tolist()}", flush=True)
    if not (np.array_equal(res.drop_rate.cpu().numpy(), drop)
            and np.array_equal(res.quarantine_rate.cpu().numpy(), quar)
            and np.array_equal(res.queries.cpu().numpy(), queries)):
        fail(f"{label}: rates or queries are not the schedule's (expected drop {drop.tolist()}, "
             f"quarantine {quar.tolist()}, queries {queries.tolist()})")
    if final_queries is not None:
        got = final_queries.cpu().tolist()
        print(f"[{label}] each client's queries at the end: {got} (expected "
              f"{counts.tolist()})", flush=True)
        if got != counts.tolist():
            fail(f"{label}: final queries {got}, expected {counts.tolist()}")
    if f.shape != (rounds + 1,) or not bool(torch.isfinite(f).all()):
        fail(f"{label}: F is not finite or has the wrong shape")
    if not f[1:].min() < f[0]:
        fail(f"{label}: min F over rounds 1-{rounds} {f[1:].min().item()} is not below "
             f"F(x_0) {f[0].item()}")


def check_faults(cfg, cobjs, dev) -> None:
    """Phase 4e: the main path under faults (``simulate(..., faults=...)``).

    The mixed configuration, ``CAPTURED_ROUNDS`` rounds: in captured chunks
    of ``CHUNK`` (one capture, two replays; the launches counted at the
    warm-up round and the capture; ms/round over the replays) against the
    same chunks run eagerly on the same draws, bit for bit (every history
    row, the final state with its quarantine flags, the generators); each
    run's rates and queries against ``fault_expectations``; then the loop
    (``chunk=0``), which restarts a quarantined client after its round
    where the chunks wait for the boundary: bit for bit the chunks up to
    the first round whose quarantine falls inside a chunk, after it within
    the reference's faulted scan-vs-loop bounds (tests/test_faults.py: x
    0.1, F 5e-2).  Then: every rate 0 with tolerance (the masked engine,
    nothing injected) beside the same run without faults, in turns; a
    window that never opens, bit for bit the run without faults; no
    tolerance with every payload NaN, which raises ``FloatingPointError``
    in chunks and gives NaN rows in the loop; one replayed faulted chunk
    under ``torch.profiler``; the small faulted engine on the card and on
    the CPU on the same draws."""
    from repro_torch.core import algorithms as alg
    from repro_torch.core import graphs
    from repro_torch.core import objectives as obj
    from repro_torch.core import rff as rfflib
    from repro_torch.core import rounds as rounds_mod
    from repro_torch.faults import FaultConfig, schedule_table

    card = card_name()
    mixed = FaultConfig(**FAULTS_MIXED)
    eager_draws_type = type("EagerDraws", (alg.ClientDraws,), {})  # by the capture rule eager
    x0 = torch.full((D,), 0.5, dtype=torch.float32, device=dev)

    def chunked(draws, faults, rounds=CAPTURED_ROUNDS, chunk=CHUNK):
        """``simulate``'s chunked path, returning the final state too."""
        rff = rfflib.make_rff(draws, cfg.n_features, cfg.dim, cfg.lengthscale)
        return rounds_mod.run_rounds(cfg, rff, obj.quadratic_query, cobjs, alg.init_states(cfg, x0),
                                     x0, obj.quadratic_global_value, rounds, chunk, draws=draws,
                                     faults=faults)

    def timed(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, time.perf_counter() - t0

    # the mixed configuration in captured chunks, then eagerly
    draws = alg.ClientDraws(1, range(N_CLIENTS), dev)
    reset_counts()
    graphs.COUNTS.update(captures=0, replays=0)
    with timed_chunks() as log:
        (states, res), secs = timed(lambda: chunked(draws, mixed))
    counts, runs = read_counts(), dict(graphs.COUNTS)
    fault_ms = 1e3 * sum(log["replay"]) / CAPTURED_ROUNDS
    print(f"[faults] {card}: {mixed}; d={D} N={N_CLIENTS} M={M} cap={CAP} T={cfg.local_steps}: "
          f"{CAPTURED_ROUNDS} rounds in chunks of {CHUNK} in {secs:.3f} s; {runs['captures']} "
          f"capture(s) in {sum(log['capture']):.3f} s; replays "
          f"{[round(1e3 * t, 3) for t in log['replay']]} ms, {fault_ms:.3f} ms/round over the "
          f"replays; launches counted at the warm-up round and the capture {counts}", flush=True)
    if runs != {"captures": 1, "replays": CAPTURED_ROUNDS // CHUNK}:
        fail(f"faults: {runs}, expected 1 capture and {CAPTURED_ROUNDS // CHUNK} replays")
    warm_and_capture = deferred_counts(cfg, 1 + CHUNK)
    # factor_init's SE Gram of the run's clients and of the quarantine
    # reset's fresh-client template
    want = expect(**dict(warm_and_capture, sqexp=warm_and_capture["sqexp"] + 2))
    if counts != want:
        fail(f"faults: launches {counts}, expected {want} (factor_init, the reset's template, "
             "the warm-up round and the capture)")
    check_fault_history(res, mixed, cfg, CAPTURED_ROUNDS, CHUNK, "faults captured",
                        states.queries)

    eager_draws = eager_draws_type(1, range(N_CLIENTS), dev)
    (eager_states, eager), eager_secs = timed(lambda: chunked(eager_draws, mixed))
    same_hist = all(torch.equal(a, b) for a, b in zip(res, eager))
    same_state = all(torch.equal(a, b) for a, b in zip(graphs.tensors(states),
                                                         graphs.tensors(eager_states)))
    same_gens = all(torch.equal(a, b) for a, b in zip(gen_states(draws), gen_states(eager_draws)))
    print(f"[faults eager] the same chunks run eagerly on the same draws in {eager_secs:.3f} s: "
          f"history bitwise {same_hist}, final state (quarantine flags "
          f"{eager_states.quarantined.tolist()}) bitwise {same_state}, generators in the same "
          f"state {same_gens}", flush=True)
    if not (same_hist and same_state and same_gens
            and torch.equal(states.quarantined, eager_states.quarantined)):
        fail("faults: the captured chunks are not the eager chunks bit for bit")

    loop_draws = alg.ClientDraws(1, range(N_CLIENTS), dev)
    loop, loop_secs = timed(lambda: alg.simulate(
        cfg, 1, cobjs, obj.quadratic_query, obj.quadratic_global_value, CAPTURED_ROUNDS, chunk=0,
        draws=loop_draws, device=dev, faults=mixed))
    print(f"[faults loop] {CAPTURED_ROUNDS} rounds in {loop_secs:.3f} s", flush=True)
    check_fault_history(loop, mixed, cfg, CAPTURED_ROUNDS, 0, "faults loop")
    tab = schedule_table(mixed, CAPTURED_ROUNDS, N_CLIENTS)
    inside = [r for r in range(CAPTURED_ROUNDS) if (r + 1) % CHUNK
              and ((tab["nan"][r] | tab["inf"][r]) & ~tab["straggle"][r]).any()]
    flagged = [r for r in range(CAPTURED_ROUNDS) if (r + 1) % CHUNK
               and max(loop.repair_rate[r].item(), res.repair_rate[r].item()) > 0]
    split = min(inside + flagged, default=CAPTURED_ROUNDS)
    rows_same = (torch.equal(loop.xs[:split + 2], res.xs[:split + 2])
                 and torch.equal(loop.f_values[:split + 2], res.f_values[:split + 2])
                 and all(torch.equal(a[:split + 1], b[:split + 1])
                         for a, b in zip(loop[2:], res[2:])))
    df = (loop.f_values - res.f_values).abs().max().item()
    dx = (loop.xs - res.xs).abs().max().item()
    gens_same = all(torch.equal(a, b) for a, b in zip(gen_states(loop_draws), gen_states(draws)))
    print(f"[faults loop] against the captured chunks: quarantines inside a chunk in rounds "
          f"{[r + 1 for r in inside]}, clients flagged inside a chunk in rounds "
          f"{[r + 1 for r in flagged]}; bitwise through round {split + 1}: {rows_same}; after it "
          f"max|dF|={df:.3e} max|dx|={dx:.3e}; generators in the same state: {gens_same}",
          flush=True)
    if not (rows_same and gens_same and df <= 5e-2 and dx <= 0.1):
        fail("faults: the loop disagrees with the captured chunks")

    # every rate 0 with tolerance against no faults; a window that never opens
    zero = FaultConfig()
    ms = {"none": [], "zero": []}
    plain = None
    for mode in ("none", "zero", "zero", "none"):
        with timed_chunks() as zlog:
            out = chunked(alg.ClientDraws(1, range(N_CLIENTS), dev),
                          None if mode == "none" else zero)[1]
        ms[mode].append(1e3 * sum(zlog["replay"]) / CAPTURED_ROUNDS)
        if mode == "none":
            plain = out
        else:
            check_fault_history(out, zero, cfg, CAPTURED_ROUNDS, CHUNK, "faults zero rates")
    med = {k: float(np.median(v)) for k, v in ms.items()}
    print(f"[faults masking] {card}: ms/round over the replays, in turns (none, zero, zero, "
          f"none): without faults {[round(v, 3) for v in ms['none']]}, every rate 0 with "
          f"tolerance {[round(v, 3) for v in ms['zero']]}; the masking costs "
          f"{med['zero'] - med['none']:.3f} ms/round ({100 * (med['zero'] / med['none'] - 1):.2f}%"
          f"); the mixed configuration {fault_ms:.3f} ms/round", flush=True)
    late = FaultConfig(**dict(FAULTS_MIXED, first_round=100))
    off = chunked(alg.ClientDraws(1, range(N_CLIENTS), dev), late)[1]
    same_off = all(torch.equal(a, b) for a, b in zip(plain, off))
    print(f"[faults window] {late} over {CAPTURED_ROUNDS} rounds: bit for bit the run without "
          f"faults: {same_off}", flush=True)
    if not same_off:
        fail("faults: a window that never opens is not the faults-free run bit for bit")

    # no tolerance: raises in chunks, NaN rows in the loop
    poison = FaultConfig(nan_rate=1.0, tolerate=False)
    try:
        chunked(alg.ClientDraws(1, range(N_CLIENTS), dev), poison)
        fail("faults: no tolerance with every payload NaN did not raise in chunks")
    except FloatingPointError as e:
        print(f"[faults intolerant] {poison} in captured chunks raised FloatingPointError: {e}",
              flush=True)
    nan_loop = alg.simulate(cfg, 1, cobjs, obj.quadratic_query, obj.quadratic_global_value,
                            CAPTURED_ROUNDS, chunk=0, device=dev, faults=poison)
    nan_rows = torch.isnan(nan_loop.xs).all(-1).tolist()
    print(f"[faults intolerant] the same in the loop: rows of x that are NaN {nan_rows}, F "
          f"{[round(v, 6) for v in nan_loop.f_values.cpu().tolist()]}", flush=True)
    if nan_rows != [False] + [True] * CAPTURED_ROUNDS or not torch.isnan(
            nan_loop.f_values[1:]).all():
        fail("faults: the intolerant loop does not give NaN rows from round 1")

    # one replayed faulted chunk under the profiler
    with timed_chunks(profile_replays=True) as plog:
        chunked(alg.ClientDraws(1, range(N_CLIENTS), dev), mixed, rounds=CHUNK)
    prof, wall_ms = plog["profiles"][0], 1e3 * plog["replay"][0]
    kernels = [e for e in prof.key_averages() if e.device_type == torch.autograd.DeviceType.CUDA]
    busy_ms = sum(e.self_device_time_total for e in kernels) / 1e3
    seen = {}
    for e in kernels:
        name = e.key.split("(")[0].removeprefix("void ")
        if name.startswith("fz::"):
            base = FZ_KERNELS.get(name.removeprefix("fz::").split("<")[0], name)
            seen[base] = seen.get(base, 0) + e.count
    top = sorted(kernels, key=lambda e: -e.self_device_time_total)[:6]
    print(f"[faults profile] {card}: one replayed faulted chunk of {CHUNK} rounds: wall "
          f"{wall_ms:.3f} ms (profiled), device busy {busy_ms:.3f} ms "
          f"({100 * busy_ms / wall_ms:.1f}%), {sum(e.count for e in kernels)} device kernels; "
          f"fz:: launches {seen}; most device time: "
          + "; ".join(f"{e.key[:48]} x{e.count} {e.self_device_time_total / 1e3:.3f} ms"
                      for e in top), flush=True)
    chunk_want = {k: v for k, v in deferred_counts(cfg, CHUNK).items() if v}
    if seen != chunk_want:
        fail(f"faults profile: fz:: launches {seen} in one replay, expected {chunk_want}")

    check_small_faulted(dev)


def check_small_faulted(dev) -> None:
    """Phase 4e: the small engine (d=8, ``SMALL_FAULT_N`` clients) under the
    mixed configuration, ``SMALL_FAULT_ROUNDS`` rounds of the loop, on the
    card and on the CPU on the same draws: the rule of
    ``check_small_against_cpu`` (F within 1e-3, x within 1e-2, the same
    queries) and the same drop and quarantine rates."""
    import dataclasses

    from repro_torch.core import algorithms as alg
    from repro_torch.core import objectives as obj
    from repro_torch.faults import FaultConfig, schedule_table

    cfg = dataclasses.replace(small_config(), n_clients=SMALL_FAULT_N)
    fcfg = FaultConfig(**FAULTS_MIXED)

    def run(where):
        q = obj.make_quadratic(0, SMALL_FAULT_N, 8, 5.0, 0.001, device=where)
        draws = SameDraws(alg.ClientDraws(2, range(SMALL_FAULT_N), "cpu"), where)
        return alg.simulate(cfg, 2, q, obj.quadratic_query, obj.quadratic_global_value,
                            SMALL_FAULT_ROUNDS, draws=draws, chunk=0, device=where, faults=fcfg)

    cpu, gpu = run("cpu"), run(dev)
    df = (cpu.f_values - gpu.f_values.cpu()).abs().max().item()
    dx = (cpu.xs - gpu.xs.cpu()).abs().max().item()
    tab = {k: v.sum(1).tolist()
           for k, v in schedule_table(fcfg, SMALL_FAULT_ROUNDS, SMALL_FAULT_N).items()}
    print(f"[small faults] d=8 N={SMALL_FAULT_N}, {SMALL_FAULT_ROUNDS} rounds, faults per round "
          f"{tab}: card vs CPU on the same draws: max|dF|={df:.3e} max|dx|={dx:.3e}; "
          f"quarantine rate {gpu.quarantine_rate.cpu().tolist()}", flush=True)
    same_rates = all(torch.equal(getattr(cpu, f), getattr(gpu, f).cpu())
                     for f in ("queries", "drop_rate", "quarantine_rate"))
    if not (df <= 1e-3 and dx <= 1e-2) or not same_rates:
        fail("the faulted engine on the card disagrees with the faulted engine on the CPU")


#: Phase 4f: chunk rollback at the main path's width.  Without tolerance a
#: NaN payload in round 9 poisons the chunk of rounds 6-10 (schedule of
#: seed 4 at 5 clients, from ``schedule_table``): the run rolls back to
#: step 5 and runs rounds 6-10 again with tolerance on.
ROLLBACK_FAULTS = dict(seed=4, nan_rate=0.05, tolerate=False)


def rollback_expectations(fcfg, rounds, chunk, n, cohorts=None):
    """The (round of the fault, round restored) of the first rollback that
    ``fcfg`` causes in a run of ``rounds`` rounds in chunks of ``chunk``
    checkpointed at every boundary (``cohorts``: chunk start -> the pool
    ids that run it), from the host's ``schedule_table``: the first chunk
    with a NaN or inf payload that is not a straggler's; None if none."""
    from repro_torch.faults import schedule_table

    tab = schedule_table(fcfg, rounds, n)
    poisoned = (tab["nan"] | tab["inf"]) & ~tab["straggle"]
    for start in range(0, rounds, chunk):
        ids = slice(None) if cohorts is None else cohorts[start]
        if poisoned[start:start + chunk][:, ids].any():
            return min(start + chunk, rounds), start
    return None


@contextlib.contextmanager
def rollback_log():
    """Within the block, the lines the round drivers print, the host time of
    each rollback and the step each restore of the dense or the pooled
    driver returned (``rounds.newest_good``).  Yields {"lines": [str],
    "at": [s], "restored": [step]}."""
    import io as _io

    from repro_torch.core import rounds as rounds_mod

    real, real_newest = rounds_mod.rollback_or_raise, rounds_mod.newest_good
    log = {"lines": [], "at": [], "restored": []}

    def stamped(*args, **kwargs):
        torch.cuda.synchronize()
        log["at"].append(time.perf_counter())
        return real(*args, **kwargs)

    def newest(checkpoint_dir, run_meta, restore, *args, **kwargs):
        def logged(step):
            out = restore(step)
            log["restored"].append(step)
            return out
        return real_newest(checkpoint_dir, run_meta, logged, *args, **kwargs)

    buf = _io.StringIO()
    try:
        rounds_mod.rollback_or_raise, rounds_mod.newest_good = stamped, newest
        with contextlib.redirect_stdout(buf):
            yield log
    finally:
        rounds_mod.rollback_or_raise, rounds_mod.newest_good = real, real_newest
        log["lines"] += [ln for ln in buf.getvalue().splitlines()
                         if ln.startswith("[repro_torch.")]
        for ln in log["lines"]:
            print(ln, flush=True)


def check_rollback(cfg, cobjs, dev) -> None:
    """Phase 4f: ``ROLLBACK_FAULTS`` (no tolerance) on the main path,
    ``CAPTURED_ROUNDS`` rounds in captured chunks of ``CHUNK`` with a
    ``checkpoint_dir``: the ROLLBACK line at the schedule's round, the
    restore to the step before, tolerance forced on (the turned run
    captured afresh: two captures), F finite; bit for bit the same run in
    eager chunks on the card (every history row, every generator); the
    rolled-back round and the re-run's seconds, the card's name and power
    limit beside them."""
    from repro_torch.core import algorithms as alg
    from repro_torch.core import graphs
    from repro_torch.core import objectives as obj
    from repro_torch.faults import FaultConfig

    card = card_name()
    fcfg = FaultConfig(**ROLLBACK_FAULTS)
    want = rollback_expectations(fcfg, CAPTURED_ROUNDS, CHUNK, N_CLIENTS)
    if want is None:
        fail(f"rollback: {fcfg} poisons no chunk of {CAPTURED_ROUNDS} rounds")
    eager_draws_type = type("EagerDraws", (alg.ClientDraws,), {})
    # the turned run is captured afresh; a replay for every chunk started
    replays = (len(range(0, want[0], CHUNK)) + len(range(want[1], CAPTURED_ROUNDS, CHUNK)))
    runs = {}
    for mode, draws in (("captured", alg.ClientDraws(1, range(N_CLIENTS), dev)),
                        ("eager", eager_draws_type(1, range(N_CLIENTS), dev))):
        graphs.COUNTS.update(captures=0, replays=0)
        with tempfile.TemporaryDirectory() as root, rollback_log() as log:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            res = alg.simulate(cfg, 1, cobjs, obj.quadratic_query, obj.quadratic_global_value,
                               CAPTURED_ROUNDS, chunk=CHUNK, draws=draws, checkpoint_dir=root,
                               faults=fcfg, device=dev)
            torch.cuda.synchronize()
            t1 = time.perf_counter()
        runs[mode] = (res, draws)
        rerun = t1 - log["at"][0] if log["at"] else float("nan")
        f = res.f_values.cpu()
        print(f"[rollback {mode}] {card}: {fcfg}; d={D} N={N_CLIENTS} M={M} cap={CAP}: "
              f"{CAPTURED_ROUNDS} rounds in chunks of {CHUNK} with checkpoint_dir in "
              f"{t1 - t0:.3f} s; {dict(graphs.COUNTS)}; rolled back at round {want[0]} to "
              f"step {log['restored']}, the re-run {rerun:.3f} s; F "
              f"{[round(v, 6) for v in f.tolist()]}", flush=True)
        lines = [ln.split("] ", 1)[1] for ln in log["lines"]]
        expect_lines = [f"ROLLBACK 1/3 at round {want[0]} (non-finite server iterate): "
                        "restoring last good checkpoint",
                        "re-running with fault tolerance FORCED ON"]
        if lines != expect_lines:
            fail(f"rollback {mode}: printed {lines}, expected {expect_lines}")
        if log["restored"] != [want[1]]:
            fail(f"rollback {mode}: restored step(s) {log['restored']}, expected [{want[1]}] "
                 "(the boundary before the poisoned chunk)")
        if not (bool(torch.isfinite(res.xs).all()) and bool(torch.isfinite(f).all())):
            fail(f"rollback {mode}: the rolled-back run is not finite")
        counts = {"captures": 2, "replays": replays} if mode == "captured" else {
            "captures": 0, "replays": 0}
        if dict(graphs.COUNTS) != counts:
            fail(f"rollback {mode}: {dict(graphs.COUNTS)}, expected {counts} (without and "
                 "with tolerance)")
    (cap, cap_draws), (eager, eager_draws) = runs["captured"], runs["eager"]
    same = {"history": bitwise(cap, eager),
            "generators": bitwise(gen_states(cap_draws), gen_states(eager_draws))}
    print(f"[rollback] captured against eager chunks on the card: {same}", flush=True)
    if not all(same.values()):
        fail(f"rollback: the captured rolled-back run is not the eager one bit for bit: {same}")


#: Phase 4g: the client pool at the main path's width.  N=256 (the pool of
#: the reference's benchmarks/rounds_bench.py, BENCH_rounds.json), a cohort
#: of K=5, POOL_ROUNDS rounds in captured chunks of POOL_CHUNK, cohort seed
#: 0; a pooled run without tolerance whose NaN payloads roll it back.
POOL_N, POOL_K, POOL_ROUNDS, POOL_CHUNK = 256, 5, 10, 2
POOL_FAULTS = dict(seed=5, nan_rate=0.1, tolerate=False)


@contextlib.contextmanager
def timed_pool():
    """Within the block, every ``ClientPool.gather`` and ``scatter`` timed
    on the host between two synchronizations.  Yields {"gather": [s],
    "scatter": [s]}."""
    from repro_torch.core import pool as pool_mod

    real = {k: getattr(pool_mod.ClientPool, k) for k in ("gather", "scatter")}
    log = {k: [] for k in real}

    def timed(name):
        def run(self, *args, **kwargs):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = real[name](self, *args, **kwargs)
            torch.cuda.synchronize()
            log[name].append(time.perf_counter() - t0)
            return out
        return run

    try:
        for k in real:
            setattr(pool_mod.ClientPool, k, timed(k))
        yield log
    finally:
        for k, fn in real.items():
            setattr(pool_mod.ClientPool, k, fn)


def check_pool(cfg, cobjs, dev, straight, straight_draws) -> None:
    """Phase 4g: the client pool (``core/pool.py``).  A pool of ``POOL_N``
    clients at the main path's width, ``POOL_K`` a chunk, ``POOL_ROUNDS``
    rounds in captured chunks of ``POOL_CHUNK``: one capture and one replay
    a chunk whatever the cohort, ms/round over the replays, the gather and
    scatter ms per boundary, the pool's host bytes; bit for bit the same
    chunks run eagerly (history, the pool's leaves and generator states);
    min F over the rounds below F(x_0); the kernels' launches those of the
    dense engine of K clients over the same rounds and chunks.  Then
    K = N = 5 against phase 4b's dense run on its seed, bit for bit (the
    history and each client's generator); a pooled run without tolerance
    rolled back (the ROLLBACK line at the round the schedule and the
    cohorts give, F finite); the command line with the pool and fault
    flags in a child process."""
    import dataclasses

    from repro_torch.core import algorithms as alg
    from repro_torch.core import graphs
    from repro_torch.core import objectives as obj
    from repro_torch.core import pool as pool_mod
    from repro_torch.core import rff as rfflib
    from repro_torch.faults import FaultConfig

    card = card_name()
    pcfg = dataclasses.replace(cfg, n_clients=POOL_N)
    pq = obj.make_quadratic(0, POOL_N, D, 5.0, 0.001, device=dev)
    x0 = torch.full((D,), 0.5, dtype=torch.float32, device=dev)
    eager_draws_type = type("EagerDraws", (alg.ClientDraws,), {})

    def pooled(draws, faults=None, root=None, every=1, q=pq, c=pcfg, k=POOL_K,
               rounds=POOL_ROUNDS, chunk=POOL_CHUNK):
        rff = rfflib.make_rff(draws, c.n_features, c.dim, c.lengthscale)
        return pool_mod.run_pooled_rounds(
            c, rff, obj.quadratic_query, q, pool_mod.init_pool(c, x0, 1), x0,
            obj.quadratic_global_value, rounds, chunk, cohort=k, draws=draws, faults=faults,
            checkpoint_dir=root, checkpoint_every=every)

    reset_counts()
    graphs.COUNTS.update(captures=0, replays=0)
    draws = alg.ClientDraws(1, range(POOL_K), dev)
    with timed_chunks() as log, timed_pool() as plog:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        pool, res = pooled(draws)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
    counts, runs = read_counts(), dict(graphs.COUNTS)
    ms_round = 1e3 * sum(log["replay"]) / POOL_ROUNDS
    gather = [round(1e3 * t, 3) for t in plog["gather"][1:]]  # the first is the capture's
    scatter = [round(1e3 * t, 3) for t in plog["scatter"][1:]]  # the first is init_pool's
    print(f"[pool] {card}: N={POOL_N} K={POOL_K} d={D} M={M} cap={CAP} T={cfg.local_steps}: "
          f"{POOL_ROUNDS} rounds in captured chunks of {POOL_CHUNK} in {secs:.3f} s; {runs}; "
          f"capture {sum(log['capture']):.3f} s; replays "
          f"{[round(1e3 * t, 3) for t in log['replay']]} ms, {ms_round:.3f} ms/round over the "
          f"replays; gather {gather} ms, scatter {scatter} ms per boundary (the pool's "
          f"build scattered all {POOL_N} clients in {1e3 * plog['scatter'][0]:.3f} ms); the "
          f"pool {pool.nbytes()} bytes on the host; launches {counts}", flush=True)
    f = res.f_values.cpu()
    print(f"[pool] F per round (the cohort's estimate): {[round(v, 6) for v in f.tolist()]}; "
          f"queries/client {res.queries.cpu().tolist()}", flush=True)
    if runs != {"captures": 1, "replays": POOL_ROUNDS // POOL_CHUNK}:
        fail(f"pool: {runs}, expected 1 capture and {POOL_ROUNDS // POOL_CHUNK} replays")
    if not bool(torch.isfinite(f).all()) or not f[1:].min() < f[0]:
        fail(f"pool: F not finite or min F over rounds 1-{POOL_ROUNDS} not below F(x_0)")
    cohorts = {s: pool_mod.sample_cohort(0, s, POOL_N, POOL_K)
               for s in range(0, POOL_ROUNDS, POOL_CHUNK)}
    done, want_q = np.zeros(POOL_N, np.int64), []
    for s, idx in cohorts.items():  # a member's queries count every round it ran
        for _ in range(s, min(s + POOL_CHUNK, POOL_ROUNDS)):
            done[idx] += 1
            want_q.append(np.float32(cfg.queries_per_round() * done[idx].sum())
                          / np.float32(POOL_K))
    if not np.array_equal(res.queries.cpu().numpy(), np.array(want_q, np.float32)):
        fail(f"pool: queries/client {res.queries.cpu().tolist()}, expected {want_q} (the "
             "cohorts' members' rounds)")

    eager_draws = eager_draws_type(1, range(POOL_K), dev)
    graphs.COUNTS.update(captures=0, replays=0)
    eager_pool, eager = pooled(eager_draws)
    same = {"history": bitwise(res, eager),
            "pool": bitwise(pool.leaves, eager_pool.leaves),
            "generators": bitwise(pool.draw_states, eager_pool.draw_states)}
    print(f"[pool eager] the same chunks run eagerly on the same draws: {same}; "
          f"{dict(graphs.COUNTS)}", flush=True)
    if not all(same.values()) or graphs.COUNTS["captures"]:
        fail(f"pool: the captured pooled run is not its eager chunks bit for bit: {same}")

    reset_counts()
    alg.simulate(cfg, 1, cobjs, obj.quadratic_query, obj.quadratic_global_value, POOL_ROUNDS,
                 chunk=POOL_CHUNK, device=dev)
    dense_counts = read_counts()
    print(f"[pool launches] the dense engine of {POOL_K} clients over the same rounds and "
          f"chunks: {dense_counts}; the pool's: {counts}", flush=True)
    if counts != dense_counts:
        fail(f"pool: launches {counts}, the dense {POOL_K}-client engine's {dense_counts}")

    full_draws = alg.ClientDraws(1, range(N_CLIENTS), dev)
    full_pool, full = pooled(full_draws, q=cobjs, c=cfg, k=N_CLIENTS, rounds=CAPTURED_ROUNDS,
                             chunk=CHUNK)
    same = {"history": bitwise(full, straight),
            "generators": bitwise(full_pool.draw_states, straight_draws.state()[1:])}
    print(f"[pool full] K = N = {N_CLIENTS}, {CAPTURED_ROUNDS} rounds in chunks of {CHUNK}, "
          f"against phase 4b's dense run on seed 1: {same}", flush=True)
    if not all(same.values()):
        fail(f"pool: at K = N the pooled run is not the dense run bit for bit: {same}")

    fcfg = FaultConfig(**POOL_FAULTS)
    want = rollback_expectations(fcfg, POOL_ROUNDS, POOL_CHUNK, POOL_N, cohorts)
    if want is None:
        fail(f"pool: {fcfg} poisons no cohort's chunk in {POOL_ROUNDS} rounds")
    graphs.COUNTS.update(captures=0, replays=0)
    with tempfile.TemporaryDirectory() as root, rollback_log() as rlog, timed_pool() as wlog:
        # a step at the insurance and the end only: the rollback restores step 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        _, faulted = pooled(alg.ClientDraws(1, range(POOL_K), dev), fcfg, root, every=100)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
    lines = [ln.split("] ", 1)[1] for ln in rlog["lines"]]
    print(f"[pool rollback] {card}: {fcfg}, N={POOL_N} K={POOL_K}: {t1 - t0:.3f} s; "
          f"{dict(graphs.COUNTS)}; rolled back at round {want[0]} to step {rlog['restored']} "
          f"(0 is the insurance step), the re-run "
          f"{t1 - rlog['at'][0] if rlog['at'] else float('nan'):.3f} s; F "
          f"{[round(v, 6) for v in faulted.f_values.cpu().tolist()]}", flush=True)
    expect_lines = [f"ROLLBACK 1/3 at round {want[0]} (non-finite server iterate): restoring "
                    "last good checkpoint", "re-running with fault tolerance FORCED ON"]
    if lines != expect_lines or not bool(torch.isfinite(faulted.xs).all()):
        fail(f"pool rollback: printed {lines}, expected {expect_lines}, or F is not finite")
    # no step between the insurance and the end: the restore is step 0, the
    # turned run captured afresh, a replay for every chunk started
    counts = {"captures": 2, "replays": len(range(0, want[0], POOL_CHUNK))
              + len(range(0, POOL_ROUNDS, POOL_CHUNK))}
    if rlog["restored"] != [0] or dict(graphs.COUNTS) != counts:
        fail(f"pool rollback: restored step(s) {rlog['restored']} and {dict(graphs.COUNTS)}, "
             f"expected [0] and {counts}")
    check_pool_cli()


def check_pool_cli() -> None:
    """Phase 4g: ``python -m repro_torch.launch.fedzoo --pool-size 256
    --cohort 5`` with the fault flags, ``--max-rollbacks`` and
    ``--ckpt-dir`` in a child process, at the command line's defaults but 4
    rounds in chunks of 2: it must exit 0 and print the cohort, the rates
    and a finite F(x_R)."""
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    with tempfile.TemporaryDirectory() as root:
        cmd = [sys.executable, "-m", "repro_torch.launch.fedzoo", "--pool-size", str(POOL_N),
               "--cohort", str(POOL_K), "--rounds", "4", "--chunk", "2", "--drop-rate", "0.2",
               "--nan-rate", "0.1", "--max-rollbacks", "2", "--ckpt-every", "100",
               "--ckpt-dir", root]
        t0 = time.perf_counter()
        proc = subprocess.run(cmd, env=env, cwd=ROOT, capture_output=True, text=True,
                              timeout=600)
        secs = time.perf_counter() - t0
    lines = proc.stdout.splitlines()
    result = next((ln for ln in lines if ln.startswith("F(x_0)")), "")
    rates = next((ln for ln in lines if ln.startswith("mean drop_rate")), "")
    print(f"[pool cli] {' '.join(cmd[3:])} in {secs:.1f} s: {lines[:1]}; {result}; {rates}",
          flush=True)
    if (proc.returncode != 0 or f"cohort={POOL_K}" not in proc.stdout or not rates
            or "nan" in result.lower()):
        fail(f"pool cli: exited {proc.returncode}:\n{proc.stdout[-2000:]}\n"
             f"{proc.stderr[-4000:]}")


def card_name() -> str:
    """The card's name and power limit as ``nvidia-smi`` prints them."""
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True, check=True)
    return smi.stdout.strip().splitlines()[0]


def check_cli_resume() -> None:
    """Phase 4c: ``python -m repro_torch.launch.fedzoo`` with ``--ckpt-dir``
    in a child process, at the command line's defaults but 10 rounds in
    chunks of 5; then again with its step 10 removed."""
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    with tempfile.TemporaryDirectory() as root:
        cmd = [sys.executable, "-m", "repro_torch.launch.fedzoo", "--objective", "quadratic",
               "--rounds", str(CAPTURED_ROUNDS), "--chunk", str(CHUNK), "--ckpt-dir", root]
        outs, files = [], []
        for run in ("first", "resumed"):
            t0 = time.perf_counter()
            proc = subprocess.run(cmd, env=env, cwd=ROOT, capture_output=True, text=True,
                                  timeout=600)
            secs = time.perf_counter() - t0
            if proc.returncode != 0:
                fail(f"the command line ({run}) exited {proc.returncode}:\n"
                     f"{proc.stdout[-2000:]}\n{proc.stderr[-4000:]}")
            lines = proc.stdout.splitlines()
            result = next((ln for ln in lines if ln.startswith("F(x_0)")), "")
            print(f"[checkpoint cli] {run}: {' '.join(cmd[1:4])} ... in {secs:.1f} s: "
                  f"{lines[:2]}; {result}", flush=True)
            outs.append(result.split("   (")[0])
            files.append(step_files(root, CAPTURED_ROUNDS))
            if run == "first":
                shutil.rmtree(Path(root) / f"step_{CAPTURED_ROUNDS:08d}")
        (a, ma), (b, mb) = files
        same = {"arrays": same_arrays(a, b), "checksums": ma["checksums"] == mb["checksums"],
                "F(x_R)": outs[0] == outs[1] != ""}
        print(f"[checkpoint cli] the resumed run's step {CAPTURED_ROUNDS} against the first "
              f"run's: {same}", flush=True)
        if not all(same.values()):
            fail(f"checkpoint cli: the resumed command line is not the first run: {same}")


#: Phase 4d, the paper's real-world objectives at the reference launcher's
#: width (its defaults, ``launcher_config``: M=1000, cap=192, T=10,
#: eta=0.01, l=0.5, noise 1e-5, 100 candidates, 5+5 active queries): the
#: attack (N=10, P=0.5, 16 x 16 images: d=256) on each seed of
#: ATTACK_SEEDS and the metric (N=7, P=0.5: d=119) on seed 0,
#: OBJECTIVE_ROUNDS rounds each in the loop; both on seed 0 also in
#: captured chunks (CAPTURED_ROUNDS in chunks of CHUNK).  A seed s builds
#: the objective from ``stream_seed(s, 0)`` and runs from ``stream_seed(s,
#: 1)``, as the command line does.
ATTACK_SEEDS, OBJECTIVE_ROUNDS = (0, 1, 2), 5
OBJECTIVE_CLIENTS = {"attack": 10, "metric": 7}


def launcher_config(dim, n_clients):
    """``AlgoConfig`` at the command line's defaults."""
    from repro_torch.launch import common, fedzoo

    return common.config_from_args(fedzoo.parser().parse_args([]), dim=dim, n_clients=n_clients)


def build_model_objective(name, seed, dev):
    """(objective, query, global value, d, build seconds) of ``attack`` or
    ``metric`` on the card, as the command line builds it at P=0.5; the
    seconds (the victims' training) on the host clock between two
    synchronizations."""
    from repro_torch.core import algorithms as alg
    from repro_torch.core import model_objectives as mobj

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    n = OBJECTIVE_CLIENTS[name]
    if name == "attack":
        cobjs, img = mobj.make_attack_objective(alg.stream_seed(seed, 0), n, p_shared=0.5,
                                                device=dev)
        fns, d = (mobj.attack_query, mobj.attack_global_value), img.shape[-1]
    else:
        cobjs, d = mobj.make_metric_objective(alg.stream_seed(seed, 0), n, p_shared=0.5,
                                              device=dev)
        fns = (mobj.metric_query, mobj.metric_global_value)
    torch.cuda.synchronize()
    return (cobjs, *fns, d, time.perf_counter() - t0)


def check_objectives(dev) -> None:
    """Phase 4d: the attack and the metric through ``simulate`` at the
    launcher's width (see ATTACK_SEEDS), each run's F finite, its queries
    exact, its launches those of the deferred engine, and min F over rounds
    1-5 below F(x_0) (the attack; the criterion of tests/test_system.py
    without its 1e-3 margin) or not above it (the metric); each on seed 0
    in captured chunks against the loop; the command line on both; the small
    attack engine on the card against the CPU, and B1, B3, B5, B6 and B9
    on the small attack and metric engines' inputs against float64."""
    from repro_torch.core import algorithms as alg
    from repro_torch.core import model_objectives as mobj

    card = card_name()
    for name, seed in [("attack", s) for s in ATTACK_SEEDS] + [("metric", 0)]:
        cobjs, query, value, d, build_secs = build_model_objective(name, seed, dev)
        n = OBJECTIVE_CLIENTS[name]
        cfg = launcher_config(d, n)
        label = f"{name} seed {seed}"
        reset_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = alg.simulate(cfg, alg.stream_seed(seed, 1), cobjs, query, value, OBJECTIVE_ROUNDS,
                           chunk=0, device=dev)
        torch.cuda.synchronize()
        secs, counts = time.perf_counter() - t0, read_counts()
        print(f"[{label}] {card}: d={d} N={n} M={cfg.n_features} cap={cfg.traj_capacity} "
              f"T={cfg.local_steps} l={cfg.lengthscale}: objective built in {build_secs:.3f} s; "
              f"{OBJECTIVE_ROUNDS} rounds (loop) in {secs:.3f} s, "
              f"{1e3 * secs / OBJECTIVE_ROUNDS:.3f} ms/round; launches {counts}", flush=True)
        check_result(res, cfg, OBJECTIVE_ROUNDS, label, must_fall=False)
        loop_counts = deferred_counts(cfg, OBJECTIVE_ROUNDS)
        want = expect(**dict(loop_counts, sqexp=loop_counts["sqexp"] + 1))
        if counts != want:
            fail(f"{label}: launches {counts}, expected {want}")
        f = res.f_values.cpu()
        best = int(torch.argmin(f[1:])) + 1
        improved = f[best] < f[0] if name == "attack" else f[best] <= f[0]
        extra = (f"; attack_success of the best iterate "
                 f"{float(mobj.attack_success(cobjs, res.xs[best])):.0f}"
                 if name == "attack" else "")
        print(f"[{label}] F(x_0) {f[0].item():.6f}, min F over rounds 1-{OBJECTIVE_ROUNDS} "
              f"{f[best].item():.6f} at round {best}{extra}; "
              f"{'ok' if improved else 'NOT IMPROVED'}", flush=True)
        if not improved:
            fail(f"{label}: min F over rounds 1-{OBJECTIVE_ROUNDS} is not "
                 f"{'below' if name == 'attack' else 'at or below'} F(x_0)")
        if seed == 0:
            check_objective_captured(name, cfg, cobjs, query, value, seed, dev)
    check_objective_clis({name: ["--objective", name, "--clients", str(n)]
                          for name, n in OBJECTIVE_CLIENTS.items()})
    check_small_against_cpu(dev, "small attack", objective="attack")
    check_engine_inputs(dev, "small attack engine inputs", objective="attack")
    check_engine_inputs(dev, "small metric engine inputs", objective="metric")


def check_objective_captured(name, cfg, cobjs, query, value, seed, dev, rounds=CAPTURED_ROUNDS,
                             chunk=CHUNK, profile=True):
    """Phase 4d: an objective in captured chunks (``rounds`` in chunks of
    ``chunk``, CAPTURED_ROUNDS in chunks of CHUNK: one capture, two
    replays; the launches counted at the warm-up round and the capture)
    against the loop's ``rounds`` rounds on the same seed
    (``hold_to_loop``); then, with ``profile``, one replayed chunk
    profiled: its busy share and the kernels with the most device time.
    Returns (ms/round over the replays, the profiled replay's device busy
    ms or None)."""
    from repro_torch.core import algorithms as alg
    from repro_torch.core import graphs

    run_seed = alg.stream_seed(seed, 1)
    draws = alg.ClientDraws(run_seed, range(cfg.n_clients), dev)
    sim = lambda chunk, d: alg.simulate(cfg, run_seed, cobjs, query, value, rounds,
                                        chunk=chunk, draws=d, device=dev)
    reset_counts()
    graphs.COUNTS.update(captures=0, replays=0)
    with timed_chunks() as log:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = sim(chunk, draws)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
    counts, runs = read_counts(), dict(graphs.COUNTS)
    label = f"{name} captured"
    ms_round = 1e3 * sum(log["replay"]) / rounds
    print(f"[{label}] {card_name()}: d={cfg.dim} N={cfg.n_clients} seed {seed}: "
          f"{rounds} rounds in chunks of {chunk} in {secs:.3f} s; {runs['captures']} "
          f"capture(s) in {sum(log['capture']):.3f} s; replays "
          f"{[round(1e3 * s, 3) for s in log['replay']]} ms, "
          f"{ms_round:.3f} ms/round over the replays; "
          f"launches counted at the warm-up round and the capture {counts}", flush=True)
    check_result(res, cfg, rounds, label, must_fall=False)
    if runs != {"captures": 1, "replays": rounds // chunk}:
        fail(f"{label}: {runs}, expected 1 capture and {rounds // chunk} replays")
    warm_and_capture = deferred_counts(cfg, 1 + chunk)
    want = expect(**dict(warm_and_capture, sqexp=warm_and_capture["sqexp"] + 1))
    if counts != want:
        fail(f"{label}: launches {counts}, expected {want} (factor_init, the warm-up "
             "round and the capture)")
    loop_draws = alg.ClientDraws(run_seed, range(cfg.n_clients), dev)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    loop = sim(0, loop_draws)
    torch.cuda.synchronize()
    print(f"[{label}] the loop's {rounds} rounds in "
          f"{time.perf_counter() - t0:.3f} s", flush=True)
    hold_to_loop(loop, res, label, loop_draws, draws)
    if not profile:
        return ms_round, None

    # one replayed chunk under the profiler: where its device time goes
    with timed_chunks(profile_replays=True) as plog:
        alg.simulate(cfg, run_seed, cobjs, query, value, chunk, chunk=chunk, device=dev)
    kernels = [e for e in plog["profiles"][0].key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    busy_ms = sum(e.self_device_time_total for e in kernels) / 1e3
    wall_ms = 1e3 * plog["replay"][0]
    top = sorted(kernels, key=lambda e: -e.self_device_time_total)[:6]
    print(f"[{label} profile] one replayed chunk of {chunk} rounds: wall {wall_ms:.3f} ms "
          f"(profiled), device busy {busy_ms:.3f} ms ({100 * busy_ms / wall_ms:.1f}%), "
          f"{sum(e.count for e in kernels)} device kernels; most device time: "
          + "; ".join(f"{e.key[:48]} x{e.count} {e.self_device_time_total / 1e3:.3f} ms"
                      for e in top), flush=True)
    return ms_round, busy_ms


def run_clis(module: str, commands: dict, result) -> None:
    """``python -m repro_torch.launch.<module> <flags>`` for each label's
    flags in ``commands``, in child processes started together, each
    waited for: exit 0, and ``result(lines)`` (the child's stdout lines)
    returns the line to print or fails.  The seconds are each child's wall
    time beside the others sharing the card."""
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    procs = {}
    t0 = time.perf_counter()
    for label, flags in commands.items():
        cmd = [sys.executable, "-m", f"repro_torch.launch.{module}", *flags]
        procs[label] = (cmd, subprocess.Popen(cmd, env=env, cwd=ROOT, stdout=subprocess.PIPE,
                                              stderr=subprocess.PIPE, text=True))
    try:
        for label, (cmd, proc) in procs.items():
            out, err = proc.communicate(timeout=600)
            secs = time.perf_counter() - t0
            if proc.returncode != 0:
                fail(f"the command line ({label}) exited {proc.returncode}:\n{out[-2000:]}\n"
                     f"{err[-4000:]}")
            lines = out.splitlines()
            print(f"[{label} cli] {' '.join(cmd[1:])} done {secs:.1f} s after the "
                  f"{len(procs)} started: {result(label, lines)}", flush=True)
    finally:
        for _, proc in procs.values():
            if proc.poll() is None:
                proc.kill()
                proc.wait()


def check_objective_clis(commands: dict) -> None:
    """``python -m repro_torch.launch.fedzoo <flags>`` for each label's flags
    in ``commands`` (``run_clis``): exit 0 and a finite F(x_0), F(x_R) and
    best.  Phase 4d runs the attack and the metric (``--objective <name>
    --clients N``: 50 rounds, the default captured chunks of 16), phase 4h
    the LM objective on every architecture of LM_SMOKE."""

    def result(label, lines):
        line = next((ln for ln in lines if ln.startswith("F(x_0)")), "")
        fields = line.replace("=", " ").split()
        values = [float(fields[i + 1]) for i, w in enumerate(fields[:-1])
                  if w in ("F(x_0)", "F(x_R)", "best")]
        if len(values) != 3 or not all(np.isfinite(values)):
            fail(f"the command line ({label}) printed no finite F: {line!r}")
        return f"{lines[:2]}; {line}"

    run_clis("fedzoo", commands, result)


class LMRun(NamedTuple):
    """How phase 4h runs one published config."""
    loop: int  # rounds in the loop
    captured: int  # rounds in captured chunks
    chunk: int  # their chunk length
    profiled: bool  # a replay profiled, the forward's bound, the engine's inputs
    layers: Optional[int] = None  # the depth cut (None: the published depth)
    device_draws: bool = False  # init_params draws on the card


#: Phase 4h, the LM objective (A13a, A13b: ``models/``, ``configs/``, the
#: third part of ``core/model_objectives.py``): each published config at
#: full width (``FULL``, bf16, random parameters from
#: ``models.init_params``), LM_CLIENTS clients of ``make_lm_objective``'s
#: defaults (batch 2, seq 32), through ``simulate`` at the command line's
#: engine defaults (``launcher_config``; d = d_model), both seeded as the
#: command line seeds ``--seed 0``.  Scout's 48 layers (215.5 GB in bf16)
#: do not fit one 80 GB card: 4 of them do (21.75 GB).  The two largest
#: draw on the card: an H100 host's CPU draws them in 61 and 89 s
#: (``scripts/lm_build_seconds.py``), the card in a tenth of a second.
LM_FULL = {"qwen1.5-0.5b": LMRun(3, 10, 5, True), "mamba2-370m": LMRun(2, 2, 2, False),
           "qwen2-vl-7b": LMRun(2, 4, 2, True, device_draws=True),
           "llama4-scout-17b-16e": LMRun(2, 4, 2, True, layers=4, device_draws=True)}
#: The SMOKE variants phase 4h holds on the card against the CPU and runs
#: through the command line: every family the LM objective runs.
LM_SMOKE = ("qwen1.5-0.5b", "mamba2-370m", "llama4-scout-17b-16e", "llama4-maverick-400b-a17b",
            "jamba-1.5-large-398b", "qwen2-vl-7b")
LM_CLIENTS = 5
#: Peak bf16 rate of the tensor cores (NVIDIA data sheet, H100 SXM, dense):
#: the bound of a round's forward passes.
BF16_FLOPS_S = 989e12
#: The SMOKE forward and objective on the card against the CPU: float32
#: within 1e-4 of the largest magnitude (the CPU tests' bound against the
#: reference); bf16 by each side's distance from the CPU's float64
#: evaluation, the card's at most LM_BF16_MULTIPLE times the CPU's or
#: within LM_BF16_FLOOR of the largest magnitude (one bf16 spacing: cuBLAS
#: may reduce bf16 products in bf16 and sums in another order).
LM_BF16_MULTIPLE, LM_BF16_FLOOR = 2.0, 2.0 ** -8


def sync(dev) -> None:
    if torch.device(dev).type == "cuda":
        torch.cuda.synchronize()


def build_lm(arch, dev, variant="full", dtype=None, layers=None, device_draws=False):
    """The LM objective of ``arch`` as the command line builds it at ``--seed
    0`` (``init_params`` and ``make_lm_objective`` on ``stream_seed(0, 0)``),
    on ``dev``: (config, params, objective, query, global value, value,
    build seconds between two synchronizations).  ``dtype`` replaces the
    config's, ``layers`` its depth; ``device_draws`` as ``init_params``'."""
    from repro_torch import configs
    from repro_torch.core import algorithms as alg
    from repro_torch.core import model_objectives as mobj
    from repro_torch.models.params import init_params

    cfg = configs.get_config(arch, variant)
    if dtype is not None:
        cfg = dataclasses.replace(cfg, dtype=dtype)
    if layers is not None:
        cfg = dataclasses.replace(cfg, n_layers=layers)
    seed = alg.stream_seed(0, 0)
    sync(dev)
    t0 = time.perf_counter()
    params = init_params(seed, cfg, dev, device_draws=device_draws)
    cobjs = mobj.make_lm_objective(seed, cfg, LM_CLIENTS, device=dev)
    sync(dev)
    secs = time.perf_counter() - t0
    query, value, _, per_point = mobj.make_lm_query(cfg, params)
    return cfg, params, cobjs, query, value, per_point, secs


def lm_round_work(cfg, ecfg, cobjs) -> dict:
    """What one round's forward passes compute, from the shapes: the forward
    calls (the iterate's and the active queries of every local step, the
    round end's active queries, F), their sequences (each point a client's
    batch) and tokens; the operations: 2 per parameter of the blocks and of
    the vocabulary projection per token, the attention's scores and values,
    and for a MoE config the experts' GEMMs over the E x C slots of every
    (client, point) group (the router and the shared expert are block
    parameters every token runs), with the share of those operations the
    tokens' top-k slots need; the bytes (every parameter read once a call,
    but an untied embedding table, of which a call gathers its tokens'
    rows); the bound, the larger of the operations at the bf16 peak and the bytes
    at HBM's rate; and the float32 logits of the largest query (the active
    queries)."""
    from repro_torch.models.layers import moe_capacity
    from repro_torch.models.params import param_defs

    n, (b, l) = ecfg.n_clients, cobjs.batches_tokens.shape[1:]
    points = ecfg.local_steps * (1 + ecfg.active_per_iter) + ecfg.active_round_end + 1
    calls = 2 * ecfg.local_steps + (ecfg.active_round_end > 0) + 1
    seqs = points * n * b
    tokens = seqs * l
    dense = 2 * cfg.d_model * cfg.vocab_size  # the vocabulary projection, per token
    defs = param_defs(cfg)
    experts = {k for k in defs if k.startswith("blocks/") and ".we_" in k}
    blocks = sum(int(np.prod(pd.shape)) for k, pd in defs.items()
                 if k.startswith("blocks/") and k not in experts)
    attn = 0 if cfg.arch_type == "ssm" else 2 * 2 * cfg.n_layers * cfg.q_dim * (l + 1) // 2
    flops = tokens * (2 * blocks + dense + attn)
    useful = flops
    if cfg.is_moe_mlp:  # every layer has a MoE MLP
        per_slot = 6 * cfg.d_model * cfg.d_ff * cfg.n_layers
        slots = points * n * cfg.n_experts * moe_capacity(cfg, b * l)
        flops += slots * per_slot
        useful += tokens * cfg.moe_top_k * per_slot
    size = cfg.torch_dtype.itemsize
    table = 0 if cfg.tie_embeddings else int(np.prod(defs["embed"].shape))
    n_bytes = (calls * (sum(int(np.prod(pd.shape)) for pd in defs.values()) - table)
               + (tokens * cfg.d_model if table else 0)) * size
    active = n * max(ecfg.active_per_iter, ecfg.active_round_end) * b * l * cfg.vocab_size * 4
    return {"calls": calls, "sequences": seqs, "tokens": tokens, "TFLOP": flops / 1e12,
            "useful": useful / flops, "GB": n_bytes / 1e9,
            "bound_ms": 1e3 * max(flops / BF16_FLOPS_S, n_bytes / HBM_BYTES_S),
            "active_logits_GB": active / 1e9}


def lm_model_ms(ecfg, cobjs, query, value, dev, label) -> float:
    """Device ms of one round's forward passes: each kind of call of the
    round (the iterate's query, N x 1 points, and the active queries, N x
    ``active_per_iter``, at every local step; the round end's active
    queries; F at one point) profiled once eagerly after a warm-up call,
    times its count.  The replayed graph runs the same kernels.  Prints the
    torch operators with the most device time in an active-query call."""
    from torch.profiler import ProfilerActivity, profile

    n, d, t = ecfg.n_clients, ecfg.dim, ecfg.local_steps
    pts = lambda k: torch.full((n, k, d), 0.5, device=dev)
    calls = [(lambda: query(cobjs, pts(1), torch.zeros(n, 1, device=dev)), t),
             (lambda: query(cobjs, pts(ecfg.active_per_iter),
                            torch.zeros(n, ecfg.active_per_iter, device=dev)), t),
             (lambda: query(cobjs, pts(ecfg.active_round_end),
                            torch.zeros(n, ecfg.active_round_end, device=dev)), 1),
             (lambda: value(cobjs, torch.full((d,), 0.5, device=dev)), 1)]
    total = 0.0
    for call, count in calls:
        call()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            call()
            torch.cuda.synchronize()
        events = prof.key_averages()
        total += count * sum(e.self_device_time_total for e in events
                             if e.device_type == torch.autograd.DeviceType.CUDA) / 1e3
        if call is calls[1][0]:
            ops = sorted((e for e in events if e.key.startswith("aten::")),
                         key=lambda e: -e.self_device_time_total)[:10]
            print(f"[{label} profile] an active-query call ({n} x {ecfg.active_per_iter} "
                  "points), the operators with the most device time: "
                  + "; ".join(f"{e.key} x{e.count} {e.self_device_time_total / 1e3:.3f} ms"
                              for e in ops), flush=True)
    return total


def dropped_share(cfg, params, ecfg, cobjs, dev) -> tuple[int, int]:
    """(dropped slots, slots) over the MoE layers of one active-query call's
    values (N x ``active_per_iter`` points, each its own group), on the
    card."""
    from repro_torch.core import model_objectives as mobj
    from repro_torch.models.layers import Routes

    n, d, k = ecfg.n_clients, ecfg.dim, ecfg.active_per_iter
    x = torch.rand((n, k, d), generator=torch.Generator(device=dev).manual_seed(7), device=dev)
    routes = Routes()
    mobj.lm_values(cfg, params, cobjs, mobj.lm_gains(params["final_norm"], cobjs.scale, x),
                   routes=routes)
    return (sum(int((~r.keep).sum()) for r in routes.calls),
            sum(r.keep.numel() for r in routes.calls))


def check_lm(dev) -> None:
    """Phase 4h: each config of LM_FULL at full width (its depth cut where
    LM_FULL says so) through ``simulate``: the loop (F finite, exact
    queries, the deferred engine's launches, min F over the rounds not
    above F(x_0)), the parameters' build seconds, bytes and the build's
    peak memory, ms/round; captured chunks bit for bit the loop
    (``check_objective_captured``), ms/round over the replays; where
    LM_FULL says so (all but mamba2) one replayed chunk profiled beside the
    device time of the round's forward passes (``lm_model_ms``) and their
    bound (``lm_round_work``), for a MoE config the share of slots an
    active-query call drops, and the scoring (B1, or B2 where the tuner
    tiles the cap), the gradient mean (B3, or B4), B5, B6 and B9 on two
    loop rounds' inputs against float64 (``check_engine_inputs``); the peak of
    ``torch.cuda.max_memory_allocated`` of each config's loop and captured
    runs (before that check's recordings); then the SMOKE forward and
    objective on the card against the CPU (``check_lm_small``) and the
    command line on every architecture of LM_SMOKE."""
    from repro_torch import configs
    from repro_torch.core import algorithms as alg
    from repro_torch.models.layers import moe_capacity

    card = card_name()
    for arch, how in LM_FULL.items():
        gc.collect()  # the previous config's graphs and tensors
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        held = torch.cuda.memory_allocated()  # by the earlier phases
        cfg, params, cobjs, query, value, per_point, build_secs = build_lm(
            arch, dev, layers=how.layers, device_draws=how.device_draws)
        build_peak = torch.cuda.max_memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        n_params = sum(t.numel() for t in params.values())
        n_bytes = sum(t.numel() * t.element_size() for t in params.values())
        ecfg = launcher_config(cfg.d_model, LM_CLIENTS)
        label = f"lm {cfg.name}"
        run = lambda rounds: alg.simulate(ecfg, alg.stream_seed(0, 1), cobjs, query, value,
                                          rounds, chunk=0, device=dev)
        reset_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = run(how.loop)
        torch.cuda.synchronize()
        secs, counts = time.perf_counter() - t0, read_counts()
        cut = (f" (cut from {configs.get_config(arch).n_layers} layers)" if how.layers
               else "")
        moe = (f", {cfg.n_experts} experts of d_ff {cfg.d_ff} top-{cfg.moe_top_k}"
               f"{' and a shared expert' if cfg.n_shared_experts else ''}"
               if cfg.is_moe_mlp else "")
        print(f"[{label}] {card}: {cfg.n_layers} layers{cut}, d_model={cfg.d_model}{moe}, "
              f"vocab {cfg.vocab_size}, {cfg.dtype}: {n_params} parameters, {n_bytes} bytes, "
              f"built in {build_secs:.3f} s (drawn on the "
              f"{'card' if how.device_draws else 'CPU'}; the build's peak {build_peak} bytes); "
              f"N={LM_CLIENTS} batch {cobjs.batches_tokens.shape[1]} x "
              f"{cobjs.batches_tokens.shape[2]} tokens, d={ecfg.dim} M={ecfg.n_features} "
              f"cap={ecfg.traj_capacity} T={ecfg.local_steps}; {how.loop} rounds (loop) in "
              f"{secs:.3f} s, {1e3 * secs / how.loop:.3f} ms/round; launches {counts}",
              flush=True)
        check_result(res, ecfg, how.loop, label, must_fall=False)
        loop_counts = deferred_counts(ecfg, how.loop)
        want = expect(**dict(loop_counts, sqexp=loop_counts["sqexp"] + 1))
        if counts != want:
            fail(f"{label}: launches {counts}, expected {want}")
        f = res.f_values.cpu()
        print(f"[{label}] F(x_0) {f[0].item():.7f}, min F over rounds 1-{how.loop} "
              f"{f[1:].min().item():.7f}", flush=True)
        if not f[1:].min() <= f[0]:
            fail(f"{label}: min F over rounds 1-{how.loop} is above F(x_0)")
        ms_round, busy_ms = check_objective_captured(label, ecfg, cobjs, query, value, 0, dev,
                                                     rounds=how.captured, chunk=how.chunk,
                                                     profile=how.profiled)
        if how.profiled:
            work = lm_round_work(cfg, ecfg, cobjs)
            model_ms = lm_model_ms(ecfg, cobjs, query, value, dev, label)
            experts = (f"; the experts' E x C slots a query, {100 * work['useful']:.1f}% of the "
                       "operations the tokens' top-k slots" if cfg.is_moe_mlp else "")
            print(f"[{label} profile] a round's forward passes: {work['calls']} calls, "
                  f"{work['sequences']} sequences, {work['tokens']} tokens, "
                  f"{work['TFLOP']:.3f} TFLOP{experts}, {work['GB']:.3f} GB of parameters "
                  f"read, bound {work['bound_ms']:.3f} ms at {BF16_FLOPS_S / 1e12:.0f} TFLOP/s "
                  f"bf16 and {HBM_BYTES_S / 1e12:.2f} TB/s; float32 logits of an active-query "
                  f"call {work['active_logits_GB']:.3f} GB; their device time {model_ms:.3f} "
                  f"ms a round (eager calls of the round's shapes, profiled), "
                  f"{how.chunk * model_ms:.3f} ms of the replayed chunk's {busy_ms:.3f} ms "
                  f"busy ({100 * how.chunk * model_ms / busy_ms:.1f}%), the GP, RFF and engine "
                  f"the other {busy_ms - how.chunk * model_ms:.3f} ms; replayed "
                  f"{ms_round:.3f} ms/round against the bound's {work['bound_ms']:.3f}",
                  flush=True)
            if cfg.is_moe_mlp:
                dropped, slots = dropped_share(cfg, params, ecfg, cobjs, dev)
                print(f"[{label} drops] an active-query call ({LM_CLIENTS} x "
                      f"{ecfg.active_per_iter} points, each its own group of "
                      f"{cobjs.batches_tokens[0].numel()} tokens, capacity "
                      f"{moe_capacity(cfg, cobjs.batches_tokens[0].numel())} slots an "
                      f"expert): {dropped} of {slots} "
                      f"slots dropped ({100 * dropped / slots:.2f}%) over the "
                      f"{cfg.n_layers} MoE layers", flush=True)
        peak = torch.cuda.max_memory_allocated()
        print(f"[{label}] peak torch.cuda.max_memory_allocated {peak} bytes over the loop, "
              f"the captured runs and their profile, {peak - held} above the {held} bytes "
              "the earlier phases hold", flush=True)
        if how.profiled:
            # two rounds: the first round's RFF weights are 0, the second's are fitted
            check_engine_inputs(dev, f"{label} engine inputs", run=lambda: run(2))
        del params, cobjs, query, value, per_point, res
    check_lm_small(dev)
    check_objective_clis({f"lm {arch}": ["--objective", "lm", "--arch", arch, "--rounds", "10"]
                          for arch in LM_SMOKE})


def check_lm_small(dev) -> None:
    """Phase 4h: the SMOKE forward's logits and the LM objective's values at
    LM_CLIENTS x 4 points (the base gains and random points), on the card
    and on the CPU from the same parameters and batches, in float32 and in
    bf16 (bounds at LM_BF16_MULTIPLE), for every architecture of LM_SMOKE.
    A bf16 MoE stack runs on both sides with its routing pinned to the
    CPU's float64 run's (``layers.Routes``), every token and value
    compared; its own routing on either side differs from the float64
    run's only at near-ties (``layers.flip_margins`` within
    ``layers.NEAR_TIE``; the largest margin printed)."""
    from repro_torch.core import model_objectives as mobj
    from repro_torch.models import layers as L
    from repro_torch.models.model import forward
    from repro_torch.sharding import ShardingPolicy

    pol = ShardingPolicy(remat=False)
    for arch in LM_SMOKE:
        for dtype in ("float32", "bfloat16"):
            cfg, params, cobjs, _, _, _, _ = build_lm(arch, "cpu", "smoke", dtype)
            x = torch.rand((LM_CLIENTS, 4, cfg.d_model), generator=torch.Generator().manual_seed(5))
            x[:, 0] = 0.5
            tokens = cobjs.batches_tokens.reshape(-1, cobjs.batches_tokens.shape[-1])
            length = tokens.shape[-1]
            gains = mobj.lm_gains(params["final_norm"], cobjs.scale, x)
            sides = {"card": ({k: v.to(dev) for k, v in params.items()}, cfg, dev),
                     "CPU": (params, cfg, torch.device("cpu")),
                     "float64": ({k: v.double() for k, v in params.items()},
                                 dataclasses.replace(cfg, dtype="float64"), torch.device("cpu"))}
            calls = {
                "logits": lambda p, c, where, routes: forward(
                    p, c, {"tokens": tokens.to(where)}, pol, routes=routes)[0],
                "values": lambda p, c, where, routes: mobj.lm_values(
                    c, p, mobj.to(cobjs, where), gains.to(where, p["final_norm"].dtype), pol,
                    routes=routes)}
            pinned = cfg.is_moe_mlp and dtype == "bfloat16"
            for what, call in calls.items():
                routes64 = L.Routes()
                truth = call(*sides["float64"], routes64).double()
                note = ""
                if pinned:
                    firsts, top = 0, 0.0
                    for side in ("card", "CPU"):
                        routes = L.Routes()
                        call(*sides[side], routes)
                        margins = L.flip_margins(routes, routes64, length)
                        firsts += margins.numel()
                        top = max(top, float(margins.max()) if margins.numel() else 0.0)
                    note = (f"; routed as the float64 run but {firsts} tokens (card and CPU) "
                            f"first at margins up to {top:.6f} (NEAR_TIE {L.NEAR_TIE}), "
                            "then pinned to its routing")
                    if top > L.NEAR_TIE:
                        fail(f"small lm: {cfg.name} {dtype} {what}: a choice moved off a "
                             f"near-tie (margin {top})")
                pin = lambda: L.Routes(pin=routes64) if pinned else None
                g = call(*sides["card"], pin()).cpu().double()
                c = call(*sides["CPU"], pin()).double()
                scale = truth.abs().max().item()
                gap = (g - c).abs().max().item() / scale
                e_card, e_cpu = ((g - truth).abs().max().item() / scale,
                                 (c - truth).abs().max().item() / scale)
                if dtype == "float32":
                    ok = gap <= 1e-4
                else:
                    ok = e_card <= max(LM_BF16_MULTIPLE * e_cpu, LM_BF16_FLOOR)
                print(f"[small lm] {cfg.name} {dtype} {what}: card vs CPU {gap:.3e}; from the "
                      f"CPU's float64: card {e_card:.3e}, CPU {e_cpu:.3e} (shares of "
                      f"{scale:.3e}){note}; {'ok' if ok else 'FAILED'}", flush=True)
                if not ok:
                    fail(f"small lm: {cfg.name} {dtype} {what}: the card is off the CPU")


class ServeRun(NamedTuple):
    """How phase 4i serves one published config at full width."""
    batch: int  # sequences
    prompt: int  # prompt tokens
    gen: int  # tokens generated greedily


#: Phase 4i, serving (A13c-serve: ``prefill``, ``decode_step``, the caches,
#: ``launch/serve.py``): each published config at full width (``FULL``,
#: bf16, random parameters from ``models.init_params`` of seed 0), its
#: prompts from ``serve.stub_batch``, ``cache_len`` = prompt + gen + 1 as
#: the command line's.
SERVE_FULL = {"qwen1.5-0.5b": ServeRun(16, 512, 128), "mamba2-370m": ServeRun(16, 512, 128),
              "whisper-base": ServeRun(4, 32, 64)}
#: The SMOKE variants phase 4i holds on the card against the CPU: every
#: family the port serves.
SERVE_SMOKE = LM_SMOKE + ("whisper-base",)
#: The reference's decode-versus-forward bounds (``tests/test_models.py``,
#: measured on its 2-layer SMOKE configs): the first decode step's logits
#: against ``forward``'s at position L, as a share of the largest forward
#: logit.  Printed beside the full-width bf16 distance; the check is
#: ``decode_against_forward``'s.
DECODE_TOL = {"qwen1.5-0.5b": 1e-2, "mamba2-370m": 0.05, "whisper-base": 0.02}


def decode_against_forward(params, cfg, batch, full_batch, token, first, cache_len, length,
                           label) -> str:
    """The reference's decode-versus-forward property at full width: the
    float32 run of the same parameters (bf16 values widened) decodes
    ``token`` at position ``length`` within 1e-4 of its own ``forward``'s
    logits there (the largest forward logit the scale), and the bf16 first
    decode step ``first`` is no further from that float32 forward than
    LM_BF16_MULTIPLE times the bf16 forward is (or within LM_BF16_FLOOR).
    The bf16 decode and forward round differently (an L-token and a
    1-token product path), and at 24 layers their distance may pass the
    reference's SMOKE bound (DECODE_TOL), which is printed beside it.
    Returns the line's text."""
    from repro_torch.models.model import decode_step, forward, prefill
    from repro_torch.sharding import ShardingPolicy

    pol = ShardingPolicy(remat=False)
    fwd, _ = forward(params, cfg, full_batch, pol)
    fwd = fwd[:, length].float()
    c32 = dataclasses.replace(cfg, dtype="float32")
    p32 = {k: v.float() for k, v in params.items()}
    wide = lambda b: {k: v.float() if v.is_floating_point() else v for k, v in b.items()}
    truth, _ = forward(p32, c32, wide(full_batch), pol)
    scale = truth.abs().max().item()
    truth = truth[:, length].clone()
    _, cache32 = prefill(p32, c32, wide(batch), pol, cache_len=cache_len)
    dec32, _ = decode_step(p32, c32, cache32, token, pol)
    del p32, cache32
    dist = lambda a, b: (a.float() - b).abs().max().item() / scale
    e32, e_dec, e_fwd, gap = dist(dec32, truth), dist(first, truth), dist(fwd, truth), dist(first,
                                                                                            fwd)
    tol = DECODE_TOL.get(cfg.name)
    ok = e32 <= 1e-4 and e_dec <= max(LM_BF16_MULTIPLE * e_fwd, LM_BF16_FLOOR)
    text = (f"the first decode step at position {length} against forward there (shares of "
            f"the largest float32 forward logit, {scale:.3e}): float32 decode vs float32 "
            f"forward {e32:.3e} (bound 1e-4); from the float32 forward, bf16 decode {e_dec:.3e}, "
            f"bf16 forward {e_fwd:.3e}; bf16 decode vs bf16 forward {gap:.3e} (the reference's "
            f"SMOKE bound {tol}); {'ok' if ok else 'FAILED'}")
    if not ok:
        fail(f"{label}: {text}")
    return text


def serve_work(cfg, bsz: int, prompt: int, cache_len: int) -> dict:
    """The least time the card could take for a prefill of ``bsz`` prompts
    of ``prompt`` tokens and for one decode step of ``bsz`` tokens against
    a ``cache_len`` cache, from the shapes (dense, ssm and encdec configs).
    Prefill: 2 operations a parameter a token (the decoder's on its tokens,
    the encoder's and the cross K/V projections on the frames), the causal
    attention's scores and values (L(L+1)/2 pairs; the encoder's all pairs,
    the cross-attention's L x enc_seq), the SSD's within-chunk pairs and
    states, the last token's vocabulary projection; bytes: every parameter
    read once (an untied embedding by its gathered rows) and the cache
    written.  Decode: the decoder's parameters read once (the encoder's
    not) and the whole cache read, as the reference's masked attention
    reads every slot, the SSM states written back; operations 2 a
    parameter and the attention over every slot.  Each bound the larger of
    the operations at the bf16 peak and the bytes at HBM's rate."""
    from repro_torch.models.params import param_defs

    assert not cfg.is_moe_mlp, cfg.name
    defs = {k: int(np.prod(pd.shape)) for k, pd in param_defs(cfg).items()}
    size = cfg.torch_dtype.itemsize
    d, q, kv, v = cfg.d_model, cfg.q_dim, cfg.kv_dim, cfg.vocab_size
    nb, tokens = cfg.n_blocks, bsz * prompt
    enc = sum(n for k, n in defs.items() if k.startswith("enc_blocks/"))
    cross_kv = sum(n for k, n in defs.items()
                   if k.startswith("blocks/cross.") and k[-2:] in ("wk", "wv"))
    blocks = sum(n for k, n in defs.items() if k.startswith("blocks/")) - cross_kv
    attn_layers = 0 if cfg.arch_type == "ssm" else nb
    flops = 2 * blocks * tokens + 2 * d * v * bsz
    flops += 2 * q * prompt * (prompt + 1) * attn_layers * bsz
    ssm_state = 0
    if cfg.arch_type == "ssm":
        h, hp, n, chunk = cfg.ssm_heads, cfg.ssm_head_dim, cfg.ssm_state, cfg.ssm_chunk
        flops += h * (min(chunk, prompt) * (n + hp) + 4 * hp * n) * nb * tokens
        ssm_state = nb * bsz * (h * hp * n * 4 + (cfg.ssm_conv - 1) * cfg.ssm_conv_channels * size)
    frames = 0
    if cfg.arch_type == "encdec":
        frames = bsz * cfg.enc_seq
        flops += (2 * enc + 2 * cross_kv) * frames
        flops += 2 * 2 * q * cfg.enc_seq * (cfg.enc_seq * cfg.n_enc_layers + prompt * nb) * bsz
    table = 0 if cfg.tie_embeddings else defs["embed"]
    dec_params = (blocks + cross_kv + defs["final_norm"] + defs["embed"] - table
                  + defs.get("lm_head", 0))
    attn_cache = 2 * attn_layers * bsz * cache_len * kv * size
    cross_cache = 2 * nb * frames * kv * size
    dec_pos = d if cfg.arch_type == "encdec" else 0  # a learned position's row
    pre_bytes = ((dec_params + enc + defs.get("enc_pos", 0) + defs.get("enc_norm", 0)
                  + prompt * dec_pos) * size + (tokens * d * size if table else 0)
                 + attn_cache + cross_cache + ssm_state)
    dec_bytes = ((dec_params + dec_pos) * size + (bsz * d * size if table else 0)
                 + attn_cache + cross_cache + 2 * ssm_state)
    dec_flops = (2 * (blocks + d * v) * bsz
                 + 2 * 2 * q * (cache_len * attn_layers + cfg.enc_seq * nb * (frames > 0)) * bsz)
    bound = lambda f, b: (1e3 * max(f / BF16_FLOPS_S, b / HBM_BYTES_S),
                          "operations" if f / BF16_FLOPS_S > b / HBM_BYTES_S else "bytes")
    return {"prefill_TFLOP": flops / 1e12, "prefill_GB": pre_bytes / 1e9,
            "prefill": bound(flops, pre_bytes), "decode_GFLOP": dec_flops / 1e9,
            "decode_GB": dec_bytes / 1e9, "decode": bound(dec_flops, dec_bytes)}


def serve_outputs(params, cfg, batch, tokens, routes=None) -> dict:
    """{name: tensor} of a prefill of ``batch`` (its logits and every cache
    leaf) and of a decode step of each column of ``tokens`` from it (the
    step's logits and position), then the cache's leaves after the last
    step; ``routes`` threads every call's MoE routing (pinned or
    recorded)."""
    from repro_torch.models.model import decode_step, prefill
    from repro_torch.sharding import ShardingPolicy

    pol = ShardingPolicy(remat=False)
    leaves = lambda c: {"attn.k": c.attn.k, "attn.v": c.attn.v, "ssm.conv": c.ssm.conv,
                        "ssm.state": c.ssm.state, "cross.k": c.cross.k, "cross.v": c.cross.v}
    logits, cache = prefill(params, cfg, batch, pol, cache_len=batch["tokens"].shape[1] + 8,
                            routes=routes)
    out = {"prefill logits": logits}
    out.update({f"prefill {k}": t.clone() for k, t in leaves(cache).items() if t.numel()})
    for i in range(tokens.shape[1]):
        logits, cache = decode_step(params, cfg, cache, tokens[:, i:i + 1], pol, routes=routes)
        out[f"decode {i} logits"] = logits
        out[f"decode {i} pos"] = cache.pos.clone()
    out.update({f"decode {k}": t for k, t in leaves(cache).items() if t.numel()})
    return out


def decode_profile(params, cfg, cache, token, label) -> None:
    """One eager decode step from a clone of ``cache`` under
    ``torch.profiler``: its device time, its kernels and the torch
    operators with the most device time (a replay runs the same
    kernels)."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.core import graphs
    from repro_torch.models.model import decode_step
    from repro_torch.sharding import ShardingPolicy

    cache = graphs.clone(cache)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        decode_step(params, cfg, cache, token, ShardingPolicy(remat=False))
        torch.cuda.synchronize()
    events = prof.key_averages()
    kernels = [e for e in events if e.device_type == torch.autograd.DeviceType.CUDA]
    ops = sorted((e for e in events if e.key.startswith("aten::")),
                 key=lambda e: -e.self_device_time_total)[:6]
    print(f"[{label} profile] one eager decode step: device "
          f"{sum(e.self_device_time_total for e in kernels) / 1e3:.3f} ms, "
          f"{sum(e.count for e in kernels)} kernels; the operators with the most device time: "
          + "; ".join(f"{e.key} x{e.count} {e.self_device_time_total / 1e3:.3f} ms" for e in ops),
          flush=True)


def check_serve_small(dev) -> None:
    """Phase 4i: every architecture of SERVE_SMOKE at SMOKE, in float32 and
    bf16, on the card and on the CPU from the same parameters and inputs
    (8 stub prompts of 20 tokens, qwen2-vl's patches and whisper's frames
    among them): the prefill's logits and every cache leaf, then 4 decode
    steps from each side's own cache (each step's logits and position),
    then every cache leaf.  float32 within 1e-4 of the largest magnitude;
    bf16 by each side's distance from the CPU's float64 run, the card's
    within LM_BF16_MULTIPLE of the CPU's or LM_BF16_FLOOR; a bf16 MoE
    stack pinned on both sides to the float64 run's routing."""
    from repro_torch import configs
    from repro_torch.launch import serve
    from repro_torch.models import layers as L
    from repro_torch.models.params import init_params

    for arch in SERVE_SMOKE:
        for dtype in ("float32", "bfloat16"):
            cfg = dataclasses.replace(configs.get_config(arch, "smoke"), dtype=dtype)
            params = init_params(0, cfg, "cpu")
            gen = torch.Generator().manual_seed(5)
            batch = serve.stub_batch(cfg, 8, 20, gen)
            tokens = torch.randint(0, cfg.vocab_size, (8, 4), generator=gen)
            to = lambda b, where, wide=False: {
                k: (t.double() if wide and t.is_floating_point() else t).to(where)
                for k, t in b.items()}
            pinned = cfg.is_moe_mlp and dtype == "bfloat16"
            routes64 = L.Routes() if pinned else None
            truth = serve_outputs({k: t.double() for k, t in params.items()},
                                  dataclasses.replace(cfg, dtype="float64"),
                                  to(batch, "cpu", True), tokens, routes64)
            pin = lambda: L.Routes(pin=routes64) if pinned else None
            card = serve_outputs({k: t.to(dev) for k, t in params.items()}, cfg,
                                 to(batch, dev), tokens.to(dev), pin())
            cpu = serve_outputs(params, cfg, batch, tokens, pin())
            worst = None
            for name, t in truth.items():
                g, c = card[name].cpu(), cpu[name]
                if name.endswith("pos"):
                    if not int(g) == int(c) == int(t):
                        fail(f"small serve: {cfg.name} {dtype} {name}: {int(g)}, {int(c)}, "
                             f"{int(t)}")
                    continue
                g, c, t = g.double(), c.double(), t.double()
                scale = t.abs().max().item()
                gap = (g - c).abs().max().item() / scale
                e_card = (g - t).abs().max().item() / scale
                e_cpu = (c - t).abs().max().item() / scale
                ok = (gap <= 1e-4 if dtype == "float32"
                      else e_card <= max(LM_BF16_MULTIPLE * e_cpu, LM_BF16_FLOOR))
                if not ok:
                    fail(f"small serve: {cfg.name} {dtype} {name}: card vs CPU {gap:.3e}; from "
                         f"the CPU's float64: card {e_card:.3e}, CPU {e_cpu:.3e}")
                rank = gap if dtype == "float32" else e_card / max(e_cpu, LM_BF16_FLOOR)
                if worst is None or rank > worst[0]:
                    worst = (rank, gap, e_card, e_cpu, name)
            _, gap, e_card, e_cpu, name = worst
            print(f"[small serve] {cfg.name} {dtype}: {len(truth)} outputs (prefill, 4 decode "
                  f"steps{', pinned to the float64 routing' if pinned else ''}), the tightest "
                  f"{name}: card vs CPU {gap:.3e}; from the CPU's float64: card "
                  f"{e_card:.3e}, CPU {e_cpu:.3e}; ok", flush=True)


def check_serve(dev) -> None:
    """Phase 4i: serving.  Each config of SERVE_FULL at full width (bf16,
    ``init_params`` of seed 0 drawn on the CPU, ``serve.stub_batch``): the
    build seconds; ``prefill`` twice (the first call's and the second's
    ms) beside its bound (``serve_work``); ``gen`` greedy decode steps
    eagerly (``serve.Decoder(eager=True)``) and replayed from one captured
    graph, from clones of one prefilled cache: ms a token each, tokens/s,
    the capture's seconds, the replayed tokens and last logits bit for bit
    the eager loop's; the first step's logits against ``forward``'s at
    position L (``decode_against_forward``: exact in float32, and in bf16
    no further from the float32 forward than the bf16 forward is); the
    cache's bytes, a decode step's bound, the peak of
    ``torch.cuda.max_memory_allocated`` above what the earlier phases
    hold; one eager decode step profiled (``decode_profile``).  Then the
    SMOKE card-vs-CPU checks (``check_serve_small``), no launch of the
    port's kernels over the phase (none lies on the path), and ``python -m
    repro_torch.launch.serve`` on one SMOKE family of each kind and on
    Qwen1.5-0.5B ``--variant full``, started together."""
    from repro_torch import configs
    from repro_torch.core import graphs
    from repro_torch.launch import serve
    from repro_torch.models.model import cache_bytes, forward, prefill
    from repro_torch.models.params import init_params
    from repro_torch.sharding import ShardingPolicy

    card, pol = card_name(), ShardingPolicy(remat=False)
    reset_counts()
    for arch, how in SERVE_FULL.items():
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        held = torch.cuda.memory_allocated()
        cfg = configs.get_config(arch)
        label = f"serve {cfg.name}"
        sync(dev)
        t0 = time.perf_counter()
        params = init_params(0, cfg, dev)
        sync(dev)
        build_secs = time.perf_counter() - t0
        batch = serve.stub_batch(cfg, how.batch, how.prompt,
                                 torch.Generator(device=dev).manual_seed(0))
        cache_len = how.prompt + how.gen + 1
        prefill_ms = []
        for _ in range(2):
            sync(dev)
            t0 = time.perf_counter()
            logits, cache = prefill(params, cfg, batch, pol, cache_len=cache_len)
            sync(dev)
            prefill_ms.append(1e3 * (time.perf_counter() - t0))
        token = serve.sample_token(logits, 0.0)
        work = serve_work(cfg, how.batch, how.prompt, cache_len)

        eager = serve.Decoder(cfg, params, graphs.clone(cache), token, pol, eager=True)
        sync(dev)
        t0 = time.perf_counter()
        first_tokens = eager.run(1)
        first = eager.logits.clone()
        eager_tokens = torch.cat([first_tokens, eager.run(how.gen - 1)], dim=1)
        sync(dev)
        eager_ms = 1e3 * (time.perf_counter() - t0) / how.gen
        before = dict(serve.COUNTS)
        replayed = serve.Decoder(cfg, params, graphs.clone(cache), token, pol)
        sync(dev)
        t0 = time.perf_counter()
        replay_tokens = replayed.run(how.gen)
        sync(dev)
        replay_secs = time.perf_counter() - t0
        counts = {k: serve.COUNTS[k] - before[k] for k in before}
        same = {"tokens": torch.equal(replay_tokens, eager_tokens),
                "last logits": torch.equal(replayed.logits, eager.logits)}
        if counts != {"captures": 1, "replays": how.gen}:
            fail(f"{label}: {counts}, expected one capture and {how.gen} replays")
        if not all(same.values()):
            fail(f"{label}: the replayed decode is not the eager loop's bit for bit: {same}")

        decode_profile(params, cfg, cache, token, label)
        full_batch = dict(batch, tokens=torch.cat([batch["tokens"], token], dim=1))
        held_to = decode_against_forward(params, cfg, batch, full_batch, token, first,
                                         cache_len, how.prompt, label)
        peak = torch.cuda.max_memory_allocated()
        n_bytes = cache_bytes(cache)
        (pre_bound, pre_by), (dec_bound, dec_by) = work["prefill"], work["decode"]
        replay_ms = 1e3 * replay_secs / how.gen
        frames = f", {cfg.enc_seq} stub frames each" if cfg.arch_type == "encdec" else ""
        print(f"[{label}] {card}: {cfg.n_layers} layers, d_model={cfg.d_model}, vocab "
              f"{cfg.vocab_size}, {cfg.dtype}, built in {build_secs:.3f} s; {how.batch} prompts "
              f"of {how.prompt} tokens{frames}, cache_len {cache_len}, {how.gen} tokens "
              f"generated greedily; prefill {prefill_ms[0]:.3f} ms (first call), "
              f"{prefill_ms[1]:.3f} ms (second) against its bound {pre_bound:.3f} ms "
              f"({work['prefill_TFLOP']:.3f} TFLOP, {work['prefill_GB']:.3f} GB; {pre_by}); "
              f"decode eager {eager_ms:.3f} ms/token, replayed {replay_ms:.3f} ms/token over "
              f"{how.gen} replays against a step's bound {dec_bound:.4f} ms "
              f"({work['decode_GB']:.4f} GB: the parameters and the whole cache; "
              f"{work['decode_GFLOP']:.3f} GFLOP; {dec_by}), "
              f"{how.batch * how.gen / replay_secs:.1f} tokens/s replayed; capture "
              f"{replayed.capture_secs:.3f} s; cache {n_bytes} bytes; peak "
              f"torch.cuda.max_memory_allocated {peak - held} bytes above the {held} the "
              f"earlier phases hold", flush=True)
        print(f"[{label}] replayed against the eager loop, bit for bit: {same}; {counts}; "
              f"{held_to}; first sequence's first tokens {replay_tokens[0, :8].tolist()}",
              flush=True)
        del params, batch, logits, cache, eager, replayed, first, full_batch
    check_serve_small(dev)
    launched = {k: n for k, n in read_counts().items() if n}
    print(f"[serve] launches of the port's kernels over the phase: {launched or 'none'}",
          flush=True)
    if launched:
        fail(f"serving launched the port's kernels: {launched}")

    def result(label, lines):
        if (len(lines) != 2 or not lines[0].startswith("generated (")
                or "tok/s incl. compile)" not in lines[0]
                or not lines[1].startswith("first sequence: [")):
            fail(f"the command line ({label}) printed {lines!r}")
        return "; ".join(lines)

    smoke = ("qwen1.5-0.5b", "mamba2-370m", "llama4-scout-17b-16e", "jamba-1.5-large-398b",
             "qwen2-vl-7b", "whisper-base")
    commands = {f"serve {arch}": ["--arch", arch] for arch in smoke}
    commands["serve qwen1.5-0.5b full"] = ["--arch", "qwen1.5-0.5b", "--variant", "full"]
    run_clis("serve", commands, result)


def check_per_client(cobjs, dev) -> dict:
    """Phase 7: the per-client engine at the main path's width; returns the
    launch counts of its resident and tiled runs."""
    cfg = main_config(defer_repair=False)
    run_path(cfg, cobjs, 1, dev)  # warm-up: the eigh and solver handles
    res, secs, counts = run_path(cfg, cobjs, PER_CLIENT_ROUNDS, dev)
    print(f"[per-client] d={D} N={N_CLIENTS} M={M} cap={CAP} T={cfg.local_steps}: "
          f"{PER_CLIENT_ROUNDS} rounds in {secs:.3f} s, "
          f"{1e3 * secs / PER_CLIENT_ROUNDS:.3f} ms/round; launches {counts}", flush=True)
    check_result(res, cfg, PER_CLIENT_ROUNDS, "per-client", must_fall=False)
    if res.repair_rate.abs().max().item() != 0.0:
        fail("per-client: the inline engine flagged a repair")
    steps = N_CLIENTS * PER_CLIENT_ROUNDS * cfg.local_steps
    want = expect(score_single_resident=steps + N_CLIENTS * PER_CLIENT_ROUNDS,
                  grad_single_resident=steps, **fzoos_counts(cfg, PER_CLIENT_ROUNDS))
    if counts != want:
        fail(f"per-client launches {counts}, expected {want}")

    tcfg = main_config(defer_repair=False, score_block_cap=TILE, grad_block_cap=TILE)
    tres, tsecs, tcounts = run_path(tcfg, cobjs, 1, dev)
    print(f"[per-client tiled] cap tiles of {TILE}: 1 round in {tsecs:.3f} s; launches "
          f"{tcounts}", flush=True)
    check_result(tres, tcfg, 1, "per-client tiled", must_fall=False)
    twant = expect(score_single_tiled=N_CLIENTS * (tcfg.local_steps + 1),
                   grad_single_tiled=N_CLIENTS * tcfg.local_steps, **fzoos_counts(tcfg, 1))
    if tcounts != twant:
        fail(f"per-client tiled launches {tcounts}, expected {twant}")

    check_small_against_cpu(dev, "small per-client", defer_repair=False)
    check_small_against_cpu(dev, "small seed", use_factor_cache=False)
    check_engine_inputs(dev, "small per-client engine inputs", defer_repair=False)
    check_engine_inputs(dev, "small per-client engine inputs, cap tiles of 8",
                        defer_repair=False, score_block_cap=8)
    check_engine_inputs(dev, "small per-client engine inputs, gradient cap tiles of 8",
                        defer_repair=False, grad_block_cap=8)
    profile_round(cfg, cobjs, dev, "per-client profile")
    return {**counts, **{k: v for k, v in tcounts.items() if v}}


def check_fd_baselines(dev) -> None:
    """Phase 8: the FD baselines at the main path's width, q=20: the loop
    (``chunk=0``) with its launch counts, then the default (one captured
    chunk) held to it (``hold_to_loop``: no FD engine flags a client, so
    bit for bit)."""
    from repro_torch.core import algorithms as alg
    from repro_torch.core import graphs
    from repro_torch.core import objectives as obj

    cobjs = obj.make_quadratic(0, N_CLIENTS, D, 5.0, 0.001, device=dev)
    for name in ("fedzo", "fedprox", "scaffold1", "scaffold2"):
        cfg = main_config(name)
        res, secs, counts = run_path(cfg, cobjs, FD_ROUNDS, dev)
        print(f"[{name}] d={D} N={N_CLIENTS} q={cfg.q}: {FD_ROUNDS} rounds in {secs:.3f} s, "
              f"{1e3 * secs / FD_ROUNDS:.3f} ms/round", flush=True)
        check_result(res, cfg, FD_ROUNDS, name, must_fall=False)
        # no scoring, gradient-mean or RFF launch; one SE Gram: the init
        # Gram of factor_init at init_states (cap=1)
        fd_want = expect(sqexp=1)
        if counts != fd_want:
            fail(f"{name} launches {counts}, expected {fd_want}")
        # the default (chunk=None): one captured chunk of FD_ROUNDS rounds
        graphs.COUNTS.update(captures=0, replays=0)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        default = alg.simulate(cfg, 1, cobjs, obj.quadratic_query, obj.quadratic_global_value,
                               FD_ROUNDS, device=dev)
        torch.cuda.synchronize()
        print(f"[{name} default] one captured chunk of {FD_ROUNDS} rounds: the whole call "
              f"{time.perf_counter() - t0:.3f} s", flush=True)
        if graphs.COUNTS != {"captures": 1, "replays": 1}:
            fail(f"{name} default: {graphs.COUNTS}, expected 1 capture and 1 replay")
        hold_to_loop(res, default, f"{name} default")


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 1
    from repro_torch.core import objectives as obj
    from repro_torch.kernels import loader, sqexp

    dev = torch.device("cuda")
    kind = torch.cuda.get_device_name(0)
    card = card_name()
    print(f"[card] {kind}; torch {torch.__version__}, CUDA {torch.version.cuda}", flush=True)
    print(card, flush=True)

    t0 = time.perf_counter()
    loader.library()
    print(f"[build] kernels built and loaded in {time.perf_counter() - t0:.1f} s", flush=True)

    rows = check_kernels(dev)
    check_tiled_accuracy(dev)
    check_tiled_grad_accuracy(dev)
    check_projection_accuracy(dev)

    cfg = main_config()
    cobjs = obj.make_quadratic(0, N_CLIENTS, D, 5.0, 0.001, device=dev)
    run_path(cfg, cobjs, 1, dev)  # warm-up: library handles, allocator
    res, secs, main_counts = run_path(cfg, cobjs, ROUNDS, dev)
    one_row = sqexp.LAUNCHES_BY_ROWS.get(1, 0)  # the iterates' append events
    init_gram = sqexp.LAUNCHES_BY_ROWS.get(CAP, 0)  # factor_init's
    print(f"[main] d={D} N={N_CLIENTS} M={M} cap={CAP} T={cfg.local_steps}: {ROUNDS} rounds in "
          f"{secs:.3f} s, {1e3 * secs / ROUNDS:.3f} ms/round; launches {main_counts} "
          f"({one_row} of the sqexp launches with 1 row)", flush=True)
    check_result(res, cfg, ROUNDS, "main")
    steps = ROUNDS * cfg.local_steps
    want = expect(score_resident=steps + ROUNDS, grad_resident=steps,
                  **fzoos_counts(cfg, ROUNDS))
    if main_counts != want:
        fail(f"main path launches {main_counts}, expected {want}")
    if one_row != steps:  # one per local step: the iterate's append event
        fail(f"main path: {one_row} SE Gram launches with 1 row, expected {steps}")
    if init_gram != 1:  # factor_init's, once per run
        fail(f"main path: {init_gram} SE Gram launches with {CAP} rows, expected 1")
    check_small_against_cpu(dev)
    straight, straight_draws, straight_secs = check_captured(cfg, cobjs, dev)
    check_chunk_layout(cfg, cobjs, dev)
    time_whole_runs(cfg, cobjs, dev)
    check_small_captured(dev)
    check_checkpoint(cfg, cobjs, dev, straight, straight_draws, straight_secs)
    check_engine_inputs(dev, "small engine inputs")
    check_engine_inputs(dev, "small engine inputs, cap tiles of 8", score_block_cap=8)
    check_engine_inputs(dev, "small engine inputs, gradient cap tiles of 8", grad_block_cap=8)
    check_objectives(dev)
    check_faults(cfg, cobjs, dev)
    check_rollback(cfg, cobjs, dev)
    check_pool(cfg, cobjs, dev, straight, straight_draws)
    check_lm(dev)
    t0 = time.perf_counter()
    check_serve(dev)
    print(f"[serve] phase 4i in {time.perf_counter() - t0:.1f} s", flush=True)
    profile_round(cfg, cobjs, dev)

    ocfg = main_config(score_block_cap=TILE, grad_block_cap=TILE)
    ores, osecs, other_counts = run_path(ocfg, cobjs, OTHER_ROUNDS, dev)
    print(f"[other] cap tiles of {TILE}: {OTHER_ROUNDS} rounds in {osecs:.3f} s; launches "
          f"{other_counts}", flush=True)
    check_result(ores, ocfg, OTHER_ROUNDS, "other")
    osteps = OTHER_ROUNDS * ocfg.local_steps
    owant = expect(score_tiled=osteps + OTHER_ROUNDS, grad_tiled=osteps,
                   **fzoos_counts(ocfg, OTHER_ROUNDS))
    if other_counts != owant:
        fail(f"other route launches {other_counts}, expected {owant}")

    single_counts = check_per_client(cobjs, dev)
    check_fd_baselines(dev)

    main_counts["sqexp[1 row]"] = one_row
    main_counts["sqexp[init Gram]"] = init_gram
    for row in rows:  # each kernel's launches, from the run of the route it serves
        name = row["name"]
        row["launches"] = (main_counts[name] or other_counts.get(name, 0)
                           or single_counts.get(name, 0))
    print(card, flush=True)
    print(json.dumps({"kernels": rows}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
