#!/usr/bin/env python3
"""Where the time of the GP scoring and gradient-mean kernels goes: the
client-batched cluster kernels (B1, B3), the single-client scoring (B7a),
the cap-tiled scoring (B7b for one client, B2 for five) and the other
gradient routes (B8a, and B8b and B4 on cap tiles).

    python3 scripts/cluster_phases.py [--csrc DIR]   # on a machine with one CUDA card

Copies the kernel sources of ``DIR`` (default: the package's
``src/repro_torch/kernels/csrc``) into ``build/cluster_phases/<hash>/``,
adds ``%globaltimer`` laps taken by thread 0 of every block at the step
boundaries of each known kernel that the sources hold (the current ones
and those they replaced, so ``DIR`` may be an older tree's sources), builds
the copies of ``gp_score.cu`` and ``gp_grad.cu`` into their own library and
launches, through that tree's C entries:

* B1 and B3 at the main path's shapes (``chip_smoke.path_inputs``: N=5,
  n=50 padded to the candidate tile, cap=192, d=300; one query point per
  client for B3);
* B7a on client 0 of the same inputs, and B7b and B2 (one client, five)
  with the cap tile pinned at ``chip_smoke.TILE`` = 64 rows;
* B7b at cap=1000 and cap=4096 (n=50, d=300, tile 256), as the smoke's
  tiled-accuracy line runs it;
* the gradient mean at one query point per client: B8a on one client of
  the main path's shapes, B8b and B4 (one client, five) with the cap tile
  pinned at ``chip_smoke.TILE``, and B8b at cap=1000 and cap=4096 (tile
  256), as the smoke's tiled-gradient line runs it.

A lap adds the time since the block's previous lap to its step, so a step
inside a loop sums over the loop.  For each launch it prints the blocks,
the span, when the blocks started (one wave or more) and each step's mean
and max over the blocks, then the profiler's device time per call of the
stamped kernels; and the device time of one empty kernel launch, the floor
of any kernel; first the card's name and power limit.  The laps cost a
few instructions per step; the kernels' own library is not touched.  A
step boundary that is no longer where the laps go raises.
"""

from __future__ import annotations

import argparse
import ctypes
import hashlib
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "src"))

import chip_smoke  # noqa: E402
from repro_torch.kernels import autotune, loader, ops  # noqa: E402

OUT = ROOT / "build" / "cluster_phases"
SLOTS = 16  # per block: its start, then one sum per step
WORDS = 1 << 18  # of each buffer: 16,383 blocks
MACRO = (
    '#ifndef FZ_LAP\n'
    '#define FZ_BLK_ ((blockIdx.z * gridDim.y + blockIdx.y) * gridDim.x + blockIdx.x)\n'
    '#define FZ_NOW_(t) asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t))\n'
    '#define FZ_LAP_START(buf) unsigned long long fz_last_ = 0; if (threadIdx.x == 0) { '
    'FZ_NOW_(fz_last_); if (FZ_BLK_ == 0) buf[0] = (unsigned long long)gridDim.x * gridDim.y * '
    f'gridDim.z; unsigned long long* s_ = buf + (({SLOTS} + FZ_BLK_ * {SLOTS}) & ({WORDS} - 1)); '
    f's_[0] = fz_last_; for (int k_ = 1; k_ < {SLOTS}; ++k_) s_[k_] = 0; }}\n'
    '#define FZ_LAP(buf, k) do { if (threadIdx.x == 0) { unsigned long long t_; FZ_NOW_(t_); '
    f'buf[({SLOTS} + FZ_BLK_ * {SLOTS} + (k)) & ({WORDS} - 1)] += t_ - fz_last_; fz_last_ = t_; }} '
    '} while (0)\n'
    '#endif\n')
BUFFER = f"static __device__ unsigned long long g_st_{{buf}}[{WORDS}];\n"
READ = ('\nextern "C" int fz_stamps_{buf}(void* dst, int n) {{ return (int)cudaMemcpyFromSymbol('
        'dst, g_st_{buf}, sizeof(unsigned long long) * n); }}\n'
        'extern "C" int fz_stamps_clear_{buf}() {{ unsigned long long z[1] = {{0}}; '
        'return (int)cudaMemcpyToSymbol(g_st_{buf}, z, sizeof(z)); }}\n')
EMPTY = ('#include <cuda_runtime.h>\n__global__ void fz_empty_kernel() {}\n'
         'extern "C" int fz_empty(void* stream) { fz_empty_kernel<<<1, 32, 0, '
         '(cudaStream_t)stream>>>(); return (int)cudaGetLastError(); }\n')
HOME = '#include "common.cuh"\n'

# file -> [(kernel signature anchor, a line only that version of it holds, buffer,
#           the line after which its laps start, [(anchor, step, lap before the anchor?)],
#           step names)]
PLAN = {
    "gp_score.cu": [
        # B1 and, since it launches it with one client, B7a
        ("score_cluster_kernel(const float* __restrict__ c,", "  cluster_arrive_relaxed();\n",
         "cluster", "  cluster_arrive_relaxed();\n", [
             ("  cp_async_wait<kStages>();\n  __syncthreads();\n", 1, False),
             ("  cluster_wait();  // every block of the cluster has started\n", 2, True),
             ("  cluster.sync();  // every block's part of h has arrived everywhere\n", 3, True),
             ("  // step 5:", 4, True),
             ("  double* gs = ", 5, True),
             ("  cluster.sync();  // every rank's partial is in rank 0's red\n", 6, True),
             ("  if (rank == 0 && (int)threadIdx.x < BN) {", 7, True),
             ("        (float)fmax((double)prior - tot * (double)inv_l4, 0.0);\n  }\n", 8, False),
         ], ["staging", "h rows", "push h", "barrier", "column sums", "epilogue", "barrier",
             "store"]),
        # the earlier single-client resident body (B7a before it took the cluster kernel)
        ("score_resident_kernel(const float* __restrict__ c,",
         "  score_cell<BN>(sh, cap, cap, sh, scr,", "resident",
         "  const size_t g0 = (size_t)cl * cap * cap;\n", [
             ("  load_cands<BN>(c + ((size_t)cl * n + row0) * d, d, sc, sn1);\n", 1, False),
             ("  h_tile<BN>(sc, sn1, xb, d, 0, cap, inv_two_l2, sh, scr, cap);\n"
              "  __syncthreads();\n", 2, False),
             ("  score_store<BN>(acc, red, out", 3, True),
             ("  score_store<BN>(acc, red, out + (size_t)cl * n + row0, inv_l4, prior);\n", 4,
              False),
         ], ["candidates", "h, c.x", "cell sweep", "block sum, store"]),
        # the earlier cap-tiled body (B2, B7b): h_j, h_k and c.x_k per (j, k) cell
        ("score_tiled_kernel(const float* __restrict__ c,", "  for (int j0 = 0; j0 < cap; j0 += bc) {",
         "tiled", "  const size_t g0 = (size_t)cl * cap * cap;\n", [
             ("  load_cands<BN>(c + ((size_t)cl * n + row0) * d, d, sc, sn1);\n", 1, False),
             ("    h_tile<BN>(sc, sn1, xb, d, j0, bc, inv_two_l2, shj, nullptr, bc);\n", 2, False),
             ("      h_tile<BN>(sc, sn1, xb, d, k0, bc, inv_two_l2, shk, sck, bc);\n"
              "      __syncthreads();\n", 3, False),
             ("      __syncthreads();  // the next cell overwrites shk / sck (and shj after the "
              "sweep)\n", 4, False),
             ("  score_store<BN>(acc, red, out + (size_t)cl * n + row0, inv_l4, prior);\n", 5,
              False),
         ], ["candidates", "h_j tiles", "h_k, c.x_k tiles", "cells", "block sum, store"]),
        # the cap-tiled route (B2, B7b): the h pass, the panel products, the sums
        ("score_h_kernel(const float* __restrict__ c,", "  double* hb = hm + (size_t)cl * cap * n",
         "tiled_h", "  const int cl = blockIdx.z, i0 = blockIdx.y * BN, t0 = blockIdx.x * kHRows;\n", [
             ("  __syncthreads();  // the candidates and their norms\n", 1, False),
             ("        mb[at] = 2.0 * cr - sn1[i];\n      }\n    }\n  }\n", 2, False),
         ], ["candidates", "h, m rows"]),
        ("score_panel_kernel(const double* __restrict__ hm,", "  auto stage = [&](int ch) {",
         "panel", "  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, ib = warp * CPW;\n", [
             ("    cp_async_wait<kStages - 1>();  // chunk ch has landed\n    __syncthreads();\n",
              1, False),
             ("    __syncthreads();  // the buffer is free again\n", 2, False),
             ("    if (lane == 0 && ib + q < gn) part[((size_t)cl * n + i) * cells + cell] = t;\n"
              "  }\n", 3, False),
         ], ["copies, waits", "products", "epilogue"]),
        ("score_sum_kernel(const double* __restrict__ part,", "  for (int e = lane; e < cells;",
         "sums", "  const int cl = blockIdx.y, i = blockIdx.x * kWarps + warp;\n", [
             ("  if (lane == 0) out[(size_t)cl * n + i] = (float)fmax(prior - s * inv_l4, 0.0);\n",
              1, False),
         ], ["sums, store"]),
    ],
    "gp_grad.cu": [
        # the earlier client-batched resident body (B3 before the gradient
        # routes became one cluster kernel)
        ("grad_cluster_kernel(const float* __restrict__ c,", "  SmemCarve m{(uintptr_t)smem_raw};",
         "grad", "  cg::cluster_group cluster = cg::this_cluster();\n", [
             ("  cp_async_wait<0>();\n  __syncthreads();\n", 1, False),
             ("  for (int k = threadIdx.x; k < d; k += blockDim.x) {\n    double acc[BN]", 2, True),
             ("  cluster.sync();  // every rank's partials are written\n", 3, True),
             ("  const int k0 = split_at(d, cs, rank)", 4, True),
             ("  cluster.sync();  // the other ranks have read", 5, True),
         ], ["staging", "w rows", "partial sums", "barrier", "rank sums"]),
        # every gradient route (B3, B4, B8a, B8b): the rows streamed in chunks
        ("grad_cluster_kernel(const float* __restrict__ c,",
         "  const GradClusterSmem at = grad_cluster_smem<BN>(d, jc, nbuf);", "grad_stream",
         "  cg::cluster_group cluster = cg::this_cluster();\n", [
             ("  load_cands_t<BN, double>(c + ((size_t)cl * n + row0) * d, d, sc, sn1);\n", 1,
              False),
             ("    cp_async_wait<1>();  // chunk ch has landed\n"
              "    __syncthreads();     // ... for every thread\n", 2, False),
             ("    for (int k = threadIdx.x; k < d; k += blockDim.x) {\n      double acc[BN]", 3,
              True),
             ("    __syncthreads();  // the chunk's buffer and w are free again\n", 4, False),
             ("  cluster.sync();  // every rank's partials are written\n", 5, False),
             ("  cluster.sync();  // the other ranks have read", 6, True),
         ], ["candidates", "copy waits", "w rows", "partial sums", "barrier", "rank sums"]),
        # the earlier single-client resident body (B8a), one block per tile
        ("grad_resident_kernel(const float* __restrict__ c,",
         "  weight_tile<BN>(sw, cap, cap, alpha", "grad_resident",
         "  const float* xb = x + (size_t)cl * cap * d;\n", [
             ("  load_cands<BN>(c + ((size_t)cl * n + row0) * d, d, sc, sn1);\n", 1, False),
             ("  h_tile<BN>(sc, sn1, xb, d, 0, cap, inv_two_l2, sw, nullptr, cap);\n"
              "  __syncthreads();\n", 2, False),
             ("  weight_tile<BN>(sw, cap, cap, alpha + (size_t)cl * cap, 0, ss);\n", 3, False),
             ("  product_tile<BN>(sw, cap, cap, xb, 0, d, sacc, true);\n", 4, False),
             ("  grad_store<BN>(sacc, ss, sc, out + ((size_t)cl * n + row0) * d, d, inv_l2);\n", 5,
              False),
         ], ["candidates", "h rows", "weight sum", "product", "store"]),
        # the earlier cap-tiled body (B4, B8b), one block per tile
        ("grad_tiled_kernel(const float* __restrict__ c,",
         "  for (int t0 = 0; t0 < cap; t0 += bc) {", "grad_tiled", "  const float* ab = alpha + (size_t)cl * cap;\n", [
             ("  load_cands<BN>(c + ((size_t)cl * n + row0) * d, d, sc, sn1);\n", 1, False),
             ("    h_tile<BN>(sc, sn1, xb, d, t0, bc, inv_two_l2, sw, nullptr, bc);\n"
              "    __syncthreads();\n", 2, False),
             ("    weight_tile<BN>(sw, bc, bc, ab, t0, ss);\n", 3, False),
             ("    product_tile<BN>(sw, bc, bc, xb, t0, d, sacc, t0 == 0);\n"
              "    __syncthreads();  // the next tile overwrites sw\n", 4, False),
             ("  grad_store<BN>(sacc, ss, sc, out + ((size_t)cl * n + row0) * d, d, inv_l2);\n", 5,
              False),
         ], ["candidates", "h tiles", "weight sums", "products", "store"]),
    ],
}

STEPS: dict[str, list[str]] = {}  # a buffer's step names


def stamped(name: str, text: str) -> tuple[str, list[str]]:
    """The source with laps at the step boundaries of its known kernels, and
    the buffers it defines."""
    bufs = []
    for kernel, marker, buf, start, laps, steps in PLAN.get(name, []):
        if kernel not in text:
            continue
        k0 = text.index(kernel)
        body = text[k0:]
        if marker not in body:
            continue
        body = body.replace(start, start + f"  FZ_LAP_START(g_st_{buf});\n", 1)
        for anchor, k, before in laps:
            if anchor not in body:
                raise RuntimeError(f"{name}: step boundary {anchor!r} of {buf} not found")
            mark = f"  FZ_LAP(g_st_{buf}, {k});\n"
            body = body.replace(anchor, mark + anchor if before else anchor + mark, 1)
        text = text[:k0] + body
        text = text.replace(HOME, HOME + MACRO + BUFFER.format(buf=buf), 1)
        bufs.append(buf)
        STEPS[buf] = steps
    return text, bufs


def build(csrc: Path):
    """Stamped copies of gp_score.cu and gp_grad.cu (with csrc's headers),
    plus the empty kernel, as one library: (library, buffers by source)."""
    files = sorted(csrc.glob("*.cuh")) + [csrc / "gp_score.cu", csrc / "gp_grad.cu"]
    digest = hashlib.sha256(b"".join(f.read_bytes() for f in files)
                            + Path(__file__).read_bytes()).hexdigest()[:12]
    out = OUT / digest
    out.mkdir(parents=True, exist_ok=True)
    for f in files[:-2]:
        (out / f.name).write_text(f.read_text())
    bufs, procs, objs = {}, [], []
    for name in ("gp_score.cu", "gp_grad.cu", "empty.cu"):
        text, own = (EMPTY, []) if name == "empty.cu" else stamped(name, (csrc / name).read_text())
        text += "".join(READ.format(buf=b) for b in own)
        (out / name).write_text(text)
        bufs[name] = own
        obj = out / (name[:-3] + ".o")
        procs.append(subprocess.Popen([loader._nvcc(), *loader.NVCC_FLAGS, "-I", str(out), "-c",
                                       str(out / name), "-o", str(obj)]))
        objs.append(str(obj))
    if any(p.wait() for p in procs):
        raise RuntimeError("nvcc failed for the stamped sources")
    lib = out / "libcluster_phases.so"
    subprocess.run([loader._nvcc(), *loader.NVCC_FLAGS, "-shared", *objs, "-o", str(lib)],
                   check=True)
    return ctypes.CDLL(str(lib)), bufs


def entry_takes(text: str, entry: str, what: str) -> bool:
    """Whether the C entry ``entry`` of a source has ``what`` in its parameters."""
    m = re.search(rf"extern \"C\" int {entry}\(([^)]*)\)", text)
    if m is None:
        raise RuntimeError(f"{entry} not found")
    return what in m.group(1)


def report(lib, buf: str, label: str) -> bool:
    """Print the laps of buffer ``buf``'s last launch; False if it has none."""
    steps = STEPS[buf]
    head = np.zeros(1, dtype=np.uint64)
    if getattr(lib, f"fz_stamps_{buf}")(head.ctypes.data, 1):
        raise RuntimeError("reading the stamps failed")
    nblk = int(head[0])
    if nblk == 0:
        return False
    raw = np.zeros(SLOTS + nblk * SLOTS, dtype=np.uint64)
    getattr(lib, f"fz_stamps_{buf}")(raw.ctypes.data, raw.size)
    t = raw[SLOTS:].reshape(nblk, SLOTS)[:, :len(steps) + 1].astype(np.int64)
    start = t[:, 0] - t[:, 0].min()
    laps = t[:, 1:] / 1e3
    end = start / 1e3 + laps.sum(1)
    print(f"{label} [{buf}]: {nblk} blocks, span {end.max():.2f} us, blocks started between 0 "
          f"and {start.max() / 1e3:.2f} us (median {np.median(start) / 1e3:.2f})", flush=True)
    for s, name in enumerate(steps):
        print(f"  {name:>16}: mean {laps[:, s].mean():.2f} us, max {laps[:, s].max():.2f} us",
              flush=True)
    return True


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--csrc", type=Path, default=loader.CSRC,
                    help="kernel sources to stamp (default: this tree's)")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("cluster_phases: no CUDA device available", file=sys.stderr)
        return 1
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip(), flush=True)
    csrc = args.csrc.resolve()
    lib, bufs = build(csrc)
    score_src = (csrc / "gp_score.cu").read_text()
    # the earlier single-client resident entry took no cluster geometry, the
    # earlier tiled entries no work buffer (and f32 scalars)
    single_cluster = entry_takes(score_src, "fz_score_single_resident", "int cs")
    tiled_work = entry_takes(score_src, "fz_score_tiled", "double* work")
    dev = torch.device("cuda")
    stream = lambda: ctypes.c_void_p(torch.cuda.current_stream().cuda_stream)
    P, F, Dd = ctypes.c_void_p, ctypes.c_float, ctypes.c_double
    ptr = lambda t: P(t.data_ptr())

    def scalars(p, f64):
        l2 = p["ls"] ** 2
        kind = Dd if f64 else F
        return kind(0.5 / l2), kind(1 / l2**2), kind(p["prior"])

    def inputs(nb, n, cap, d, bn):
        p = chip_smoke.path_inputs(dev, nb, n, cap, d)
        npad = -(-n // bn) * bn
        p["cpad"] = ops._pad_axis(p["cands"], 1, npad).contiguous()
        return p, npad

    n, cap, d, nb = chip_smoke.CANDS, chip_smoke.CAP, chip_smoke.D, chip_smoke.N_CLIENTS
    main = chip_smoke.path_inputs(dev)
    bn1, _ = autotune.select_blocks("score_clients", n=n, cap=cap, d=d)
    cs, jc = autotune.cluster_geometry(cap)
    p1, npad1 = inputs(nb, n, cap, d, bn1)
    s1 = torch.empty((nb, npad1), device=dev)
    g3 = torch.empty((nb, 1, d), device=dev)
    b1 = lambda: lib.fz_score_resident(
        ptr(p1["cpad"]), ptr(p1["xs_sh"]), ptr(p1["binv"]), ptr(p1["pmat"]), ptr(s1), nb, npad1,
        cap, d, bn1, cs, jc, *scalars(p1, False), stream())
    b3 = lambda: lib.fz_grad_resident(
        ptr(main["query"]), ptr(main["xs"]), ptr(main["alpha"]), ptr(g3), nb, 1, cap, d, 1, cs,
        F(0.5 / main["ls"] ** 2), F(1 / main["ls"] ** 2), stream())

    # B7a: the earlier entry took 8 candidates per block, one block per tile
    bn7 = autotune.select_blocks("score", n=n, cap=cap, d=d)[0] if single_cluster else 8
    p7, npad7 = inputs(1, n, cap, d, bn7)
    one = lambda key: p7[key][0].contiguous()
    c7, x7, bm7, pm7 = one("cpad"), one("xs_sh"), one("binv"), one("pmat")
    s7 = torch.empty(npad7, device=dev)
    geo7 = autotune.cluster_geometry(cap, single=True) if single_cluster else ()
    b7a = lambda: lib.fz_score_single_resident(ptr(c7), ptr(x7), ptr(bm7), ptr(pm7), ptr(s7),
                                               npad7, cap, d, bn7, *geo7,
                                               *scalars(p7, False), stream())

    def tiled(nbt, ncand, capt, tile):
        """A cap-tiled scoring launch (B7b for one client, B2 for more)."""
        bn = autotune.select_blocks("score", n=ncand, cap=capt, d=d)[0] if tiled_work else 8
        p, npad = inputs(nbt, ncand, capt, d, bn)
        out = torch.empty((nbt, npad), device=dev)
        work = (torch.empty(autotune.score_tiled_work(nbt, npad, capt, tile), dtype=torch.float64,
                            device=dev),) if tiled_work else ()
        args = [ptr(p["cpad"]), ptr(p["xs_sh"]), ptr(p["binv"]), ptr(p["pmat"]), ptr(out),
                *(ptr(w) for w in work)]
        tail = (capt, d, bn, tile, *scalars(p, tiled_work), stream())
        if nbt == 1:
            return lambda: lib.fz_score_single_tiled(*args, npad, *tail)
        return lambda: lib.fz_score_tiled(*args, nbt, npad, *tail)

    # the gradient mean at one query point per client: the earlier single-
    # client resident entry took no cluster size, the earlier tiled entries
    # a cap tile dividing cap (the trajectory zero-padded to it)
    grad_src = (csrc / "gp_grad.cu").read_text()
    grad_cluster = entry_takes(grad_src, "fz_grad_single_resident", "int cs")
    l2 = main["ls"] ** 2
    gsc = (F(0.5 / l2), F(1 / l2))

    def grad(nbg, capg, tile=None):
        """A gradient-mean launch: B8a (one client, tile None), B8b (one
        client, cap tile) or B4 (more clients, cap tile)."""
        p = chip_smoke.path_inputs(dev, nbg, 1, capg, d)
        q, xg, ag = p["query"], p["xs"], p["alpha"]
        out = torch.empty((nbg, 1, d), device=dev)
        if tile is None:
            geo = autotune.cluster_geometry(capg, single=True)[:1] if grad_cluster else ()
            return lambda: lib.fz_grad_single_resident(ptr(q), ptr(xg), ptr(ag), ptr(out), 1,
                                                       capg, d, 1, *geo, *gsc, stream())
        if grad_cluster:
            geo = autotune.grad_geometry(capg, d, 1, tile)
        else:
            cpad = -(-capg // tile) * tile
            xg = ops._pad_axis(xg, 1, cpad).contiguous()
            ag = ops._pad_axis(ag, 1, cpad).contiguous()
            capg, geo = cpad, (tile,)
        head = (ptr(q), ptr(xg), ptr(ag), ptr(out))
        if nbg == 1:
            return lambda: lib.fz_grad_single_tiled(*head, 1, capg, d, 1, *geo, *gsc, stream())
        return lambda: lib.fz_grad_tiled(*head, nbg, 1, capg, d, 1, *geo, *gsc, stream())

    tile = chip_smoke.TILE
    runs = [
        (f"B1 score_cluster_kernel<{bn1}> (N={nb}, cluster {cs}, chunks of {jc} rows)", b1,
         "gp_score.cu"),
        (f"B3 grad_cluster_kernel<1> (N={nb}, cluster {cs})", b3, "gp_grad.cu"),
        (f"B7a one client, n={n} padded to {npad7}, {bn7} candidates per tile", b7a,
         "gp_score.cu"),
        (f"B7b one client, cap tile {tile}", tiled(1, n, cap, tile), "gp_score.cu"),
        (f"B2 {nb} clients, cap tile {tile}", tiled(nb, n, cap, tile), "gp_score.cu"),
        ("B7b one client, cap=1000, tile 256", tiled(1, n, 1000, 256), "gp_score.cu"),
        ("B7b one client, cap=4096, tile 256", tiled(1, n, 4096, 256), "gp_score.cu"),
        (f"B8a one client's gradient mean, cap={cap}", grad(1, cap), "gp_grad.cu"),
        (f"B8b one client's gradient mean, cap tile {tile}", grad(1, cap, tile), "gp_grad.cu"),
        (f"B4 {nb} clients' gradient mean, cap tile {tile}", grad(nb, cap, tile), "gp_grad.cu"),
        ("B8b one client's gradient mean, cap=1000, tile 256", grad(1, 1000, 256), "gp_grad.cu"),
        ("B8b one client's gradient mean, cap=4096, tile 256", grad(1, 4096, 256), "gp_grad.cu"),
    ]
    for label, fn, src in runs:
        for _ in range(3):  # warm; the last launch's laps are read
            for buf in bufs[src]:
                getattr(lib, f"fz_stamps_clear_{buf}")()
            loader.check(fn(), label)
        torch.cuda.synchronize()
        for buf in bufs[src]:
            report(lib, buf, label)
        print(f"{label}: device time {1e3 * chip_smoke.device_ms(fn):.2f} us per call "
              f"(profiler, stamped kernels)", flush=True)
    empty = lambda: lib.fz_empty(stream())
    print(f"empty kernel (1 block of 32 threads): device time "
          f"{1e3 * chip_smoke.device_ms(empty, reps=200):.3f} us per launch (profiler)",
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
