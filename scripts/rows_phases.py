#!/usr/bin/env python3
"""Where the time of the RFF gradient (B5), the RFF features (B6) and the
SE Gram (B9: its append events and factor_init's init Gram) goes.

    python3 scripts/rows_phases.py [--csrc DIR]   # on a machine with one CUDA card

Copies the kernel sources of ``DIR`` (default: the package's
``src/repro_torch/kernels/csrc``) into ``build/rows_phases/<hash>/``, adds
a ``%globaltimer`` stamp taken by thread 0 of every block at each step
boundary of the kernels that B5, B6 and B9 launch, builds the copies of
``rff_grad.cu``, ``rff_features.cu`` and ``sqexp.cu`` into their own
library, launches B5 (n=5 iterates, per-row w, M=512, d=300), B9's append
events (5 rows and 1 row against the (5, 192, 300) ring), B6 on the ring's
960 rows (M=512) and factor_init's (5, 192, 192) init Gram at the main
path's shapes (``chip_smoke.rff_and_gram_inputs``) and prints, per kernel:
the blocks, the span of the launch, when the blocks started, and each
step's mean and max duration over the blocks.  The projection's tile
kernel (B6, the init Gram) repeats its steps once per d chunk, so there
thread 0 adds up each step's ``clock64`` cycles over the chunks and the
block's ``%globaltimer`` span is split in their proportion ("laps").
Each known kernel (the current ones and the two-kernel B5, rows kernel and
f32 tile kernel they replaced, so ``--csrc`` may name an older tree's
sources) is stamped where the sources hold it; a step boundary that is no
longer where the stamps go raises.  It also prints the
device time (``torch.profiler``) and CUDA-event time of one empty kernel
launch: the floor any kernel this small meets.  The stamps cost a few
instructions per step; the kernels' own library is not touched.
"""

from __future__ import annotations

import argparse
import ctypes
import hashlib
import math
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "src"))

import chip_smoke  # noqa: E402
from repro_torch.kernels import loader  # noqa: E402

OUT = ROOT / "build" / "rows_phases"
SLOTS = 16  # stamps per block
MACRO = ('#ifndef FZ_STAMP\n'
         '#define FZ_STAMP(buf, k) do { if (threadIdx.x == 0) { unsigned long long t_; '
         'asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t_)); '
         'const unsigned b_ = (blockIdx.z * gridDim.y + blockIdx.y) * gridDim.x + blockIdx.x; '
         'if (b_ == 0 && (k) == 0) buf[0] = (unsigned long long)gridDim.x * gridDim.y * gridDim.z; '
         f'buf[({SLOTS} + b_ * {SLOTS} + (k)) & 0xffff] = t_; }} }} while (0)\n'
         '#endif\n'
         '#ifndef FZ_LAPS_BEGIN\n'
         '#define FZ_LAPS_BEGIN unsigned long long fz_g0_ = 0, fz_c0_ = 0, fz_cl_ = 0, '
         'fz_acc_[8] = {0}; if (threadIdx.x == 0) { asm volatile('
         '"mov.u64 %0, %%globaltimer;" : "=l"(fz_g0_)); fz_c0_ = clock64(); fz_cl_ = fz_c0_; }\n'
         '#define FZ_LAP(k) do { if (threadIdx.x == 0) { const unsigned long long c_ = clock64(); '
         'fz_acc_[k] += c_ - fz_cl_; fz_cl_ = c_; } } while (0)\n'
         '#define FZ_LAPS_END(buf, n) do { if (threadIdx.x == 0) { unsigned long long g1_; '
         'asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(g1_)); '
         'const double per_ = (double)(g1_ - fz_g0_) / (double)(clock64() - fz_c0_); '
         'const unsigned b_ = (blockIdx.z * gridDim.y + blockIdx.y) * gridDim.x + blockIdx.x; '
         'if (b_ == 0) buf[0] = (unsigned long long)gridDim.x * gridDim.y * gridDim.z; '
         f'buf[({SLOTS} + b_ * {SLOTS}) & 0xffff] = fz_g0_; unsigned long long run_ = 0; '
         'for (int k_ = 0; k_ < (n); ++k_) { run_ += fz_acc_[k_]; '
         f'buf[({SLOTS} + b_ * {SLOTS} + k_ + 1) & 0xffff] = '
         'fz_g0_ + (unsigned long long)(per_ * (double)run_); } } } while (0)\n'
         '#endif\n')
BUFFER = "static __device__ unsigned long long g_st_{buf}[1 << 16];\n"
READ = ('\nextern "C" int fz_stamps_{buf}(void* dst, int n) {{ return (int)cudaMemcpyFromSymbol('
        'dst, g_st_{buf}, sizeof(unsigned long long) * n); }}\n'
        'extern "C" int fz_stamps_clear_{buf}() {{ unsigned long long z[1] = {{0}}; '
        'return (int)cudaMemcpyToSymbol(g_st_{buf}, z, sizeof(z)); }}\n')
EMPTY = ('#include <cuda_runtime.h>\n__global__ void fz_empty_kernel() {}\n'
         'extern "C" int fz_empty(void* stream) { fz_empty_kernel<<<1, 32, 0, '
         '(cudaStream_t)stream>>>(); return (int)cudaGetLastError(); }\n')

# file -> [(kernel signature anchor, a line only that version of it holds,
#           buffer, where its definition goes,
#           [(anchor, stamp index or a statement, stamp before the anchor?)], step names)]
PLAN = {
    "proj.cuh": [
        # the f32 tile kernel with compensated sums (B6, the init Gram), in laps
        ("proj_kernel(const float* __restrict__ a, const float* __restrict__ bm,",
         "  F2 acc[RM][RN], na[RM], nb[RN];", "tile", "#include <cuda_runtime.h>\n", [
             ("  out += blockIdx.z * out_stride;\n", "FZ_LAPS_BEGIN", False),
             ("    const int kn = min(KC, d - k0);\n", "FZ_LAP(0)", True),
             ("    __syncthreads();  // the next chunk overwrites sa / sb\n", "FZ_LAP(1)", True),
             ("    __syncthreads();  // the next chunk overwrites sa / sb\n", "FZ_LAP(2)", False),
             ("epi(acc[r][c], row, col, na[r], nb[c]);\n    }\n  }\n",
              "FZ_LAP(3); FZ_LAPS_END({buf}, 4)", False),
         ], ["staging", "Dot2 loop", "barrier", "epilogue"]),
        # the f64 tensor-core tile kernel (B6, the init Gram), in laps
        ("proj_tile_kernel(const float* __restrict__ a, const float* __restrict__ bm,",
         "  double part[RW], acc[MI][2][4];", "tile", "#include <cuda_runtime.h>\n", [
             ("  const int nch = (d + kTileK - 1) / kTileK;\n", "FZ_LAPS_BEGIN", False),
             ("    if (s + 1 < nch) issue(s + 1);\n", "FZ_LAP(0)", True),
             ("    if (s + 1 < nch) issue(s + 1);\n", "FZ_LAP(1)", False),
             ("          if (kNorms) part[i] = fma(x, x, part[i]);\n        }\n      }\n    }\n",
              "FZ_LAP(2)", False),
             ("if (c + 1 < nc) o[1] = res[mi][ni][2 * h + 1];\n        }\n      }\n",
              "FZ_LAP(3); FZ_LAPS_END({buf}, 4)", False),
         ], ["wait, barrier", "issue copies", "convert, multiply", "norms, epilogue"]),
        # the earlier rows kernel: B5's sine stage and B9's append events
        ("proj_rows_kernel(const float* __restrict__ a,", "    sa[e] = e < rows * d ? a[e] : 0.f;",
         "rows", "#include <cuda_runtime.h>\n", [
             ("  __shared__ F2 sna[BN];\n", 0, False),
             ("  if (kNorms) {\n    for (int i = warp; i < BN;", 1, True),
             ("  const int col = blockIdx.x * kRowsWarps + warp;\n  if (col >= cols) return;", 2,
              True),
             ("  if (kNorms) nb = warp_sum_f2(nb);", 3, True),
             ("epi(t, i, col, kNorms ? sna[i] : F2{0.f, 0.f}, nb);\n  }\n", 4, False),
         ], ["stage rows", "row norms", "column loop", "sums, store"]),
        # the rows kernel: B9's append events
        ("proj_rows_kernel(const float* __restrict__ a,",
         "  stage_tile(sb, ncol * d, bm, 1, ncol * d, ncol * d);",
         "rows", "#include <cuda_runtime.h>\n", [
             ("  __shared__ F2 sna[BN], snb[kRowsTile];\n", 0, False),
             ("  if (kNorms) {  // the rows' norms while the columns land", 1, True),
             ("  cp_async_wait<0>();\n  __syncthreads();\n  const int c = warp % kRowsTile", 2,
              True),
             ("  const int c = warp % kRowsTile, half = warp / kRowsTile;\n", 3, False),
             ("  if constexpr (RowsShape<BN>::kColWarps > 1) {\n    __syncthreads();", 4, True),
             ("  const int r = pair_index(lane), i = half * kFirst + r;", 5, True),
             ("kNorms ? sna[i] : F2{0.f, 0.f}, nb);\n  }\n", 6, False),
         ], ["issue copies", "row norms", "rows land", "column sums", "pair barrier", "store"]),
    ],
    "rff_grad.cu": [
        # the earlier B5's second kernel, its fixed-order reduction
        ("rff_grad_reduce_kernel(const float* __restrict__ s,", "  __shared__ float buf[kBuf];",
         "reduce", '#include "proj.cuh"\n', [
             ("  __shared__ float buf[kBuf];\n", 0, False),
             ("    if (col < d) {\n#pragma unroll 4", 1, True),
             ("  // threads (r, lane) for r < kGradRows sum", 2, True),
             ("#pragma unroll\n  for (int q = 0; q < kGradRows; ++q) buf[(g * kGradRows + q) * 33"
              " + lane] = acc[q].lo;", 3, True),
             ("    out[(size_t)(row0 + r) * d + col] = neg_scale * __fadd_rn(hi, lo);\n  }\n", 4,
              False),
         ], ["stage S", "group sums", "hi combine", "lo, store"]),
        # B5's one kernel (stamps of the last chunk where M needs several)
        ("rff_grad_kernel(const float* __restrict__ x,", "  const GradSmem at = grad_smem(",
         "grad", '#include "proj.cuh"\n', [
             ("  float* slo = reinterpret_cast<float*>(smem_raw + at.lo);\n", 0, False),
             ("    cp_async_commit();\n    cp_async_wait<0>();", 1, True),
             ("    // 2. S at the chunk's features", 2, True),
             ("    // 3. each group's pairs", 3, True),
             ("    if (last) cluster_wait();  // every block of the cluster has started\n", 4,
              False),
             ("  // 4. the groups' pairs in order", 5, True),
             ("  cluster.sync();  // every block's pairs have arrived\n", 6, False),
             ("    out[c0 + k] = neg_scale * __fadd_rn(hi, lo);\n  }\n", 7, False),
         ], ["issue copies", "copies land", "project", "cluster start", "group sums, push",
             "cluster barrier", "combine"]),
    ],
}


#: The sources whose kernels are stamped, each with its own copy of the
#: headers' buffers.
SOURCES = ("rff_grad.cu", "rff_features.cu", "sqexp.cu")
STEPS: dict[str, list[str]] = {}  # a buffer's step names, as the stamped sources hold them


def stamped(name: str, text: str) -> tuple[str, list[str]]:
    """The source with its known kernels stamped, and the buffers it defines."""
    bufs = []
    for kernel, marker, buf, home, stamps, steps in PLAN.get(name, []):
        if kernel not in text or marker not in text:
            continue
        k0 = text.index(kernel)
        body = text[k0:]
        for anchor, k, before in stamps:
            if anchor not in body:
                raise RuntimeError(f"{name}: step boundary {anchor!r} of {buf} not found")
            mark = (f"  FZ_STAMP(g_st_{buf}, {k});\n" if isinstance(k, int)
                    else f"  {k.format(buf=f'g_st_{buf}')};\n")
            body = body.replace(anchor, mark + anchor if before else anchor + mark, 1)
        text = text[:k0] + body
        text = text.replace(home, home + MACRO + BUFFER.format(buf=buf), 1)
        bufs.append(buf)
        STEPS[buf] = steps
    return text, bufs


def build(csrc: Path):
    """Stamped copies of csrc's headers and of SOURCES, plus the empty
    kernel, as one library; returns (library, buffers by source, the B5
    entry's form)."""
    files = sorted(csrc.glob("*.cuh")) + [csrc / name for name in SOURCES]
    digest = hashlib.sha256(b"".join(f.read_bytes() for f in files)
                            + Path(__file__).read_bytes()).hexdigest()[:12]
    out = OUT / digest
    out.mkdir(parents=True, exist_ok=True)
    header_bufs = []
    for f in files:
        if f.suffix == ".cuh":
            text, bufs = stamped(f.name, f.read_text())
            header_bufs += bufs
            (out / f.name).write_text(text)
    bufs, procs, objs = {}, [], []
    for name in (*SOURCES, "empty.cu"):
        if name == "empty.cu":
            text, own = EMPTY, []
        else:
            text, own = stamped(name, (csrc / name).read_text())
        # a header's buffer is static: each source reads its own copy
        mine = [b for b in header_bufs if name != "empty.cu"] + own
        tag = name[:-3]
        text += "".join(READ.format(buf=b).replace(f"fz_stamps_{b}", f"fz_stamps_{tag}_{b}")
                        .replace(f"fz_stamps_clear_{b}", f"fz_stamps_clear_{tag}_{b}")
                        for b in mine)
        (out / name).write_text(text)
        bufs[name] = mine
        obj = out / (tag + ".o")
        procs.append(subprocess.Popen([loader._nvcc(), *loader.NVCC_FLAGS, "-I", str(out), "-c",
                                       str(out / name), "-o", str(obj)]))
        objs.append(str(obj))
    if any(p.wait() for p in procs):
        raise RuntimeError("nvcc failed for the stamped sources")
    lib = out / "librows_phases.so"
    subprocess.run([loader._nvcc(), *loader.NVCC_FLAGS, "-shared", *objs, "-o", str(lib)],
                   check=True)
    scratch = "float* s, float* out" in (csrc / "rff_grad.cu").read_text()
    return ctypes.CDLL(str(lib)), bufs, scratch


def report(lib, tag: str, buf: str, label: str) -> None:
    steps = STEPS[buf]
    head = np.zeros(1, dtype=np.uint64)
    if getattr(lib, f"fz_stamps_{tag}_{buf}")(head.ctypes.data, 1):
        raise RuntimeError("reading the stamps failed")
    nblk = int(head[0])
    if nblk == 0:
        raise RuntimeError(f"{label}: no block of {buf} stamped")
    raw = np.zeros(SLOTS + nblk * SLOTS, dtype=np.uint64)
    getattr(lib, f"fz_stamps_{tag}_{buf}")(raw.ctypes.data, raw.size)
    t = raw[SLOTS:].reshape(nblk, SLOTS)[:, :len(steps) + 1].astype(np.int64)
    t -= t[:, 0].min()
    d = np.diff(t, axis=1) / 1e3
    starts = np.sort(t[:, 0]) / 1e3
    print(f"{label} [{buf}]: {nblk} blocks, span {t.max() / 1e3:.2f} us, blocks started between "
          f"0 and {starts[-1]:.2f} us (median {np.median(starts):.2f})", flush=True)
    for s, name in enumerate(steps):
        print(f"  {name:>14}: mean {d[:, s].mean():.2f} us, max {d[:, s].max():.2f} us",
              flush=True)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--csrc", type=Path, default=loader.CSRC,
                    help="kernel sources to stamp (default: this tree's)")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("rows_phases: no CUDA device available", file=sys.stderr)
        return 1
    lib, bufs, scratch = build(args.csrc.resolve())
    dev = torch.device("cuda")
    p = chip_smoke.path_inputs(dev)
    x_it, v, b, ws, xs, rows_all, k_new, k_one = chip_smoke.rff_and_gram_inputs(dev, p)
    n, d, m = x_it.shape[0], chip_smoke.D, chip_smoke.M
    cap, nb = chip_smoke.CAP, chip_smoke.N_CLIENTS
    stream = lambda: ctypes.c_void_p(torch.cuda.current_stream().cuda_stream)
    g = torch.empty((n, d), device=dev)
    s = torch.empty((n, m), device=dev)
    P = ctypes.c_void_p
    if scratch:
        rff = lambda: lib.fz_rff_grad(P(x_it.data_ptr()), P(v.data_ptr()), P(b.data_ptr()),
                                      P(ws.data_ptr()), P(s.data_ptr()), P(g.data_ptr()), n, m,
                                      d, m, ctypes.c_float(math.sqrt(2 / m)), stream())
    else:
        rff = lambda: lib.fz_rff_grad(P(x_it.data_ptr()), P(v.data_ptr()), P(b.data_ptr()),
                                      P(ws.data_ptr()), P(g.data_ptr()), n, m, d, m,
                                      ctypes.c_float(math.sqrt(2 / m)), stream())
    kout = torch.empty((nb, cap, cap), device=dev)
    phi = torch.empty((nb * cap, m), device=dev)

    def gram(rows):
        return lambda: lib.fz_sqexp(P(rows.data_ptr()), P(xs.data_ptr()), P(kout.data_ptr()), nb,
                                    rows.shape[1], cap, d, ctypes.c_float(0.5 / p["ls"] ** 2),
                                    stream())

    feats = lambda: lib.fz_rff_features(P(rows_all.data_ptr()), P(v.data_ptr()), P(b.data_ptr()),
                                        P(phi.data_ptr()), nb * cap, m, d,
                                        ctypes.c_float(math.sqrt(2 / m)), stream())

    for label, fn, src in (
        (f"B5 rff_grad (n={n}, M={m}, d={d}, per-row w)", rff, "rff_grad.cu"),
        (f"B9 sqexp append event, 5 rows ({nb}, 5, {d}) x ({nb}, {cap}, {d})", gram(k_new),
         "sqexp.cu"),
        (f"B9 sqexp append event, 1 row ({nb}, 1, {d}) x ({nb}, {cap}, {d})", gram(k_one),
         "sqexp.cu"),
        (f"B6 rff_features ({nb * cap}, {d}) x ({m}, {d})", feats, "rff_features.cu"),
        (f"B9 sqexp init Gram ({nb}, {cap}, {d}) x ({nb}, {cap}, {d})", gram(xs), "sqexp.cu"),
    ):
        tag = src[:-3]
        for _ in range(5):  # warm; the last launch's stamps are read
            for buf in bufs[src]:
                getattr(lib, f"fz_stamps_clear_{tag}_{buf}")()
            if fn():
                raise RuntimeError(f"{label}: launch failed")
        torch.cuda.synchronize()
        for buf in bufs[src]:
            head = np.zeros(1, dtype=np.uint64)
            getattr(lib, f"fz_stamps_{tag}_{buf}")(head.ctypes.data, 1)
            if head[0]:  # this call launched the kernel
                report(lib, tag, buf, label)
    empty = lambda: lib.fz_empty(stream())
    print(f"empty kernel (1 block of 32 threads): device time "
          f"{1e3 * chip_smoke.device_ms(empty, reps=200):.3f} us per launch (profiler), "
          f"{1e3 * chip_smoke.cuda_ms(empty, reps=1000):.3f} us per launch (events, back to back)",
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
