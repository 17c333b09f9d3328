#!/usr/bin/env python3
"""Where the time of the client-batched cluster kernels (B1, B3) goes.

    python3 scripts/cluster_phases.py      # on a machine with one CUDA card

Writes copies of ``csrc/gp_score.cu`` and ``csrc/gp_grad.cu`` into
``build/cluster_phases/`` with a ``%globaltimer`` stamp taken by thread 0 of
every block at each step boundary of ``score_cluster_kernel`` and
``grad_cluster_kernel``, builds them into their own library, launches each
kernel at the main path's shapes (``chip_smoke.path_inputs``: N=5, n=50
padded to 56, cap=192, d=300; one query point per client for B3) and
prints, per kernel: the span of the launch, when the blocks started (one
wave or more), and each step's mean and max duration over the blocks.  The
stamps cost a few instructions per step; the kernels' own library is not
touched.  Raises if a step boundary is no longer where the stamps go.
"""

from __future__ import annotations

import ctypes
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
# one stamp buffer, and its reader fz_stamps_<tag>, per source
STAMP = ('__device__ unsigned long long g_stamps_{tag}[1 << 16];\n'
         '#define STAMP(k) do {{ if (threadIdx.x == 0) {{ unsigned long long t_; '
         'asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t_)); '
         'g_stamps_{tag}[((blockIdx.y * gridDim.x + blockIdx.x) * 8 + (k)) & 0xffff] = t_; }} }} '
         'while (0)\n')
READ = ('\nextern "C" int fz_stamps_{tag}(void* dst, int n) {{ return (int)cudaMemcpyFromSymbol('
        'dst, g_stamps_{tag}, sizeof(unsigned long long) * n); }}\n')
# (source, kernel, [(anchor, stamp index, stamp before the anchor?)], step names)
PLAN = {
    "gp_score.cu": ("score_cluster_kernel(const float*", [
        ("ldx = rows_ld(d);\n", 0, False), ("  cp_async_wait<kStages>();\n  __syncthreads();\n", 1, False),
        ("  cluster_wait();", 2, True), ("  cluster.sync();  // every block's part of h", 3, True),
        ("  // step 5:", 4, True), ("  double* gs = ", 5, True),
        ("  cluster.sync();  // every rank's partial is in", 6, True),
        ("  if (rank == 0 && (int)threadIdx.x < BN) {", 7, True),
    ], ["staging", "h rows", "push h", "barrier", "column sums", "epilogue", "barrier"]),
    "gp_grad.cu": ("grad_cluster_kernel(const float*", [
        ("  float* sx = sm.sx;\n", 0, False), ("  cp_async_wait<0>();\n  __syncthreads();\n", 1, False),
        ("  for (int k = threadIdx.x; k < d; k += blockDim.x) {\n    double acc[BN]", 2, True),
        ("  cluster.sync();  // every rank's partials are written\n", 3, True),
        ("  const int k0 = split_at(d, cs, rank)", 4, True),
        ("  cluster.sync();  // the other ranks have read", 5, True),
    ], ["staging", "w rows", "partial sums", "barrier", "rank sums"]),
}


def build() -> ctypes.CDLL:
    OUT.mkdir(parents=True, exist_ok=True)
    nvcc = [loader._nvcc(), *loader.NVCC_FLAGS, "-I", str(loader.CSRC)]
    objs = []
    for name, (kernel, stamps, _) in PLAN.items():
        tag = name[3:-3]  # score, grad
        src = (loader.CSRC / name).read_text().replace(
            '#include "common.cuh"\n', '#include "common.cuh"\n' + STAMP.format(tag=tag), 1)
        k0 = src.index(kernel)
        body = src[k0:]
        for anchor, k, before in stamps:
            if anchor not in body:
                raise RuntimeError(f"{name}: step boundary {anchor!r} not found")
            mark = f"  STAMP({k});\n"
            body = body.replace(anchor, mark + anchor if before else anchor + mark, 1)
        src = src[:k0] + body + READ.format(tag=tag)
        (OUT / name).write_text(src)
        obj = OUT / (name[:-3] + ".o")
        subprocess.run(nvcc + ["-c", str(OUT / name), "-o", str(obj)], check=True)
        objs.append(str(obj))
    lib = OUT / "libphases.so"
    subprocess.run(nvcc + ["-shared", *objs, "-o", str(lib)], check=True)
    out = ctypes.CDLL(str(lib))
    for fn in ("fz_score_resident", "fz_grad_resident"):
        getattr(out, fn).argtypes = list(loader.SIGNATURES[fn])
        getattr(out, fn).restype = ctypes.c_int
    return out


def report(read, label, nblk, steps) -> None:
    buf = np.zeros(nblk * 8, dtype=np.uint64)
    if read(buf.ctypes.data, nblk * 8):
        raise RuntimeError("reading the stamps failed")
    t = buf.reshape(nblk, 8)[:, :len(steps) + 1].astype(np.int64)
    t -= t[:, 0].min()
    d = np.diff(t, axis=1) / 1e3
    starts = np.sort(t[:, 0]) / 1e3
    print(f"{label}: {nblk} blocks, span {t.max() / 1e3:.2f} us, blocks started between 0 and "
          f"{starts[-1]:.2f} us (median {np.median(starts):.2f})", flush=True)
    for s, name in enumerate(steps):
        print(f"  {name:>12}: mean {d[:, s].mean():.2f} us, max {d[:, s].max():.2f} us",
              flush=True)


def main() -> int:
    if not torch.cuda.is_available():
        print("cluster_phases: no CUDA device available", file=sys.stderr)
        return 1
    lib = build()
    dev = torch.device("cuda")
    p = chip_smoke.path_inputs(dev)
    n, cap, d, nb = chip_smoke.CANDS, chip_smoke.CAP, chip_smoke.D, chip_smoke.N_CLIENTS
    l2, stream = p["ls"] ** 2, torch.cuda.current_stream().cuda_stream
    bn, _ = autotune.select_blocks("score_clients", n=n, cap=cap, d=d)
    cs, jc = autotune.cluster_geometry(cap)
    npad = -(-n // bn) * bn
    cands = ops._pad_axis(p["cands"], 1, npad).contiguous()
    scores = torch.empty((nb, npad), device=dev)
    grads = torch.empty((nb, 1, d), device=dev)
    score = lambda: lib.fz_score_resident(
        cands.data_ptr(), p["xs_sh"].data_ptr(), p["binv"].data_ptr(), p["pmat"].data_ptr(),
        scores.data_ptr(), nb, npad, cap, d, bn, cs, jc, 0.5 / l2, 1 / l2**2, p["prior"], stream)
    grad = lambda: lib.fz_grad_resident(
        p["query"].data_ptr(), p["xs"].data_ptr(), p["alpha"].data_ptr(), grads.data_ptr(), nb,
        1, cap, d, 1, cs, 0.5 / l2, 1 / l2, stream)
    for label, fn, nblk, src in (
        (f"score_cluster_kernel<{bn}> (cluster {cs}, chunks of {jc} rows)", score,
         nb * cs * npad // bn, "gp_score.cu"),
        (f"grad_cluster_kernel<1> (cluster {cs})", grad, nb * cs, "gp_grad.cu"),
    ):
        for _ in range(5):  # warm; the last launch's stamps are read
            loader.check(fn(), label)
        torch.cuda.synchronize()
        report(getattr(lib, "fz_stamps_" + src[3:-3]), label, nblk, PLAN[src][2])
    return 0


if __name__ == "__main__":
    sys.exit(main())
