#!/usr/bin/env python3
"""The RFF gradient (B5) and the SE Gram (B9) of this tree against another
tree's, bit for bit and in device time, on one card.

    python3 scripts/kernel_bits.py --parent DIR   # on a machine with one CUDA card

``DIR`` is the root of the other tree (for example a ``git archive`` of the
parent commit unpacked under ``build/``).  Its kernel library is built by
its own ``kernels/loader.py`` (loaded from its file, so the two trees'
modules do not mix) and its ``fz_rff_grad`` and ``fz_sqexp`` are called
through ctypes as its wrappers call them, with the scratch of an RFF
gradient entry that takes one.  This tree's kernels run through
``kernels.ops``.  The same inputs go to both:

* the main path's shapes (``chip_smoke.rff_and_gram_inputs``): B5 with
  per-row w and with one w, B9's append events of 5 rows and of 1 row,
  and factor_init's init Gram (the tile route, unchanged);
* every B5 and B9 call of one main-path round (d=300, N=5, M=512,
  cap=192), and of the small deferred and per-client engines of
  ``chip_smoke.check_engine_inputs`` (d=8, N=3, cap=16, 3 rounds), as this
  tree's kernels received them.

For each group it prints the calls, the calls whose outputs differ in any
bit, the most differing elements of one call and the largest |difference|;
then the profiler's device time per call of B5 and of the two append
events, the other tree's and this tree's in turns (other, this, this,
other), with the card's name and power limit.  Exits 1 if any output
differs.
"""

from __future__ import annotations

import argparse
import importlib.util
import math
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "src"))

import chip_smoke  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402

NAMES = ("rff_grad_rows", "sqexp")


def other_tree(root: Path):
    """The other tree's kernel library and its entries, as its wrappers
    call them: (rff_grad_rows(x, v, b, ws), rff_grad(x, v, b, w),
    sqexp(x1, x2, lengthscale))."""
    path = root / "src" / "repro_torch" / "kernels" / "loader.py"
    spec = importlib.util.spec_from_file_location("other_tree_loader", path)
    loader = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(loader)
    lib = loader.library()
    scratch = len(loader.SIGNATURES["fz_rff_grad"]) == 12  # (n, M) scratch S before out

    def grad(x, v, b, w, w_stride):
        x, v, b, w = (t.contiguous() for t in (x, v, b, w))
        (n, d), m = x.shape, v.shape[0]
        out = torch.empty((n, d), device=x.device)
        ptrs = [x.data_ptr(), v.data_ptr(), b.data_ptr(), w.data_ptr()]
        if scratch:
            s = torch.empty((n, m), device=x.device)
            ptrs.append(s.data_ptr())
        err = lib.fz_rff_grad(*ptrs, out.data_ptr(), n, m, d, w_stride, math.sqrt(2.0 / m),
                              torch.cuda.current_stream().cuda_stream)
        loader.check(err, "other tree's rff_grad")
        return out

    def sqexp(x1, x2, lengthscale):
        two_d = x1.dim() == 2
        x1, x2 = (t[None] if two_d else t for t in (x1, x2))
        x1, x2 = x1.contiguous(), x2.contiguous()
        (nb, a, d), c = x1.shape, x2.shape[1]
        out = torch.empty((nb, a, c), device=x1.device)
        err = lib.fz_sqexp(x1.data_ptr(), x2.data_ptr(), out.data_ptr(), nb, a, c, d,
                           0.5 / float(lengthscale) ** 2,
                           torch.cuda.current_stream().cuda_stream)
        loader.check(err, "other tree's sqexp")
        return out[0] if two_d else out

    return (lambda x, v, b, ws: grad(x, v, b, ws, v.shape[0]),
            lambda x, v, b, w: grad(x, v, b, w, 0), sqexp)


def differ(a: torch.Tensor, b: torch.Tensor) -> tuple[int, float]:
    """Elements whose bits differ, and the largest |a - b|."""
    if a.shape != b.shape:
        raise ValueError(f"shapes differ: {tuple(a.shape)} and {tuple(b.shape)}")
    n = int((a.view(torch.int32) != b.view(torch.int32)).sum().item())
    return n, (a.double() - b.double()).abs().max().item() if a.numel() else 0.0


def compare(label: str, pairs) -> bool:
    """pairs: [(this tree's output, the other tree's output)]; prints one line."""
    counts = [differ(a, b) for a, b in pairs]
    bad = sum(n > 0 for n, _ in counts)
    most = max((n for n, _ in counts), default=0)
    size = max((a.numel() for a, _ in pairs), default=0)
    big = max((d for _, d in counts), default=0.0)
    print(f"[bits] {label}: {len(pairs)} calls, {bad} with differing bits (most {most} of "
          f"{size} elements), max|this - other| = {big:.3e}", flush=True)
    return bad == 0


def engine_calls(dev):
    """B5 and B9 calls of one main-path round and of both small engines,
    with this tree's outputs: {label: {name: [(args, kwargs, out)]}}."""
    from repro_torch.core import algorithms as alg
    from repro_torch.core import objectives as obj

    cfg = chip_smoke.main_config()
    cobjs = obj.make_quadratic(0, chip_smoke.N_CLIENTS, chip_smoke.D, 5.0, 0.001, device=dev)
    with chip_smoke.recording(NAMES) as main:
        alg.simulate(cfg, 1, cobjs, obj.quadratic_query, obj.quadratic_global_value, 1,
                     device=dev)
    return {
        "main path, one round": main,
        "small deferred engine": chip_smoke.check_engine_inputs(dev, "small engine inputs"),
        "small per-client engine": chip_smoke.check_engine_inputs(
            dev, "small per-client engine inputs", defer_repair=False),
    }


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--parent", type=Path, required=True, help="root of the other tree")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("kernel_bits: no CUDA device available", file=sys.stderr)
        return 1
    dev = torch.device("cuda")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    print(smi, flush=True)
    o_rows, o_one, o_sqexp = other_tree(args.parent.resolve())
    p = chip_smoke.path_inputs(dev)
    x_it, v, b, ws, xs, _, k_new, k_one = chip_smoke.rff_and_gram_inputs(dev, p)
    ls = p["ls"]
    same = True
    for label, this, other in (
        ("B5, per-row w (5, 300), M=512", lambda: ops.rff_grad_rows(x_it, v, b, ws),
         lambda: o_rows(x_it, v, b, ws)),
        ("B5, one w (5, 300), M=512", lambda: ops.rff_grad(x_it, v, b, ws[0]),
         lambda: o_one(x_it, v, b, ws[0])),
        ("B9, append event of 5 rows (5, 5, 192)", lambda: ops.sqexp(k_new, xs, ls),
         lambda: o_sqexp(k_new, xs, ls)),
        ("B9, append event of 1 row (5, 1, 192)", lambda: ops.sqexp(k_one, xs, ls),
         lambda: o_sqexp(k_one, xs, ls)),
        ("B9, init Gram (5, 192, 192)", lambda: ops.sqexp(xs, xs, ls),
         lambda: o_sqexp(xs, xs, ls)),
    ):
        same &= compare(label, [(this(), other())])
    other_ops = {"rff_grad_rows": o_rows, "sqexp": o_sqexp}
    for label, calls in engine_calls(dev).items():
        for name in NAMES:
            same &= compare(f"{label}: {name}",
                            [(out, other_ops[name](*a, **kw)) for a, kw, out in calls[name]])
    print(f"[bits] every output bit-identical: {same}", flush=True)

    for label, this, other in (
        ("B5 (5, 300), per-row w, M=512", lambda: ops.rff_grad_rows(x_it, v, b, ws),
         lambda: o_rows(x_it, v, b, ws)),
        ("B9 append event, 5 rows", lambda: ops.sqexp(k_new, xs, ls),
         lambda: o_sqexp(k_new, xs, ls)),
        ("B9 append event, 1 row", lambda: ops.sqexp(k_one, xs, ls),
         lambda: o_sqexp(k_one, xs, ls)),
    ):
        t = [chip_smoke.device_ms(f, reps=200) for f in (other, this, this, other)]
        e = [chip_smoke.cuda_ms(f, reps=200) for f in (other, this, this, other)]
        print(f"[time] {label}: device us per call (profiler) other {1e3 * t[0]:.3f}, this "
              f"{1e3 * t[1]:.3f}, this {1e3 * t[2]:.3f}, other {1e3 * t[3]:.3f}; event us per "
              f"call other {1e3 * e[0]:.3f}, this {1e3 * e[1]:.3f}, this {1e3 * e[2]:.3f}, other "
              f"{1e3 * e[3]:.3f}", flush=True)
    print(smi, flush=True)
    return 0 if same else 1


if __name__ == "__main__":
    sys.exit(main())
