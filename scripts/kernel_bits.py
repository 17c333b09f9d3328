#!/usr/bin/env python3
"""The kernels of this tree against another tree's, bit for bit, by the
active-query picks they lead to, and in device time, on one card.

    python3 scripts/kernel_bits.py --parent DIR   # on a machine with one CUDA card

``DIR`` is the root of the other tree (for example a ``git archive`` of the
parent commit unpacked under ``build/``).  Its kernel library is built by
its own ``kernels/loader.py`` and its block choices come from its own
``kernels/autotune.py`` (both loaded from their files, so the two trees'
modules do not mix); its ``fz_rff_grad``, ``fz_rff_features``,
``fz_sqexp``, scoring and gradient-mean entries are called through ctypes
as its wrappers call them (padding, geometry, scratch or work buffers as
its signatures take them).  This tree's kernels run through
``kernels.ops``.  The same inputs go to both:

* the main path's shapes (``chip_smoke.rff_and_gram_inputs``,
  ``chip_smoke.path_inputs``): B5 with per-row w and with one w, B9's
  append events of 5 rows and of 1 row, the client-batched resident
  scoring (B1) and gradient mean (B3);
* every B5, B9, B1 and B3 call of one main-path round (d=300, N=5, M=512,
  cap=192), and of the small deferred and per-client engines of
  ``chip_smoke.check_engine_inputs`` (d=8, N=3, cap=16, 3 rounds; also
  with the gradient's cap tiles pinned to 8), as this tree's kernels
  received them.

For each group it prints the calls, the calls whose outputs differ in any
bit, the most differing elements of one call and the largest |difference|.
The projection's tile kernel may differ by design: B6 and the SE Gram's
tile route (factor_init's init Gram) at each size of
``chip_smoke.PROJ_ACCURACY``, and every B6 call and every SE Gram call of
more than 16 rows of the engines above, are compared element for element
and each side held against float64 (the plain version on float64 copies
of the inputs); this tree must be no further off than the other.
The single-client scoring (B7a, and B7b on the per-client engine with cap
tiles of 8) may differ by design: for each of its calls on the small
per-client engines it compares the active-query picks (the top 2 by a
stable descending sort, as the engine takes them) index for index and
prints, for any call whose picks differ, the candidates, both trees'
scores and their float64 truth.  So may the single-client gradient mean
(B8a, and B8b and B4 with gradient cap tiles of 8), whose largest
difference is printed.  Then the profiler's device time per call of B5,
the two append events, B1, B7a, B7b and B2 with cap tiles of 64, B3, B8a,
and B8b and B4 with cap tiles of 64, the other tree's and this tree's in
turns (other, this, this, other), with the card's name and power limit.
Exits 1 if any output of B5, B9's rows route, B1 or B3 differs, or if
this tree's tile kernel is further from float64 than the other's.
"""

from __future__ import annotations

import argparse
import ctypes
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
from repro_torch.kernels import ops, ref  # noqa: E402

NAMES = ("rff_grad_rows", "sqexp", "uncertainty_scores_clients", "grad_mean_clients",
         "uncertainty_scores", "grad_mean_batch", "rff_features")
#: The ops whose every output must keep the other tree's bits.
BITWISE = NAMES[:4]
#: Active queries the small engines pick per call (active_per_iter, active_round_end).
PICKS = 2


def _module(path: Path, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def other_tree(root: Path):
    """The other tree's kernel library and its entries, as its wrappers
    call them: (rff_grad_rows(x, v, b, ws), rff_grad(x, v, b, w),
    sqexp(x1, x2, lengthscale), scores(cands, xs, binv, pmat, lengthscale=,
    prior=, block_n=, block_cap=), grads(cands, xs, alpha, lengthscale=,
    block_n=, block_cap=) for one client's (n, d) or client-batched (N, n,
    d) candidates, and rff_features(x, v, b) for rows (..., n, d))."""
    kernels = root / "src" / "repro_torch" / "kernels"
    loader = _module(kernels / "loader.py", "other_tree_loader")
    tune = _module(kernels / "autotune.py", "other_tree_autotune")
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

    def scores(cands, xs, binv, pmat, *, lengthscale, prior, block_n=None, block_cap=None):
        single = cands.dim() == 2
        c, x, b, p = (t[None] if single else t for t in (cands, xs, binv, pmat))
        (nb, n, d), cap = c.shape, x.shape[1]
        kind = "score" if single else "score_clients"
        bn, bc = tune.select_blocks(kind, n=n, cap=cap, d=d)
        bn, bc = block_n or bn, block_cap or bc
        npad = -(-n // bn) * bn
        c = ops._pad_axis(c, 1, npad).contiguous()
        out = torch.empty((nb, npad), device=c.device)
        name = "fz_score_" + ("single_" if single else "") + ("resident" if bc >= cap else "tiled")
        sig = loader.SIGNATURES[name]
        work = []
        if bc >= cap:  # the cluster geometry where the entry takes it
            geo = ()
            if not single:
                geo = tune.cluster_geometry(cap)
            elif len(sig) == 15:
                geo = tune.cluster_geometry(cap, single=True)
            tail = [cap, d, bn, *geo]
        elif sig[5] is ctypes.c_void_p:  # a work buffer
            work = [torch.empty(tune.score_tiled_work(nb, npad, cap, bc), dtype=torch.float64,
                                device=c.device)]
            tail = [cap, d, bn, bc]
        else:  # the earlier tiled entries: the trajectory padded to a tile multiple
            cpad = -(-cap // bc) * bc
            x, b, p = ops._pad_axis(x, 1, cpad), ops._pad_gram(b, cpad), ops._pad_gram(p, cpad)
            tail = [cpad, d, bn, bc]
        x, b, p = x.contiguous(), b.contiguous(), p.contiguous()
        l2 = float(lengthscale) ** 2
        err = getattr(lib, name)(
            c.data_ptr(), x.data_ptr(), b.data_ptr(), p.data_ptr(), out.data_ptr(),
            *(w.data_ptr() for w in work), *([npad] if single else [nb, npad]), *tail,
            0.5 / l2, 1 / l2**2, float(prior), torch.cuda.current_stream().cuda_stream)
        loader.check(err, "other tree's " + name)
        return out[0, :n] if single else out[:, :n]

    def grads(cands, xs, alpha, *, lengthscale, block_n=None, block_cap=None):
        single = cands.dim() == 2
        c, x, a = (t[None] if single else t for t in (cands, xs, alpha))
        (nb, n, d), cap = c.shape, x.shape[1]
        bn, bc = tune.select_blocks("grad" if single else "grad_clients", n=n, cap=cap, d=d)
        bn, bc = block_n or bn, block_cap or bc
        npad = -(-n // bn) * bn
        c = ops._pad_axis(c, 1, npad).contiguous()
        out = torch.empty((nb, npad, d), device=c.device)
        resident = bc >= cap
        name = "fz_grad_" + ("single_" if single else "") + ("resident" if resident else "tiled")
        if hasattr(tune, "grad_geometry"):  # one cluster kernel for every route
            geo = tune.grad_geometry(cap, d, bn, None if resident else bc, single=single)
            geo = geo[:1] if resident else geo
        elif resident:  # the earlier single-client entry took no cluster size
            geo = () if single else tune.cluster_geometry(cap)[:1]
        else:  # the earlier tiled entries: the trajectory zero-padded to a tile multiple
            cpad = -(-cap // bc) * bc
            x, a = ops._pad_axis(x, 1, cpad), ops._pad_axis(a, 1, cpad)
            cap, geo = cpad, (bc,)
        x, a = x.contiguous(), a.contiguous()
        l2 = float(lengthscale) ** 2
        err = getattr(lib, name)(
            c.data_ptr(), x.data_ptr(), a.data_ptr(), out.data_ptr(),
            *([npad] if single else [nb, npad]), cap, d, bn, *geo, 0.5 / l2, 1 / l2,
            torch.cuda.current_stream().cuda_stream)
        loader.check(err, "other tree's " + name)
        return out[0, :n] if single else out[:, :n]

    def features(x, v, b):
        lead, d = x.shape[:-1], x.shape[-1]
        x, v, b = x.reshape(-1, d).contiguous(), v.contiguous(), b.contiguous()
        n, m = x.shape[0], v.shape[0]
        out = torch.empty((n, m), device=x.device)
        err = lib.fz_rff_features(x.data_ptr(), v.data_ptr(), b.data_ptr(), out.data_ptr(), n, m,
                                  d, math.sqrt(2.0 / m), torch.cuda.current_stream().cuda_stream)
        loader.check(err, "other tree's rff_features")
        return out.reshape(*lead, m)

    return (lambda x, v, b, ws: grad(x, v, b, ws, v.shape[0]),
            lambda x, v, b, w: grad(x, v, b, w, 0), sqexp, scores, grads, features)


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


def against_f64(label: str, pairs, truths) -> bool:
    """pairs: [(this tree's output, the other tree's)] with their float64
    truths; prints the differing elements, the largest |difference| and each
    side's max |out - f64|; True where this tree is no further off."""
    n = sum(differ(a, b)[0] for a, b in pairs)
    size = sum(a.numel() for a, _ in pairs)
    big = max(differ(a, b)[1] for a, b in pairs)
    this = max((a.double() - t).abs().max().item() for (a, _), t in zip(pairs, truths))
    other = max((b.double() - t).abs().max().item() for (_, b), t in zip(pairs, truths))
    ok = this <= other
    print(f"[bits] {label}: {len(pairs)} calls, {n} of {size} elements differ, max|this - other| = "
          f"{big:.3e}; max|out-f64| this {this:.4e}, other {other:.4e}; "
          f"{'ok' if ok else 'THIS TREE FURTHER OFF'}", flush=True)
    return ok


def f64_call(name: str, args):
    """The plain version of a recorded B6 or SE Gram call on float64 copies
    of its inputs."""
    if name == "rff_features":
        x, v, b = (t.double() for t in args)
        return ref.rff_features(x.reshape(-1, x.shape[-1]), v, b).reshape(*x.shape[:-1],
                                                                           v.shape[0])
    return ref.sqexp(args[0].double(), args[1].double(), args[2])


def engine_calls(dev):
    """B5, B9, scoring and gradient-mean calls of one main-path round and of
    the small engines, with this tree's outputs: {label: {name: [(args,
    kwargs, out)]}}."""
    from repro_torch.core import algorithms as alg
    from repro_torch.core import objectives as obj

    cfg = chip_smoke.main_config()
    cobjs = obj.make_quadratic(0, chip_smoke.N_CLIENTS, chip_smoke.D, 5.0, 0.001, device=dev)
    with chip_smoke.recording(NAMES) as main:
        alg.simulate(cfg, 1, cobjs, obj.quadratic_query, obj.quadratic_global_value, 1,
                     chunk=0, device=dev)
    return {
        "main path, one round": main,
        "small deferred engine": chip_smoke.check_engine_inputs(dev, "small engine inputs"),
        "small per-client engine": chip_smoke.check_engine_inputs(
            dev, "small per-client engine inputs", defer_repair=False),
        "small per-client engine, cap tiles of 8": chip_smoke.check_engine_inputs(
            dev, "small per-client engine inputs, cap tiles of 8", defer_repair=False,
            score_block_cap=8),
        "small deferred engine, gradient cap tiles of 8": chip_smoke.check_engine_inputs(
            dev, "small engine inputs, gradient cap tiles of 8", grad_block_cap=8),
        "small per-client engine, gradient cap tiles of 8": chip_smoke.check_engine_inputs(
            dev, "small per-client engine inputs, gradient cap tiles of 8", defer_repair=False,
            grad_block_cap=8),
    }


def top(scores: torch.Tensor) -> list[int]:
    """The engine's picks: the PICKS highest scores, ties to the lower index."""
    return torch.sort(scores, descending=True, stable=True).indices[:PICKS].tolist()


def compare_picks(label: str, calls, other_scores) -> None:
    """The single-client scoring's picks, this tree's against the other's,
    on each recorded call; prints every call whose picks differ."""
    differ_calls, big = 0, 0.0
    for k, (args, kwargs, out) in enumerate(calls):
        theirs = other_scores(*args, **kwargs)
        big = max(big, (out.double() - theirs.double()).abs().max().item())
        if top(out) != top(theirs):
            differ_calls += 1
            truth = ref.uncertainty_scores(*(a.double() for a in args), kwargs["lengthscale"],
                                           kwargs["prior"])
            for i in sorted(set(top(out)) | set(top(theirs))):
                print(f"[picks] {label}: call {k}: candidate {i}: this {out[i].item():.9g}, other "
                      f"{theirs[i].item():.9g}, float64 {truth[i].item():.12g}; picks this "
                      f"{top(out)}, other {top(theirs)}", flush=True)
    print(f"[picks] {label}: {len(calls)} calls, {differ_calls} whose top-{PICKS} picks differ; "
          f"max|this - other| = {big:.3e}", flush=True)


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
    o_rows, o_one, o_sqexp, o_scores, o_grads, o_features = other_tree(args.parent.resolve())
    p = chip_smoke.path_inputs(dev)
    x_it, v, b, ws, xs, _, k_new, k_one = chip_smoke.rff_and_gram_inputs(dev, p)
    ls = p["ls"]
    skw = dict(lengthscale=ls, prior=p["prior"])
    sargs = (p["cands"], p["xs_sh"], p["binv"], p["pmat"])
    one = tuple(a[0] for a in sargs)
    gargs = (p["query"], p["xs"], p["alpha"])
    gone = tuple(a[0] for a in gargs)
    gkw, tile = dict(lengthscale=ls), chip_smoke.TILE
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
        ("B1, scores (5, 50) at cap=192, d=300", lambda: ops.uncertainty_scores_clients(
            *sargs, **skw), lambda: o_scores(*sargs, **skw)),
        ("B3, gradient means (5, 1, 300) at cap=192", lambda: ops.grad_mean_clients(
            *gargs, **gkw), lambda: o_grads(*gargs, **gkw)),
    ):
        same &= compare(label, [(this(), other())])
    others = {"rff_features": o_features, "sqexp": lambda *a: o_sqexp(*a, 0.5)}
    proj_times = []
    for op, nb, rows, cols, d in chip_smoke.PROJ_ACCURACY:
        pargs = chip_smoke.projection_inputs(dev, op, nb, rows, cols, d)
        (this_fn, plain_fn), other_fn = chip_smoke.projection_ops()[op], others[op]
        label = (f"B9 tile route, ({nb}, {rows}, {cols}) at d={d}" if op == "sqexp"
                 else f"B6, {rows} rows, M={cols}, d={d}")
        truth = plain_fn(*(a.double() for a in pargs))
        same &= against_f64(f"{label} (may differ)", [(this_fn(*pargs), other_fn(*pargs))],
                            [truth])
        proj_times.append((label, lambda f=this_fn, a=pargs: f(*a),
                           lambda f=other_fn, a=pargs: f(*a)))
    compare("B7a, one client's scores (50,) at cap=192, d=300 (may differ)",
            [(ops.uncertainty_scores(*one, **skw), o_scores(*one, **skw))])
    for label, kw in (("B8a", {}), (f"B8b, cap tiles of {tile},", dict(block_cap=tile))):
        compare(f"{label} one client's gradient mean (1, 300) at cap=192 (may differ)",
                [(ops.grad_mean_batch(*gone, **gkw, **kw), o_grads(*gone, **gkw, **kw))])
    compare(f"B4, gradient means (5, 1, 300), cap tiles of {tile} (may differ)",
            [(ops.grad_mean_clients(*gargs, **gkw, block_cap=tile),
              o_grads(*gargs, **gkw, block_cap=tile))])
    other_ops = {"rff_grad_rows": o_rows, "sqexp": o_sqexp, "uncertainty_scores_clients": o_scores,
                 "grad_mean_clients": o_grads, "grad_mean_batch": o_grads}
    for label, calls in engine_calls(dev).items():
        # the tile kernel's calls: B6, and SE Grams of more than 16 rows
        tiled = [(a, kw, out) for a, kw, out in calls["sqexp"] if a[0].shape[-2] > 16]
        calls["sqexp"] = [c for c in calls["sqexp"] if c[0][0].shape[-2] <= 16]
        for name, recs, other_fn in (("rff_features", calls["rff_features"], o_features),
                                     ("sqexp, tile route", tiled, o_sqexp)):
            if recs:
                same &= against_f64(f"{label}: {name} (may differ)",
                                    [(out, other_fn(*a)) for a, _, out in recs],
                                    [f64_call(name, a) for a, _, _ in recs])
        for name in BITWISE:
            recs = calls[name]
            if not recs:
                continue
            pairs = [(out, other_ops[name](*a, **kw)) for a, kw, out in recs]
            if name == "grad_mean_clients" and recs[0][1].get("block_cap"):
                compare(f"{label}: {name} (B4, may differ)", pairs)
            else:
                same &= compare(f"{label}: {name}", pairs)
        if calls["uncertainty_scores"]:
            compare_picks(f"{label}: uncertainty_scores", calls["uncertainty_scores"], o_scores)
        if calls["grad_mean_batch"]:
            compare(f"{label}: grad_mean_batch (may differ)",
                    [(out, o_grads(*a, **kw)) for a, kw, out in calls["grad_mean_batch"]])
    print(f"[bits] every output of B5, B9's rows route, B1 and B3 bit-identical, and the tile "
          f"kernel no further from float64: {same}", flush=True)

    for label, this, other in (
        ("B5 (5, 300), per-row w, M=512", lambda: ops.rff_grad_rows(x_it, v, b, ws),
         lambda: o_rows(x_it, v, b, ws)),
        ("B9 append event, 5 rows", lambda: ops.sqexp(k_new, xs, ls),
         lambda: o_sqexp(k_new, xs, ls)),
        ("B9 append event, 1 row", lambda: ops.sqexp(k_one, xs, ls),
         lambda: o_sqexp(k_one, xs, ls)),
        ("B1 scores (5, 50), cap=192", lambda: ops.uncertainty_scores_clients(*sargs, **skw),
         lambda: o_scores(*sargs, **skw)),
        ("B7a one client's scores (50,), cap=192", lambda: ops.uncertainty_scores(*one, **skw),
         lambda: o_scores(*one, **skw)),
        (f"B7b one client's scores, cap tiles of {chip_smoke.TILE}",
         lambda: ops.uncertainty_scores(*one, **skw, block_cap=chip_smoke.TILE),
         lambda: o_scores(*one, **skw, block_cap=chip_smoke.TILE)),
        (f"B2 scores (5, 50), cap tiles of {chip_smoke.TILE}",
         lambda: ops.uncertainty_scores_clients(*sargs, **skw, block_cap=chip_smoke.TILE),
         lambda: o_scores(*sargs, **skw, block_cap=chip_smoke.TILE)),
        ("B3 gradient means (5, 1, 300), cap=192", lambda: ops.grad_mean_clients(*gargs, **gkw),
         lambda: o_grads(*gargs, **gkw)),
        ("B8a one client's gradient mean (1, 300), cap=192",
         lambda: ops.grad_mean_batch(*gone, **gkw), lambda: o_grads(*gone, **gkw)),
        (f"B8b one client's gradient mean, cap tiles of {tile}",
         lambda: ops.grad_mean_batch(*gone, **gkw, block_cap=tile),
         lambda: o_grads(*gone, **gkw, block_cap=tile)),
        (f"B4 gradient means (5, 1, 300), cap tiles of {tile}",
         lambda: ops.grad_mean_clients(*gargs, **gkw, block_cap=tile),
         lambda: o_grads(*gargs, **gkw, block_cap=tile)),
        *proj_times,
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
