#!/usr/bin/env python3
"""The small card-vs-CPU checks of ``chip_smoke.py`` beside a float64 run of
the same engine on the same draws.

    python3 scripts/small_check_f64.py   # on a machine with one CUDA card

``chip_smoke.check_small_against_cpu`` holds the small engine
(``chip_smoke.small_config``: d=8, N=3, cap=16, 3 rounds, draws 2) on the
card (kernels) against the same engine on the CPU (plain versions): F
within 1e-3 and x within 1e-2.  This runs both again (``chip_smoke.small_run``)
beside a float64 run on the CPU: a copy of the port's package under
``build/f64_engine/`` in which every float32 is float64 (state, optimizer,
objective, the wrappers' type check, so the plain versions run in
float64), fed the same draws widened to float64 and run in a child process
so that the two packages do not mix.  For the per-client and the deferred
engines on the quadratic, and the deferred engine on the small attack
(``chip_smoke.small_model_objective``: trained once in float32 on the CPU,
its tensors widened to float64 for the float64 run), it prints max|dF| and
max|dx| over the rounds and per round for card vs CPU (the smoke's check),
card vs float64 and CPU vs float64, and the card's name and power limit.
"""

from __future__ import annotations

import argparse
import shutil
import subprocess
import sys
from pathlib import Path

import torch
from torch.utils import _pytree as pytree

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import chip_smoke  # noqa: E402

F64 = ROOT / "build" / "f64_engine"
ENGINES = {"per-client": dict(defer_repair=False), "deferred": {},
           "attack deferred": dict(objective="attack")}


def f64_package() -> Path:
    """The port's package copied with every float32 made float64."""
    dst = F64 / "repro_torch"
    shutil.rmtree(dst, ignore_errors=True)
    for src in (ROOT / "src" / "repro_torch").rglob("*.py"):
        out = dst / src.relative_to(ROOT / "src" / "repro_torch")
        out.parent.mkdir(parents=True, exist_ok=True)
        text = src.read_text().replace("torch.float32", "torch.float64")
        out.write_text(text.replace("np.float32", "np.float64"))
    return F64


def child(engine: str, out: Path) -> None:
    """The float64 run (in the child, with the copy first on the path)."""
    sys.path.insert(0, str(F64))
    import repro_torch

    if not repro_torch.__file__.startswith(str(F64)):
        raise SystemExit(f"the float64 copy was not imported: {repro_torch.__file__}")
    objective = ENGINES[engine].get("objective")
    if objective:  # the parent's float32 objective, its tensors widened
        cobjs, d = torch.load(F64 / f"{objective}.objective.pt", weights_only=False)
        wide = pytree.tree_map_only(
            torch.Tensor, lambda t: t.double() if t.is_floating_point() else t, cobjs)
        chip_smoke.small_model_objective = lambda name: (wide, d)
    res = chip_smoke.small_run("cpu", torch.float64, **ENGINES[engine])
    if res.f_values.dtype != torch.float64:
        raise SystemExit(f"the copy ran in {res.f_values.dtype}")
    torch.save({"f": res.f_values, "x": res.xs, "q": res.queries}, out)


def dist(a, b) -> tuple[float, float, list[float]]:
    """max|dF|, max|dx| and max|dx| per round."""
    df = (a["f"].double() - b["f"].double()).abs().max().item()
    dx = (a["x"].double() - b["x"].double()).abs()
    return df, dx.max().item(), dx.reshape(dx.shape[0], -1).max(1).values.tolist()


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--f64-child", nargs=2, metavar=("ENGINE", "OUT"), help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.f64_child:
        child(args.f64_child[0], Path(args.f64_child[1]))
        return 0
    if not torch.cuda.is_available():
        print("small_check_f64: no CUDA device available", file=sys.stderr)
        return 1
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    print(smi, flush=True)
    f64_package()
    dev = torch.device("cuda")
    for name, engine in ENGINES.items():
        out = F64 / f"{name}.pt"
        if engine.get("objective"):
            torch.save(chip_smoke.small_model_objective(engine["objective"]),
                       F64 / f"{engine['objective']}.objective.pt")
        subprocess.run([sys.executable, __file__, "--f64-child", name, str(out)], check=True)
        runs = {"f64": torch.load(out)}
        for side, where in (("CPU", "cpu"), ("card", dev)):
            res = chip_smoke.small_run(where, **engine)
            runs[side] = {"f": res.f_values.cpu(), "x": res.xs.cpu(), "q": res.queries.cpu()}
        for a, b in (("card", "CPU"), ("card", "f64"), ("CPU", "f64")):
            df, dx, per = dist(runs[a], runs[b])
            same_q = torch.equal(runs[a]["q"], runs[b]["q"])
            print(f"[{name}] {a} vs {b}: max|dF|={df:.4e} max|dx|={dx:.4e}; max|dx| per round "
                  f"{[f'{v:.3e}' for v in per]}; same query counts: {same_q}", flush=True)
    print(smi, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
