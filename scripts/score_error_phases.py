#!/usr/bin/env python3
"""How much of the scoring's error against float64 each step's f32
arithmetic contributes, at the sizes of the smoke's tiled-accuracy check.

    python3 scripts/score_error_phases.py   # on a machine with one CUDA card

For each size of ``chip_smoke.TILED_ACCURACY`` it builds the smoke's inputs
(``chip_smoke.path_inputs``: the Gram factor by the port's own kernels),
takes the float64 truth (the tiled plain version on float64 copies), and
prints the max and mean |score - truth| over the candidates of:

* the f32 plain version (``gp_score.scores_tiled_plain``);
* the scores with h, c.x and |c|^2 from f32 and every later sum in f64;
* h alone from f32 (c.x, |c|^2 and the sums f64);
* c.x and |c|^2 alone from f32 (h and the sums f64);
* h rounded to f32 from float64 (the error of storing h in f32);
* float64 throughout, the output rounded to f32 (the floor any f32 output
  meets);
* the kernel (``kernels.ops`` on the tiled route).

The steps in f32 are those of the plain version's expanded distance
(``ref._h_cross``); the f64 sums are the fused form in float64.
"""

from __future__ import annotations

import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "src"))

import chip_smoke  # noqa: E402
from repro_torch.kernels import gp_score, ops, ref  # noqa: E402


def fused(h, cross, n1, binv, pmat, ls, prior):
    """The scores from h, c.x and |c|^2, every sum in the inputs' dtype."""
    g1 = torch.einsum("bnc,bck->bnk", h, pmat)
    g2 = torch.einsum("bnc,bck->bnk", h, binv)
    corr = torch.sum((g1 - (2.0 * cross - n1[..., None]) * g2) * h, dim=-1) / ls**4
    return torch.clamp(prior - corr, min=0.0)


def main() -> int:
    if not torch.cuda.is_available():
        print("score_error_phases: no CUDA device available", file=sys.stderr)
        return 1
    dev = torch.device("cuda")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip(), flush=True)
    for nb, n, cap, d, tile in chip_smoke.TILED_ACCURACY:
        p = chip_smoke.path_inputs(dev, nb, n, cap, d)
        ls, prior = p["ls"], p["prior"]
        args = (p["cands"], p["xs_sh"], p["binv"], p["pmat"])
        a64 = tuple(a.double() for a in args)
        truth = gp_score.scores_tiled_plain(*a64, ls, prior, tile)
        h32, c32, n32 = (t.double() for t in ref._h_cross(args[0], args[1], ls))
        h64, c64, n64 = ref._h_cross(a64[0], a64[1], ls)
        b64, p64 = a64[2], a64[3]
        kw = dict(lengthscale=ls, prior=prior, block_cap=tile)
        kernel = (ops.uncertainty_scores(*(a[0] for a in args), **kw)[None] if nb == 1
                  else ops.uncertainty_scores_clients(*args, **kw))
        rows = {
            "plain f32": gp_score.scores_tiled_plain(*args, ls, prior, tile),
            "h, c.x, |c|^2 f32; sums f64": fused(h32, c32, n32, b64, p64, ls, prior),
            "h f32; the rest f64": fused(h32, c64, n64, b64, p64, ls, prior),
            "c.x, |c|^2 f32; the rest f64": fused(h64, c32, n32, b64, p64, ls, prior),
            "h rounded to f32; the rest f64": fused(h64.float().double(), c64, n64, b64, p64, ls,
                                                    prior),
            "f64, output rounded to f32": fused(h64, c64, n64, b64, p64, ls, prior).float(),
            "the kernel (tiled route)": kernel,
        }
        print(f"N={nb} n={n} cap={cap} d={d} tile={tile}: largest score "
              f"{truth.max().item():.6g}", flush=True)
        for name, got in rows.items():
            err = (got.double() - truth).abs()
            print(f"  {name:>32}: max {err.max().item():.4e}, mean {err.mean().item():.4e}",
                  flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
