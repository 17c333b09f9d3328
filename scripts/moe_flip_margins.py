#!/usr/bin/env python3
"""The near-tie margins at which a bf16 MoE stack routes otherwise than its
float64 run (``repro_torch.models.layers.flip_margins``), the reading that
``layers.NEAR_TIE`` is set from.

    PYTHONPATH=src python3 scripts/moe_flip_margins.py [--device cuda]

For each MoE SMOKE config (llama4 scout and maverick, jamba) and each of 12
seeds: the port's own parameters (``init_params``, seed 0) in bf16 on
``--device``, and (1) the forward of a (2, 32) token batch drawn from the
seed, (2) the LM objective's values at 5 clients x 4 points
(``make_lm_objective`` of the seed, each (client, point) its own group),
each beside the same call in float64 on the CPU with the routings recorded
(``layers.Routes``).  Prints, per config and call, the tokens whose choice
changed first and the largest float64 margin (p_k - p_{k+1}) / p_k among
them, then the largest over everything.
"""

from __future__ import annotations

import argparse
import dataclasses

import torch

from repro_torch import configs
from repro_torch.core import model_objectives as mobj
from repro_torch.models import layers as L
from repro_torch.models.model import forward
from repro_torch.models.params import init_params
from repro_torch.sharding import ShardingPolicy

ARCHS = ("llama4-scout-17b-16e", "llama4-maverick-400b-a17b", "jamba-1.5-large-398b")
SEEDS = range(12)


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cpu")
    dev = torch.device(ap.parse_args().device)
    pol = ShardingPolicy(remat=False)
    largest = 0.0
    for arch in ARCHS:
        cfg = configs.get_config(arch, "smoke")
        cfg64 = dataclasses.replace(cfg, dtype="float64")
        params = init_params(0, cfg, "cpu")
        p64 = {k: v.double() for k, v in params.items()}
        on_dev = {k: v.to(dev) for k, v in params.items()}
        for call in ("forward", "values"):
            flips, top = 0, 0.0
            for seed in SEEDS:
                routes, routes64 = L.Routes(), L.Routes()
                if call == "forward":
                    gen = torch.Generator().manual_seed(seed)
                    toks = torch.randint(0, cfg.vocab_size, (2, 32), generator=gen)
                    forward(on_dev, cfg, {"tokens": toks.to(dev)}, pol, routes=routes)
                    forward(p64, cfg64, {"tokens": toks}, pol, routes=routes64)
                    length = 32
                else:
                    cps = mobj.make_lm_objective(seed, cfg, 5, device="cpu")
                    x = torch.rand((5, 4, cfg.d_model),
                                   generator=torch.Generator().manual_seed(seed))
                    gains = mobj.lm_gains(params["final_norm"], cps.scale, x)
                    mobj.lm_values(cfg, on_dev, mobj.to(cps, dev), gains.to(dev), pol,
                                   routes=routes)
                    mobj.lm_values(cfg64, p64, cps, gains.double(), pol, routes=routes64)
                    length = cps.batches_tokens.shape[-1]
                m = L.flip_margins(routes, routes64, length)
                flips += m.numel()
                top = max(top, float(m.max()) if m.numel() else 0.0)
            print(f"{cfg.name} bf16 {call} on {dev.type}, {len(SEEDS)} seeds: {flips} tokens "
                  f"first routed otherwise, the largest float64 margin among them {top:.6f}",
                  flush=True)
            largest = max(largest, top)
    print(f"largest margin {largest:.6f}; NEAR_TIE {L.NEAR_TIE} "
          f"({'holds' if largest <= L.NEAR_TIE else 'EXCEEDED'})")


if __name__ == "__main__":
    main()
