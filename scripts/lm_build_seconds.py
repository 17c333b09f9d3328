#!/usr/bin/env python3
"""Seconds to build the parameters of the full-width LM configs of
``chip_smoke.py`` phase 4h, drawn on the CPU (``init_params``' default) and
on the card (``device_draws=True``).

    PYTHONPATH=src python3 scripts/lm_build_seconds.py   # on a machine with one CUDA card

For Qwen2-VL-7B (whole) and Llama-4-Scout at full width with 4 of its 48
layers, as phase 4h builds them (``chip_smoke.build_lm``'s seed): each
build between two synchronizations, the parameters left on the card, then
freed.  Prints the seconds of each and the card's name and power limit.
"""

from __future__ import annotations

import dataclasses
import gc
import subprocess
import time

import torch

from repro_torch import configs
from repro_torch.core.algorithms import stream_seed
from repro_torch.models.params import count_params, init_params

CONFIGS = {"qwen2-vl-7b": None, "llama4-scout-17b-16e": 4}  # arch: layers (None: all)


def main() -> None:
    dev = torch.device("cuda")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True).stdout
    print(card.strip(), flush=True)
    for arch, layers in CONFIGS.items():
        cfg = configs.get_config(arch)
        if layers is not None:
            cfg = dataclasses.replace(cfg, n_layers=layers)
        for device_draws in (True, False):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            params = init_params(stream_seed(0, 0), cfg, dev, device_draws=device_draws)
            torch.cuda.synchronize()
            secs = time.perf_counter() - t0
            print(f"{cfg.name} ({cfg.n_layers} layers, {count_params(cfg)} parameters, "
                  f"{cfg.dtype}) drawn on the {'card' if device_draws else 'CPU'}: "
                  f"{secs:.3f} s", flush=True)
            del params
            gc.collect()
            torch.cuda.empty_cache()


if __name__ == "__main__":
    main()
