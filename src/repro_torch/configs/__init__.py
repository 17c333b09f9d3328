"""Assigned-architecture registry (port of ``repro.configs``).

Each module defines ``FULL`` (the exact published config) and ``SMOKE`` (a
reduced same-family variant: <=2 layers, d_model <= 512, <=4 experts) that
runs a real forward step on the CPU.  The numbers are the reference's.
"""

from __future__ import annotations

import importlib

from repro_torch.models.config import ModelConfig

ARCH_IDS = (
    "llama4_maverick_400b_a17b",
    "llama4_scout_17b_16e",
    "mamba2_370m",
    "jamba_1_5_large_398b",
    "gemma_7b",
    "whisper_base",
    "yi_34b",
    "minitron_8b",
    "qwen2_vl_7b",
    "qwen1_5_0_5b",
)


# CLI ids use dashes (as in the assignment table); module names use underscores.
def _norm(arch_id: str) -> str:
    return arch_id.replace("-", "_").replace(".", "_")


def get_config(arch_id: str, variant: str = "full") -> ModelConfig:
    mod = importlib.import_module(f"repro_torch.configs.{_norm(arch_id)}")
    if variant == "full":
        return mod.FULL
    if variant == "smoke":
        return mod.SMOKE
    raise ValueError(f"unknown variant {variant!r}")


def all_configs(variant: str = "full") -> dict[str, ModelConfig]:
    return {a: get_config(a, variant) for a in ARCH_IDS}
