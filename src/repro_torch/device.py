"""The device an entry point of the port runs on."""

from __future__ import annotations

import torch


def resolve_device(device) -> torch.device:
    """``device`` as a ``torch.device``; an error when it is CUDA and no
    CUDA device is present (there is no silent fallback to the CPU)."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("repro_torch runs on CUDA by default and no CUDA device is "
                           "available; pass device='cpu' to run on the CPU")
    return dev
