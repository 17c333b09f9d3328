"""PyTorch/CUDA port of the FZooS reproduction (the JAX package ``repro`` is
the reference it is held against).

The subpackages mirror the reference's layout: ``core`` (objectives, GP
surrogate, RFF, the round engine, the model-backed objectives), ``data``
(label partitions), ``optim``, ``kernels`` (plain torch
oracles plus hand-written CUDA kernels for Hopper), ``checkpoint`` (the
round engine's checkpoints) and ``launch`` (the command line).  Entry points run on
``device="cuda"`` unless the caller asks for ``"cpu"``.

TF32 is switched off for the whole package: the padded trajectory Gram
reaches cond 1e5-1e6 (DESIGN.md Sec. 2.4), and TF32's ~3 decimal digits
would turn its solves into noise.
"""

import torch

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

__all__ = ["checkpoint", "convert", "core", "data", "device", "kernels", "launch", "optim"]
