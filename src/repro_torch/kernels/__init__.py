"""Kernels of the port.

``ref`` holds the plain torch oracles; ``gp_score``, ``gp_grad``,
``rff_features``, ``rff_grad`` and ``sqexp`` wrap the hand-written CUDA
kernels in ``csrc/`` (built on first use by ``loader``); ``ops`` pads,
routes between the resident and cap-tiled GP kernels, and slices back;
``autotune`` picks the GP kernels' block sizes for the card's shared
memory.
"""

__all__ = ["autotune", "gp_grad", "gp_score", "loader", "ops", "ref", "rff_features",
           "rff_grad", "sqexp"]
