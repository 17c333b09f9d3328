"""Kernels of the port.

``ref`` holds the plain torch oracles; ``gp_score`` and ``gp_grad`` wrap the
hand-written CUDA kernels in ``csrc/`` (built on first use by ``loader``);
``ops`` pads, routes between the resident and cap-tiled kernels, and slices
back; ``autotune`` picks block sizes for the card's shared memory.
"""

__all__ = ["autotune", "gp_grad", "gp_score", "loader", "ops", "ref"]
