"""Data of the port: the label partitioners of the paper's real-world
objectives (``partition``)."""

__all__ = ["partition"]
