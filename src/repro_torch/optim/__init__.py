"""Optimizers of the port (sgd, adam, adamw) on stacked tensors."""

__all__ = ["optimizers"]
