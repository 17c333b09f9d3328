"""Federated ZOO core of the port: objectives (synthetic and model-backed),
FD directions, the trajectory GP surrogate with its Gram-factor cache, RFF
features and the round engine."""

__all__ = ["algorithms", "fd", "gp_surrogate", "model_objectives", "objectives", "rff",
           "rounds"]
