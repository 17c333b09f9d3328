"""Federated ZOO core of the port: objectives, FD directions, the trajectory
GP surrogate with its Gram-factor cache, RFF features and the round engine."""

__all__ = ["algorithms", "fd", "gp_surrogate", "objectives", "rff", "rounds"]
