"""Optimizers: first-order (optimizers), LR schedules, and the paper's §4
curvature-preconditioned step (precond).  Port of ``src/repro/optim``; the
matrix-free step (``optim/matfree.py``) waits for the matrix-free curvature
lane."""
from .optimizers import Optimizer, adamw, apply_updates, momentum_sgd, sgd
from .precond import curvature_optimizer
from .schedule import constant, cosine, linear_warmup

__all__ = ["Optimizer", "adamw", "apply_updates", "constant", "cosine",
           "curvature_optimizer", "linear_warmup", "momentum_sgd", "sgd"]
