"""Optimizers: first-order (optimizers), LR schedules, and the paper's §4
curvature-preconditioned step (precond) and the matrix-free natural-gradient
step (matfree).  Port of ``src/repro/optim``."""
from .matfree import make_cg_ngd_step
from .optimizers import Optimizer, adamw, apply_updates, momentum_sgd, sgd
from .precond import curvature_optimizer
from .schedule import constant, cosine, linear_warmup

__all__ = ["Optimizer", "adamw", "apply_updates", "constant", "cosine",
           "curvature_optimizer", "linear_warmup", "make_cg_ngd_step", "momentum_sgd",
           "sgd"]
