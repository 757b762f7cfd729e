"""The BackPACK engine: extensions, losses, the module protocol and ``run``."""
from .engine import Results, SweepPlan, loss_and_grad, plan_for_batch, plan_sweeps, run
from .extensions import (
    ALL_EXTENSIONS,
    KFAC,
    KFLR,
    KFRA,
    BatchDot,
    BatchGrad,
    BatchL2,
    DiagGGN,
    DiagGGNMC,
    DiagHessian,
    Extension,
    ExtensionConfig,
    GGNTrace,
    SecondMoment,
    Variance,
    by_name,
)
from .loss_hessian import CrossEntropyLoss, MSELoss
from .module import Activation, Dense, Lambda, Module, Sequential

__all__ = [
    "ALL_EXTENSIONS", "Activation", "BatchDot", "BatchGrad", "BatchL2",
    "CrossEntropyLoss", "Dense", "DiagGGN", "DiagGGNMC", "DiagHessian",
    "Extension", "ExtensionConfig", "GGNTrace", "KFAC", "KFLR", "KFRA",
    "Lambda", "MSELoss", "Module", "Results", "SecondMoment", "Sequential",
    "SweepPlan", "Variance", "by_name", "loss_and_grad", "plan_for_batch",
    "plan_sweeps", "run",
]
