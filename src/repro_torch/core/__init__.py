"""The BackPACK engine: extensions, losses, the module protocol and ``run``."""
from .engine import (
    Results,
    SweepPlan,
    gram_total,
    loss_and_grad,
    ntk_total,
    plan_for_batch,
    plan_sweeps,
    run,
)
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
    GGNGram,
    GGNTrace,
    NTK,
    NTKClasswise,
    SecondMoment,
    Variance,
    by_name,
)
from .loss_hessian import CrossEntropyLoss, MSELoss
from .module import Activation, Dense, Lambda, Module, Sequential

__all__ = [
    "ALL_EXTENSIONS", "Activation", "BatchDot", "BatchGrad", "BatchL2",
    "CrossEntropyLoss", "Dense", "DiagGGN", "DiagGGNMC", "DiagHessian",
    "Extension", "ExtensionConfig", "GGNGram", "GGNTrace", "KFAC", "KFLR",
    "KFRA", "Lambda", "MSELoss", "Module", "NTK", "NTKClasswise", "Results",
    "SecondMoment", "Sequential", "SweepPlan", "Variance", "by_name",
    "gram_total", "loss_and_grad", "ntk_total", "plan_for_batch",
    "plan_sweeps", "run",
]
