"""The BackPACK engine: extensions, losses, the module protocol, ``run``
and its accumulated lane, and the reducers that lane folds with."""
from . import reducers
from .engine import (
    AccumulatedSweepPlan,
    Results,
    SweepPlan,
    SweepStream,
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
    reduce_spec,
)
from .loss_hessian import CrossEntropyLoss, MSELoss
from .module import Activation, Dense, Lambda, Module, Sequential
from .reducers import (
    CONCAT,
    GRAM,
    GRAM_PAIR,
    KRON,
    MOMENT_MERGE,
    PMEAN,
    PSUM,
    REDUCERS,
    Reducer,
    register_reducer,
    resolve_reducer,
)

__all__ = [
    "ALL_EXTENSIONS", "AccumulatedSweepPlan", "Activation", "BatchDot", "BatchGrad",
    "BatchL2", "CONCAT", "CrossEntropyLoss", "Dense", "DiagGGN", "DiagGGNMC",
    "DiagHessian", "Extension", "ExtensionConfig", "GGNGram", "GGNTrace", "GRAM",
    "GRAM_PAIR", "KFAC", "KFLR", "KFRA", "KRON", "Lambda", "MOMENT_MERGE", "MSELoss",
    "Module", "NTK", "NTKClasswise", "PMEAN", "PSUM", "REDUCERS", "Reducer", "Results",
    "SecondMoment", "Sequential", "SweepPlan", "SweepStream", "Variance", "by_name",
    "gram_total", "loss_and_grad", "ntk_total", "plan_for_batch", "plan_sweeps",
    "reduce_spec", "reducers", "register_reducer", "resolve_reducer", "run",
]
