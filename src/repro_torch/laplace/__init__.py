"""Curvature-backed uncertainty from one engine sweep: the Laplace
posteriors (:class:`DiagLaplace`, :class:`KronLaplace`,
:class:`LastLayerLaplace`), their evidence and its optimizer, and the GLM
and MC predictives (the GLM variance through the ``predictive_var`` kernel).

The matrix-free evidence (``log_marglik_matfree``) estimates the Occam
term by SLQ over GGN-vector products.  Port of ``src/repro/laplace``.
"""
from .marglik import MatfreeEvidence, log_marglik, log_marglik_matfree, optimize_marglik
from .posterior import (
    DiagLaplace,
    FitOptions,
    KronLaplace,
    LaplaceStructureError,
    LastLayerLaplace,
    fit_posterior,
)
from .predictive import glm_predictive, mc_predictive, probit_predictive

__all__ = [
    "DiagLaplace", "FitOptions", "KronLaplace", "LaplaceStructureError",
    "LastLayerLaplace", "MatfreeEvidence", "fit_posterior", "glm_predictive",
    "log_marglik", "log_marglik_matfree", "mc_predictive", "optimize_marglik",
    "probit_predictive",
]
