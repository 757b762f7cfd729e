"""Consumers of the empirical-NTK / Gram lane.

* :mod:`~repro_torch.ntk_apps.regression`: empirical-NTK kernel regression
  and GP predictives (mean and variance), solved in Gram space by Cholesky,
  dense eigendecomposition (optionally truncated), or Lanczos-top-k
  preconditioned CG.
* :mod:`~repro_torch.ntk_apps.influence`: influence functions and
  self-influence; per-sample gradients from ``BatchGrad``, the
  inverse-curvature product by ``curv.GGNOperator`` and batched CG.
* :mod:`~repro_torch.ntk_apps.selection`: subset selection off the
  extracted kernels, greedy max-diversity and BAIT.

Every entry point takes ``microbatches=k`` (the accumulated lane, and the
products streamed).  Port of ``src/repro/ntk_apps``, with its
:mod:`repro_torch.obs` spans (``ntk_apps/*``, ``sharded=False``); ``mesh=``
raises (ROADMAP queue A item 12).
"""
from .influence import InfluenceResult, influence_scores, self_influence
from .regression import GPPredictive, KernelSolveInfo, gp_predict, kernel_solve, ntk_kernel
from .selection import SelectionResult, bait_select, greedy_max_diversity, select_subset

__all__ = [
    "GPPredictive",
    "InfluenceResult",
    "KernelSolveInfo",
    "SelectionResult",
    "bait_select",
    "gp_predict",
    "greedy_max_diversity",
    "influence_scores",
    "kernel_solve",
    "ntk_kernel",
    "select_subset",
    "self_influence",
]
