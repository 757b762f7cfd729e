"""Matrix-free curvature: products, solvers, estimators.

* :func:`ggn_vp` / :func:`hvp`: forward-over-reverse GGN- and
  Hessian-vector products (``torch.func.jvp`` through the network, the
  exact loss Hessian in the middle, ``torch.func.vjp`` back), streamed over
  slices by ``cfg.microbatch_size`` through the ``_ScaledLoss`` correction.
* :class:`GGNOperator` / :class:`HessianOperator`: the same products as
  linear operators (``.mv`` / ``.mv_stacked``).
* :func:`cg_solve`: batched preconditioned conjugate gradients.
* :func:`kernel_ngd_direction`: the kernel-space natural gradient, its Gram
  assembled by the engine's ``ggn_gram`` extension through ``cross_dot``.
* :func:`slq_logdet`: stochastic Lanczos quadrature log-determinant.
* :func:`lanczos_topk`: top-k Ritz pairs from the same Lanczos scan.

Port of ``src/repro/curv``.
"""
from .cg import cg_solve
from .logdet import lanczos_topk, lanczos_tridiag, slq_logdet
from .ngd import kernel_ngd_direction
from .products import GGNOperator, HessianOperator, ggn_vp, hvp

__all__ = [
    "GGNOperator",
    "HessianOperator",
    "cg_solve",
    "ggn_vp",
    "hvp",
    "kernel_ngd_direction",
    "lanczos_topk",
    "lanczos_tridiag",
    "slq_logdet",
]
