"""Batched preconditioned conjugate gradients on parameter trees.

The implicit solve behind matrix-free natural gradients: CG touches the
curvature only through ``mv`` (one GGN- or Hessian-vector product an
iteration), so ``(G + δI)⁻¹ g`` costs ``iters × ~2`` gradient sweeps and
O(P) memory.

Batched right-hand sides ride a leading axis on every leaf: inner products
reduce over the trailing axes, so each runs its own recurrence in lockstep
(convergence when every relative residual passes ``tol``).  A
preconditioner is any linear callable ``r → M⁻¹r`` on the same trees.

Port of ``src/repro/curv/cg.py``: a Python loop in place of
``lax.while_loop``, with the same test before each iteration, so it stops
at the iteration JAX's loop stops at; the test reads the residual on the
host once an iteration.  Sums run in float32 (float64 for float64 inputs).
"""
from __future__ import annotations

from typing import Callable, NamedTuple, Optional

import torch

from repro_torch.core.loss_hessian import _f32
from repro_torch.core.tree import tree_leaves, tree_map


class CGResult(NamedTuple):
    x: object              # solution tree (leading RHS axis if batched)
    iters: int             # iterations executed
    resid: torch.Tensor    # final relative residual (per RHS if batched)


def _vdot(a, b, batch_ndim: int):
    """Tree inner product, reduced to a scalar per leading-RHS index."""
    def leaf(x, y):
        return (_f32(x) * _f32(y)).sum(dim=tuple(range(batch_ndim, x.dim())))

    leaves = [leaf(x, y) for x, y in zip(tree_leaves(a), tree_leaves(b), strict=True)]
    return sum(leaves[1:], leaves[0])


def cg_solve(mv: Callable, b, *, tol: float = 1e-6, maxiter: int = 50,
             precond: Optional[Callable] = None, x0=None,
             batched: bool = False) -> CGResult:
    """Solve ``A x = b`` with ``A`` given only through ``mv``.

    ``mv`` must be symmetric positive (semi-)definite: damp the GGN
    (``GGNOperator(damping=δ)``).  With ``batched=True`` every leaf of ``b``
    carries a leading RHS axis and ``mv`` maps it (``operator.mv_stacked``);
    a right-hand side whose ``pAp ≤ 0`` (or ``rz ≤ 0``) freezes in place.
    ``precond`` applies ``M⁻¹`` with ``mv``'s calling convention.

    Returns :class:`CGResult`: ``x``, iterations executed, and the final
    relative residual ``‖b − Ax‖ / ‖b‖`` (per RHS when batched).
    """
    batch_ndim = 1 if batched else 0
    apply_m = precond if precond is not None else (lambda r: r)

    def expand(s, leaf):
        # scalar per RHS, broadcastable against a leaf
        return s.reshape(tuple(s.shape) + (1,) * (leaf.dim() - batch_ndim))

    x = x0 if x0 is not None else tree_map(torch.zeros_like, b)
    r = tree_map(lambda bi, ax: _f32(bi) - _f32(ax), b, mv(x))
    z = apply_m(r)
    p = z
    rz = _vdot(r, z, batch_ndim)
    b_norm = torch.sqrt(_vdot(b, b, batch_ndim).clamp_min(1e-30))

    def resid_of(rr):
        return torch.sqrt(_vdot(rr, rr, batch_ndim).clamp_min(0.0)) / b_norm

    x = tree_map(_f32, x)
    it = 0
    while it < maxiter and bool((resid_of(r) > tol).any()):
        ap = mv(p)
        pap = _vdot(p, ap, batch_ndim)
        # a fully converged (or degenerate) RHS freezes in place
        alpha = torch.where(pap > 0, rz / torch.where(pap > 0, pap, torch.ones_like(pap)),
                            torch.zeros_like(pap))
        x = tree_map(lambda xi, pi: xi + expand(alpha, pi) * _f32(pi), x, p)
        r = tree_map(lambda ri, api: ri - expand(alpha, api) * _f32(api), r, ap)
        z = apply_m(r)
        rz_new = _vdot(r, z, batch_ndim)
        beta = torch.where(rz > 0, rz_new / torch.where(rz > 0, rz, torch.ones_like(rz)),
                           torch.zeros_like(rz))
        p = tree_map(lambda zi, pi: _f32(zi) + expand(beta, pi) * _f32(pi), z, p)
        rz = rz_new
        it += 1
    return CGResult(x=x, iters=it, resid=resid_of(r))
