"""The paper's §4 optimizer: damped curvature-preconditioned updates.

    θ ← θ − α (G(θ) + (λ+η) I)⁻¹ (∇L + η θ)          (Eq. 7 / 27)

with G from any BackPACK curvature backend:

  * ``diag_ggn`` / ``diag_ggn_mc`` / ``diag_hessian`` — elementwise inverse;
  * ``kfac`` / ``kflr`` / ``kfra`` — Kronecker factors inverted with the
    Martens–Grosse π-damping (Eq. 28/29, :mod:`repro_torch.core.kron`).

Parameters without a curvature entry (buffers, and any leaf the backend
leaves out) fall back to a plain damped-SGD step.  EMA smoothing over steps
(``stat_decay``) follows standard K-FAC practice.  Port of
``src/repro/optim/precond.py``.
"""
from __future__ import annotations

import torch

from repro_torch.core import kron as K
from repro_torch.core.tree import tree_map
from repro_torch.optim.optimizers import Optimizer, _finish

_DIAG = {"diag_ggn", "diag_ggn_mc", "diag_hessian"}
_KRON = {"kfac", "kflr", "kfra"}


def _is_kron_leaf(node) -> bool:
    return isinstance(node, dict) and "B" in node and set(node) <= {"A", "B", "A_diag"}


def _ema(old, new, decay):
    if old is None:
        return new
    return tree_map(lambda o, n: decay * o + (1 - decay) * n, old, new)


PER_EXPERT_KFAC = (
    "Kronecker factors of stacked per-expert weights (B of shape [L, E, b, b]) are not "
    "supported: the reference's preconditioner (src/repro/optim/precond.py:62-64) vmaps "
    "once, over a B of 3 dimensions, and fails on them (ROADMAP queue C, faults in the "
    "reference); train a mixture of experts with diag_ggn_mc or cg_ngd")


def _kron_step(c, gf, damping):
    """(A⊗B + λI)⁻¹ g for one Kronecker leaf; a ``B`` of 3 dimensions is a
    stack of layers (or experts), solved one by one.  A ``B`` of 4 (a layer
    stack of experts) raises, as the reference fails there."""
    A = c.get("A", c.get("A_diag"))
    B = c["B"]
    if B.dim() > 3:
        raise NotImplementedError(PER_EXPERT_KFAC)
    if A is None:
        def solve(b_, g_):
            return K.kron_solve_bias(b_, g_, damping)
        args = (B, gf)
    else:
        def solve(a_, b_, g_):
            return K.kron_solve(a_, b_, g_, damping)
        args = (A, B, gf)
    if B.dim() == 3:
        return torch.stack([solve(*xs) for xs in zip(*args)])
    return solve(*args)


def _precond_tree(grads, curv, damping, eta, params, lr):
    """Recurse (grads, curv, params) producing updates, each leaf finished
    (``_finish``: its parameter's dtype, 0 for a buffer) as it is made."""

    def step(g, c, p):
        gf = g.float() + eta * p.float()
        if c is None or (isinstance(c, tuple) and len(c) == 0):
            return -lr * gf / (damping + eta)
        if _is_kron_leaf(c):
            return -lr * _kron_step(c, gf, damping + eta)
        return -lr * gf / (c.float() + damping + eta)  # diagonal curvature

    def rec(g, c, p, path):
        if isinstance(g, dict):
            return {k: rec(g[k], c.get(k) if isinstance(c, dict) else None, p[k], path + (k,))
                    for k in g}
        if isinstance(g, (tuple, list)):
            c_t = c if isinstance(c, (tuple, list)) else (None,) * len(g)
            return tuple(rec(gi, ci, pi, path + (i,))
                         for i, (gi, ci, pi) in enumerate(zip(g, c_t, p)))
        return _finish(path, step(g, c, p), p)

    return rec(grads, curv, params, ())


def curvature_optimizer(lr, damping=1e-2, curvature="diag_ggn_mc",
                        weight_decay=0.0, stat_decay=0.0):
    """An :class:`Optimizer` whose ``update`` takes ``curv=`` (the engine's
    ``Results.ext[curvature]``)."""
    if curvature not in _DIAG | _KRON:
        raise ValueError(f"curvature must be one of {sorted(_DIAG | _KRON)}, "
                         f"got {curvature!r}")

    def init(params):
        return {"stats": None, "t": 0}

    def update(grads, state, params, curv=None, **kw):
        if curv is None:
            raise ValueError("curvature_optimizer.update needs curv=")
        if stat_decay > 0.0 and state["stats"] is not None:
            curv = _ema(state["stats"], curv, stat_decay)
        ups = _precond_tree(grads, curv, damping, weight_decay, params, lr)
        new_state = {"stats": curv if stat_decay > 0.0 else None, "t": state["t"] + 1}
        return ups, new_state

    return Optimizer(init, update)
