"""Influence functions and self-influence at dataset scale.

Koh & Liang (2017) influence of train point ``i`` on test point ``j``:

    I(i, j) = ∇ℓ_jᵀ (H + δI)⁻¹ ∇ℓ_i

with ``H`` the GGN of the mean train loss at the current parameters (PSD,
so the solve is well-posed away from an optimum too).  Removing train point
``i`` from an n-point objective moves the optimum by ``≈ (1/n)(H+δI)⁻¹∇ℓ_i``,
so ``scores / n`` approximates the leave-one-out change of the test loss.

Per-sample gradients ride the engine's ``BatchGrad`` extension (in slices
under ``microbatches=k``); the inverse-curvature product is
:class:`repro_torch.curv.GGNOperator` with batched CG, so no factor is
materialized.  The engine's per-sample rows carry the mean loss's 1/M;
they are rescaled by ``loss.num_units`` to per-sample-loss units.

Port of ``src/repro/ntk_apps/influence.py``; ``mesh`` raises (ROADMAP queue A
item 12).
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional

import torch

from repro_torch import obs
from repro_torch.core.engine import plan_sweeps, refuse_mesh
from repro_torch.core.extensions import BatchGrad, ExtensionConfig
from repro_torch.core.loss_hessian import _f32
from repro_torch.core.tree import tree_leaves, tree_map
from repro_torch.curv import GGNOperator, cg_solve


class InfluenceResult(NamedTuple):
    scores: torch.Tensor      # [N_train, N_test] (or [N_train] for self)
    iters: int                # CG iterations of the inverse-curvature solve
    resid: torch.Tensor       # final CG relative residual (per RHS)


def _batch_rows(tree) -> int:
    return tree_leaves(tree)[0].shape[0]


def _with_microbatches(cfg, n: int, microbatches: Optional[int]):
    """A microbatch count as the cfg's slice size (streams the products)."""
    cfg = cfg or ExtensionConfig()
    if microbatches and microbatches > 1:
        cfg = dataclasses.replace(cfg, microbatch_size=-(-n // int(microbatches)))
    return cfg


def per_sample_grads(model, params, inputs, targets, loss, *, cfg=None, mesh=None,
                     shard_axes=("data",), microbatches: Optional[int] = None, rng=None):
    """Per-sample gradients ``∇ℓ_i`` as a tree with leading axis N:
    ``BatchGrad``, rescaled from the engine's 1/M rows."""
    refuse_mesh("per_sample_grads", mesh, shard_axes)
    cfg = cfg or ExtensionConfig()
    plan = plan_sweeps((BatchGrad,), cfg)
    if microbatches and microbatches > 1:
        plan = plan.accumulate(microbatches)
    res = plan.run(model, params, inputs, targets, loss, cfg=cfg, rng=rng)
    m = loss.num_units(targets)
    return tree_map(lambda r: _f32(r) * m.to(_f32(r).dtype), res.ext["batch_grad"])


def _dots(rows_a, rows_b):
    """⟨a_i, b_j⟩ summed over tree leaves → [N_a, N_b]."""
    out = None
    for a, b in zip(tree_leaves(rows_a), tree_leaves(rows_b), strict=True):
        d = a.reshape(a.shape[0], -1) @ b.reshape(b.shape[0], -1).T
        out = d if out is None else out + d
    return out


def _solve_curvature(model, params, x_train, y_train, loss, rhs_rows, *, damping, cfg,
                     cg_tol, cg_maxiter):
    op = GGNOperator(model, params, x_train, y_train, loss, damping=damping, cfg=cfg)
    return cg_solve(op.mv_stacked, rhs_rows, tol=cg_tol, maxiter=cg_maxiter, batched=True)


def influence_scores(model, params, x_train, y_train, x_test, y_test, loss, *,
                     damping: float = 1e-3, cfg=None, mesh=None, shard_axes=("data",),
                     microbatches: Optional[int] = None, cg_tol: float = 1e-8,
                     cg_maxiter: int = 200, rng=None) -> InfluenceResult:
    """``scores[i, j] = ∇ℓ_train_iᵀ (G + δI)⁻¹ ∇ℓ_test_j`` for every train
    and test point, by one batched CG solve over the test gradients."""
    refuse_mesh("influence_scores", mesh, shard_axes)
    n_train = _batch_rows(x_train)
    cfg = _with_microbatches(cfg, n_train, microbatches)
    with obs.span("ntk_apps/influence", n_train=n_train, n_test=_batch_rows(x_test),
                  microbatches=microbatches or 1):
        g_test = per_sample_grads(model, params, x_test, y_test, loss, cfg=cfg,
                                  microbatches=microbatches, rng=rng)
        with obs.span("ntk_apps/influence/solve"):
            sol = _solve_curvature(model, params, x_train, y_train, loss, g_test,
                                   damping=damping, cfg=cfg, cg_tol=cg_tol,
                                   cg_maxiter=cg_maxiter)
        g_train = per_sample_grads(model, params, x_train, y_train, loss, cfg=cfg,
                                   microbatches=microbatches, rng=rng)
        scores = _dots(g_train, sol.x)
    return InfluenceResult(scores=scores, iters=sol.iters, resid=sol.resid)


def self_influence(model, params, x_train, y_train, loss, *, damping: float = 1e-3,
                   cfg=None, mesh=None, shard_axes=("data",),
                   microbatches: Optional[int] = None, cg_tol: float = 1e-8,
                   cg_maxiter: int = 200, rng=None) -> InfluenceResult:
    """``s_i = ∇ℓ_iᵀ (G + δI)⁻¹ ∇ℓ_i`` for every train point, by one batched
    CG solve with the train gradients as right-hand sides."""
    refuse_mesh("self_influence", mesh, shard_axes)
    n_train = _batch_rows(x_train)
    cfg = _with_microbatches(cfg, n_train, microbatches)
    with obs.span("ntk_apps/self_influence", n_train=n_train, microbatches=microbatches or 1):
        g_train = per_sample_grads(model, params, x_train, y_train, loss, cfg=cfg,
                                   microbatches=microbatches, rng=rng)
        with obs.span("ntk_apps/influence/solve"):
            sol = _solve_curvature(model, params, x_train, y_train, loss, g_train,
                                   damping=damping, cfg=cfg, cg_tol=cg_tol,
                                   cg_maxiter=cg_maxiter)
        rows = torch.stack([(g.reshape(n_train, -1) * s.reshape(n_train, -1)).sum(1)
                            for g, s in zip(tree_leaves(g_train), tree_leaves(sol.x),
                                            strict=True)])
    return InfluenceResult(scores=rows.sum(0), iters=sol.iters, resid=sol.resid)
