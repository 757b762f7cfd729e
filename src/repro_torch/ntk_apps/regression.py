"""Empirical-NTK kernel regression and GP predictives in Gram space.

The linearized-network / GP correspondence: with ``K`` the empirical NTK
(class-traced, ``[N, N]``) over train ∪ test rows and ``Y`` the (one-hot or
regression) targets, the kernel-ridge / GP posterior is

    α     = (K_tt + λI)⁻¹ Y                        [N, C]
    mean  = K_st α                                  [N*, C]
    var_j = K_ss[j,j] − k_jᵀ (K_tt + λI)⁻¹ k_j      [N*]

All the network touches is one raw-Jacobian sweep: the kernel assembles
through the engine's NTK extension (``cross_dot`` on the card; row blocks
in slices and pair passes under ``microbatches=k``).

Three solvers share :func:`kernel_solve`:

* ``'cholesky'``: ``torch.linalg.cholesky`` and ``torch.cholesky_solve`` on
  ``K + λI``;
* ``'eigh'``: dense eigendecomposition; ``rank=r`` keeps the top-r
  eigenspace (the tail is solved at ``1/λ``, ridge only);
* ``'lanczos'``: :func:`repro_torch.curv.lanczos_topk` Ritz pairs build the
  spectral preconditioner ``M⁻¹ = U_r diag(1/(λ_r+λ)) U_rᵀ + (I − U_r
  U_rᵀ)/λ`` of a preconditioned :func:`repro_torch.curv.cg_solve` on
  ``K + λI``.

Port of ``src/repro/ntk_apps/regression.py``; ``mesh`` raises, and the
sharded lane's Gram assembly modes (JAX's ``gram_assembly``) come with it,
ROADMAP queue A item 12.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch
import torch.nn.functional as F

from repro_torch import obs
from repro_torch.core.engine import ntk_total, plan_sweeps, refuse_mesh
from repro_torch.core.extensions import NTK, ExtensionConfig
from repro_torch.core.loss_hessian import _f32
from repro_torch.core.tree import tree_leaves, tree_map
from repro_torch.curv import cg_solve, lanczos_topk


class KernelSolveInfo(NamedTuple):
    method: str
    rank: Optional[int]       # truncation / preconditioner rank (None = full)
    iters: int                # CG iterations (0 for direct solvers)
    resid: torch.Tensor       # relative residual ‖(K+λI)X − B‖/‖B‖


class GPPredictive(NamedTuple):
    mean: torch.Tensor        # [N_test, C] posterior mean
    var: torch.Tensor         # [N_test] posterior variance (kernel scale)
    alpha: torch.Tensor       # [N_train, C] representer coefficients
    kernel: torch.Tensor      # [N_train+N_test, N_train+N_test] joint NTK
    info: KernelSolveInfo


def _batch_rows(tree) -> int:
    return tree_leaves(tree)[0].shape[0]


def ntk_kernel(model, params, inputs, targets, loss, *, cfg=None, mesh=None,
               shard_axes=("data",), microbatches: Optional[int] = None, rng=None):
    """The class-traced empirical NTK ``[N, N]`` of a batch: one raw-Jacobian
    sweep through the engine's ``NTK`` extension, in ``microbatches`` row
    blocks when that is > 1 (the accumulated lane).  ``targets`` only feed
    the loss value; the kernel is loss-independent."""
    refuse_mesh("ntk_kernel", mesh, shard_axes)
    cfg = cfg or ExtensionConfig()
    plan = plan_sweeps((NTK,), cfg)
    if microbatches and microbatches > 1:
        plan = plan.accumulate(microbatches)
    with obs.span("ntk_apps/kernel", n=_batch_rows(inputs), sharded=False,
                  microbatches=microbatches or 1):
        res = plan.run(model, params, inputs, targets, loss, cfg=cfg, rng=rng)
    return ntk_total(res.ext["ntk"])


def kernel_solve(K, B, *, ridge: float, solver: str = "cholesky",
                 rank: Optional[int] = None, iters: Optional[int] = None,
                 cg_tol: float = 1e-10, cg_maxiter: int = 200, rng=None):
    """Solve ``(K + ridge·I) X = B`` in Gram space.  Returns ``(X, info)``.

    ``B`` may be ``[n]`` or ``[n, C]``.  ``rank`` is required for
    ``'lanczos'`` and truncates ``'eigh'``.  ``rng`` starts the Lanczos
    sweep: a ``torch.Generator``, or the start vector itself (``[n]``).
    """
    K, B = _f32(torch.as_tensor(K)), _f32(torch.as_tensor(B))
    squeeze = B.dim() == 1
    if squeeze:
        B = B[:, None]
    n = K.shape[0]
    lam = float(ridge)
    eye = torch.eye(n, dtype=K.dtype, device=K.device)
    it = 0
    with obs.span("ntk_apps/kernel_solve", solver=solver, n=n, rank=rank or 0):
        if solver == "cholesky":
            X = torch.cholesky_solve(B, torch.linalg.cholesky(K + lam * eye))
        elif solver == "eigh":
            evals, U = torch.linalg.eigh(K)
            if rank is None:
                X = U @ ((U.T @ B) / (evals + lam)[:, None])
            else:
                top = torch.argsort(evals, descending=True)[:rank]
                Ur, lr = U[:, top], evals[top]
                proj = Ur.T @ B
                # top-r eigenspace solved spectrally, the tail at ridge only
                X = Ur @ (proj / (lr + lam)[:, None]) + (B - Ur @ proj) / lam
        elif solver == "lanczos":
            if rank is None:
                raise ValueError("kernel_solve: solver='lanczos' needs rank=")
            start = dict(v0=rng) if isinstance(rng, torch.Tensor) else dict(rng=rng)
            top = lanczos_topk(lambda v: K @ v, torch.zeros(n, dtype=K.dtype, device=K.device),
                               k=rank, iters=iters, **start)
            Ur = top.eigvecs.T                          # [n, r]
            inv = 1.0 / (top.eigvals + lam)             # [r]

            def precond(R):                             # R: [C, n] batched rows
                proj = R @ Ur                           # [C, r]
                return (proj * inv) @ Ur.T + (R - proj @ Ur.T) / lam

            result = cg_solve(lambda X: X @ K + lam * X, B.T, tol=cg_tol, maxiter=cg_maxiter,
                              precond=precond, batched=True)
            X, it = result.x.T, result.iters
        else:
            raise ValueError(f"kernel_solve: unknown solver {solver!r} "
                             "(want 'cholesky', 'eigh' or 'lanczos')")
        resid = torch.linalg.norm(K @ X + lam * X - B) / torch.linalg.norm(B).clamp_min(1e-30)
    if squeeze:
        X = X[:, 0]
    return X, KernelSolveInfo(method=solver, rank=rank, iters=it, resid=resid)


def gp_predict(model, params, x_train, y_train, x_test, loss, *,
               ridge: float = 1e-3, targets=None, solver: str = "cholesky",
               rank: Optional[int] = None, iters: Optional[int] = None,
               cg_tol: float = 1e-10, cg_maxiter: int = 200,
               cfg=None, mesh=None, shard_axes=("data",),
               microbatches: Optional[int] = None, rng=None) -> GPPredictive:
    """NTK-GP posterior mean and variance at ``x_test``.

    The joint kernel over ``[train; test]`` assembles in one sweep (cross
    and test blocks exact), then the solve runs on the train block.
    ``targets`` overrides the regression targets (default: one-hot of
    integer ``y_train``, ``y_train`` itself otherwise).  ``microbatches=k``
    streams the Jacobian sweep row-blockwise; ``rng`` starts the Lanczos
    solver's sweep (:func:`kernel_solve`).
    """
    refuse_mesh("gp_predict", mesh, shard_axes)
    n_train = _batch_rows(x_train)
    n_test = _batch_rows(x_test)
    inputs = tree_map(lambda a, b: torch.cat([a, b], 0), x_train, x_test)
    # test-row targets are never read by the raw-Jacobian sweep: zeros
    y_all = tree_map(lambda a: torch.cat(
        [a, torch.zeros((n_test,) + tuple(a.shape[1:]), dtype=a.dtype, device=a.device)]),
        y_train)
    with obs.span("ntk_apps/gp_predict", n_train=n_train, n_test=n_test, solver=solver):
        K = ntk_kernel(model, params, inputs, y_all, loss, cfg=cfg, microbatches=microbatches)
        Ktt = K[:n_train, :n_train]
        Kst = K[n_train:, :n_train]
        Kss = K[n_train:, n_train:]

        if targets is not None:
            Y = _f32(torch.as_tensor(targets))
        elif not y_train.dtype.is_floating_point:
            with torch.no_grad():
                n_classes = model.call(params, tree_map(lambda a: a[:1], x_train)).shape[-1]
            Y = F.one_hot(y_train.long(), n_classes).to(K.dtype)
        else:
            Y = _f32(y_train)

        kw = dict(ridge=ridge, solver=solver, rank=rank, iters=iters, cg_tol=cg_tol,
                  cg_maxiter=cg_maxiter, rng=rng)
        alpha, info = kernel_solve(Ktt, Y, **kw)
        mean = Kst @ alpha
        # posterior variance: one more solve against the cross block
        W, _ = kernel_solve(Ktt, Kst.T, **kw)
        var = torch.diagonal(Kss) - torch.einsum("sn,ns->s", Kst, W)
    return GPPredictive(mean=mean, var=var, alpha=alpha, kernel=K, info=info)
