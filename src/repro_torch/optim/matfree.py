"""Matrix-free natural-gradient step: CG (or Gram-space) implicit solve.

The §4 preconditioned update (Eq. 7) without materializing the
preconditioner:

    θ ← θ − α (G(θ) + δI)⁻¹ ∇L(θ)

* ``solver='cg'``: conjugate gradients against the matrix-free
  :class:`~repro_torch.curv.GGNOperator` (~2 gradient sweeps an iteration).
* ``solver='kernel'``: the kernel-space solve
  (:func:`repro_torch.curv.kernel_ngd_direction`), exact ``(G + δI)⁻¹ g``
  for the Dense-visible parameters through one dense ``[N·C̃]`` Gram solve;
  the Gram is the engine's ``ggn_gram`` extension, so the step runs
  ``cross_dot``.  Flat-output models only.

``make_cg_ngd_step`` returns ``(opt, step)``: an
:class:`~repro_torch.optim.Optimizer` whose ``init`` builds the step state
(``update`` is unused) and ``step(params, opt_state, batch, step_idx,
rng)``, which ``train/loop.fit(step_fn=...)`` drives (the training
launcher's ``--optimizer cg_ngd``).  Port of ``src/repro/optim/matfree.py``;
the ``mesh`` lane is ROADMAP queue A item 12.
"""
from __future__ import annotations

from typing import Optional, Sequence

from repro_torch.core import engine as eng
from repro_torch.core.extensions import ExtensionConfig, GGNGram
from repro_torch.core.loss_hessian import _f32
from repro_torch.core.tree import tree_leaves, tree_map
from repro_torch.curv import GGNOperator, cg_solve, kernel_ngd_direction

from .optimizers import Optimizer, _leafwise, apply_updates


def make_cg_ngd_step(model, loss, *, lr: float, damping: float = 1e-3,
                     solver: str = "cg", cg_iters: int = 10,
                     cg_tol: float = 1e-5, weight_decay: float = 0.0,
                     ext_cfg: Optional[ExtensionConfig] = None,
                     mesh=None, shard_axes: Sequence[str] = ("data",)):
    """Build the matrix-free natural-gradient training step.

    ``ext_cfg.microbatch_size`` streams both the gradient sweep (the
    accumulated lane, through ``plan_for_batch``) and every curvature
    product.  Returns ``(opt, step)``; see the module docstring.
    """
    if solver not in ("cg", "kernel"):
        raise ValueError(f"solver must be 'cg' or 'kernel', got {solver!r}")
    eng.refuse_mesh("make_cg_ngd_step", mesh, shard_axes)
    cfg = ext_cfg or ExtensionConfig()

    def init(params):
        return {"t": 0}

    def _sweep(params, batch, rng, extensions):
        n = tree_leaves(batch["inputs"])[0].shape[0]
        plan = eng.plan_for_batch(extensions, cfg, n)
        return plan.run(model, params, batch["inputs"], batch["labels"], loss, cfg=cfg,
                        rng=rng)

    def step(params, opt_state, batch, step_idx, rng=None):
        metrics = {}
        if solver == "kernel":
            res = _sweep(params, batch, rng, (GGNGram,))
            d, _ = kernel_ngd_direction(model, params, batch["inputs"], batch["labels"], loss,
                                        damping=damping, cfg=cfg, results=res)
        else:
            res = _sweep(params, batch, rng, ())
            op = GGNOperator(model, params, batch["inputs"], batch["labels"], loss,
                             damping=damping, cfg=cfg)
            sol = cg_solve(op.mv, res.grads, tol=cg_tol, maxiter=cg_iters)
            d = sol.x
            metrics["cg_iters"] = sol.iters
            metrics["cg_resid"] = sol.resid
        if weight_decay:
            d = tree_map(lambda di, p: di + float(weight_decay) * _f32(p), d, params)
        ups = _leafwise(lambda di, p: -lr * di, params, d)
        params = apply_updates(params, ups)
        metrics.update({"loss": res.loss, "step": step_idx + 1})
        return params, {"t": opt_state["t"] + 1}, metrics

    def update(grads, state, params, **kw):
        raise NotImplementedError(
            "cg_ngd is a whole-step optimizer (the solve needs the batch, not "
            "just the gradient): drive it through the returned step function")

    return Optimizer(init, update), step
