"""Step builders: the plain gradient step and the extended step.

``make_train_step`` is the production path: a PyTorch autograd backward pass
over ``model.call`` plus an optimizer, as the JAX package's takes
``jax.value_and_grad``; it does not go through the engine.
``make_extended_train_step`` runs the BackPACK engine instead, harvesting
extension quantities in the same sweep — the curvature-preconditioned
optimizer of the paper's §4 takes its curvature from there.

Port of ``src/repro/train/step.py``.  Options:
  * ``microbatch`` — gradient accumulation over equal slices of the batch,
    a Python loop (activation memory ÷ microbatches);
  * ``remat``      — recompute the forward pass in the backward pass
    (``torch.utils.checkpoint``).
A step takes and returns parameter trees; it never changes the tensors it is
given.  ``make_prefill_step`` and ``make_decode_step`` are the serving
steps of a language model (:mod:`repro_torch.serve.engine` drives them).
"""
from __future__ import annotations

from typing import Optional, Sequence

import torch
import torch.utils.checkpoint

from repro_torch.core import engine as eng
from repro_torch.core.extensions import ExtensionConfig
from repro_torch.core.tree import tree_leaves, tree_map
from repro_torch.optim.optimizers import apply_updates


def make_loss_fn(model, loss, remat=False):
    def loss_fn(params, inputs, labels):
        if remat:
            z = torch.utils.checkpoint.checkpoint(model.call, params, inputs,
                                                  use_reentrant=False)
        else:
            z = model.call(params, inputs)
        return loss.value(z, labels)

    return loss_fn


def _value_and_grad(loss_fn, params, inputs, labels):
    """(loss, grads) of ``loss_fn`` at ``params`` by autograd; the grads are
    a tree of the params' structure."""
    leaves = []

    def track(p):
        leaves.append(p.detach().requires_grad_(True))
        return leaves[-1]

    with torch.enable_grad():
        tracked = tree_map(track, params)
        lv = loss_fn(tracked, inputs, labels)
        gs = torch.autograd.grad(lv, leaves, allow_unused=True)
    it = iter(torch.zeros_like(p) if g is None else g for p, g in zip(leaves, gs))
    return lv.detach(), tree_map(lambda _: next(it), tracked)


def make_train_step(model, loss, opt, *, microbatch: int = 1,
                    remat: bool = False, grad_dtype=None):
    """``step(params, opt_state, batch, step_idx) -> (params, opt_state,
    metrics)`` with ``batch = {"inputs": ..., "labels": ...}``."""
    loss_fn = make_loss_fn(model, loss, remat=remat)

    def accumulate(params, batch):
        n = tree_leaves(batch["inputs"])[0].shape[0]
        if n % microbatch:
            raise ValueError(f"batch of {n} does not split into {microbatch} microbatches")
        size = n // microbatch
        acc_l = 0.0
        acc_g = tree_map(lambda p: torch.zeros(p.shape, dtype=grad_dtype or torch.float32,
                                               device=p.device), params)
        for i in range(microbatch):
            sl = slice(i * size, (i + 1) * size)
            lv, g = _value_and_grad(loss_fn, params, tree_map(lambda a: a[sl], batch["inputs"]),
                                    batch["labels"][sl])
            if grad_dtype is not None:
                g = tree_map(lambda a: a.to(grad_dtype), g)
            acc_l = acc_l + lv
            acc_g = tree_map(torch.add, acc_g, g)
        scale = 1.0 / microbatch
        return acc_l * scale, tree_map(lambda a: a * scale, acc_g)

    def step(params, opt_state, batch, step_idx):
        if microbatch == 1:
            lv, grads = _value_and_grad(loss_fn, params, batch["inputs"], batch["labels"])
        else:
            lv, grads = accumulate(params, batch)
        ups, opt_state = opt.update(grads, opt_state, params)
        return apply_updates(params, ups), opt_state, {"loss": lv, "step": step_idx + 1}

    return step


_CURVATURES = ("kfac", "kflr", "diag_ggn_mc", "diag_ggn", "kfra", "diag_hessian")


def make_extended_train_step(model, loss, opt, extensions,
                             cfg: Optional[ExtensionConfig] = None,
                             track: Sequence[str] = (),
                             mesh=None, shard_axes=("data",)):
    """Engine-backed step: gradient + extensions in one generalized
    backprop; the curvature goes to the optimizer (Eq. 7), tracked
    statistics (e.g. the mean variance, for gradient-noise telemetry) to
    the metrics as ``<name>_mean``.

    ``step(params, opt_state, batch, step_idx, rng)``; ``rng`` is the MC
    sweep's (a ``torch.Generator`` or the draws, see :func:`~repro_torch.
    core.engine.run`).  The curvature is the first of kfac, kflr,
    diag_ggn_mc, diag_ggn, kfra, diag_hessian among ``extensions``.  The
    sweep lane comes from :func:`~repro_torch.core.engine.plan_for_batch`:
    with ``cfg.microbatch_size`` the accumulated lane (gradient accumulation
    that carries every extension along: the batch in slices of at most
    that many samples, the identical step); a ``mesh`` raises (the sharded
    lane is not ported yet).
    """
    cfg = cfg or ExtensionConfig()
    ext_names = {e.name for e in extensions}
    curv_name = next((n for n in _CURVATURES if n in ext_names), None)

    def step(params, opt_state, batch, step_idx, rng=None):
        n = tree_leaves(batch["inputs"])[0].shape[0]
        plan = eng.plan_for_batch(extensions, cfg, n, mesh=mesh, shard_axes=shard_axes,
                                  microbatch_size=cfg.microbatch_size)
        res = plan.run(model, params, batch["inputs"], batch["labels"], loss,
                       cfg=cfg, rng=rng)
        kw = {"curv": res.ext[curv_name]} if curv_name is not None else {}
        ups, new_opt = opt.update(res.grads, opt_state, params, **kw)
        metrics = {"loss": res.loss, "step": step_idx + 1}
        for name in track:
            leaves = tree_leaves(res.ext.get(name))
            if leaves:
                metrics[f"{name}_mean"] = sum(l.float().mean() for l in leaves) / len(leaves)
        return apply_updates(params, ups), new_opt, metrics

    return step


def make_prefill_step(model):
    """``prefill(params, inputs)``: the full-sequence forward, the logits of
    the last position [N, V]."""
    def prefill(params, inputs):
        z = model.call(params, inputs)
        return z[:, -1, :]

    return prefill


def make_decode_step(model):
    """``decode(params, caches, tokens, pos)``: one token a sequence through
    ``model.serve_step`` → (logits [N, V], caches)."""
    def decode(params, caches, tokens, pos):
        return model.serve_step(params, caches, tokens, pos)

    return decode
