"""Forward-over-reverse curvature-vector products.

The GGN-vector product is the half-sandwich contraction

    G v = Jᵀ H (J v)

evaluated matrix-free: ``torch.func.jvp`` through ``model.call`` gives
``J v`` (forward mode), the exact loss Hessian applies in logit space via
``loss.hessian_vec`` (closed form, :mod:`repro_torch.core.loss_hessian`),
and ``torch.func.vjp`` over the same function carries it back to parameter
space (JAX transposes its linearization; the vjp is that transpose).  Cost
is ~2 gradient evaluations per product, memory O(P): no factor is ever
materialized.

The Hessian-vector product is plain forward-over-reverse through the scalar
objective: ``H v = ∂/∂ε ∇L(θ + εv)|₀``, ``torch.func.jvp`` of
``torch.func.grad``.

``microbatch_size`` streams a product over batch slices (the last may be
smaller), each slice's loss corrected from 1/M_local to 1/M_global by the
mask-aware ``_ScaledLoss`` adapter: products are linear in the loss, so the
corrected contributions sum to the monolithic value.  Port of
``src/repro/curv/products.py``; ``mesh`` (the sharded lane) raises,
ROADMAP queue A item 12.
"""
from __future__ import annotations

from typing import Optional, Sequence

import torch

from repro_torch.core.engine import _ScaledLoss, refuse_mesh
from repro_torch.core.extensions import ExtensionConfig
from repro_torch.core.tree import tree_leaves, tree_map, tree_unflatten


def _slice_bounds(n: int, microbatch: Optional[int]):
    """(offset, rows) schedule over ``n`` samples, uneven final slice allowed."""
    if not microbatch or microbatch >= n:
        return [(0, n)]
    return [(o, min(microbatch, n - o)) for o in range(0, n, microbatch)]


def _take_rows(tree, off, rows):
    return tree_map(lambda a: a[off:off + rows], tree)


def _primals(params):
    """The parameters as plain tensors: ``torch.func`` differentiates with
    respect to its inputs, and the modules' ``nn.Parameter``\\ s are frozen."""
    return tree_map(lambda p: p.detach(), params)


def _like(primals, v):
    """``v`` in the structure of ``primals``, dict keys in their order:
    ``torch.func`` tells trees apart by key order (an engine's gradient and a
    module's parameters may list a block's keys in different orders)."""
    return tree_unflatten(primals, tree_leaves(v))


def _ggn_vp_block(model, params, inputs, targets, loss, v):
    """One block's product: J v forward, the loss Hessian, Jᵀ back."""
    def f(p):
        return model.call(p, inputs)

    primals = _primals(params)
    z, Jv = torch.func.jvp(f, (primals,), (_like(primals, v),))
    Hv = loss.hessian_vec(z, targets, Jv)
    _, vjp_fn = torch.func.vjp(f, primals)
    (out,) = vjp_fn(Hv.to(z.dtype))
    return out


def _hvp_block(model, params, inputs, targets, loss, v):
    def obj(p):
        return loss.value(model.call(p, inputs), targets)

    primals = _primals(params)
    return torch.func.jvp(torch.func.grad(obj), (primals,), (_like(primals, v),))[1]


def _streamed(block_fn, model, params, inputs, targets, loss, v, microbatch):
    """Sum the per-slice contributions under the 1/M_global correction."""
    n = tree_leaves(inputs)[0].shape[0]
    bounds = _slice_bounds(n, microbatch)
    if len(bounds) == 1:
        return block_fn(model, params, inputs, targets, loss, v)
    sloss = _ScaledLoss(loss, total_units=loss.num_units(targets))
    out = None
    for off, rows in bounds:
        o = block_fn(model, params, _take_rows(inputs, off, rows),
                     _take_rows(targets, off, rows), sloss, v)
        out = o if out is None else tree_map(torch.add, out, o)
    return out


def _product(block_fn, model, params, inputs, targets, loss, v, *,
             cfg: Optional[ExtensionConfig] = None, mesh=None,
             shard_axes: Sequence[str] = ("data",)):
    refuse_mesh("curvature-vector product", mesh, shard_axes)
    cfg = cfg or ExtensionConfig()
    return _streamed(block_fn, model, params, inputs, targets, loss, v, cfg.microbatch_size)


def ggn_vp(model, params, inputs, targets, loss, v, *, cfg=None, mesh=None,
           shard_axes=("data",)):
    """Matrix-free GGN-vector product ``(Jᵀ H J) v`` of the mean loss.

    ``v`` is a params-shaped tangent tree; the result has the same
    structure.  ``cfg=ExtensionConfig(microbatch_size=k)`` streams the
    contraction over batch slices, exactly (the ``_ScaledLoss`` correction).
    """
    return _product(_ggn_vp_block, model, params, inputs, targets, loss, v,
                    cfg=cfg, mesh=mesh, shard_axes=shard_axes)


def hvp(model, params, inputs, targets, loss, v, *, cfg=None, mesh=None,
        shard_axes=("data",)):
    """Matrix-free Hessian-vector product ``∇²L(θ) v`` of the mean loss
    (forward-over-reverse: jvp of the gradient).  Same knobs as
    :func:`ggn_vp`."""
    return _product(_hvp_block, model, params, inputs, targets, loss, v,
                    cfg=cfg, mesh=mesh, shard_axes=shard_axes)


class _CurvOperator:
    """A curvature matrix as a linear operator on params-shaped trees.

    ``mv`` applies ``(C + damping·I) v``; ``mv_stacked`` maps it over a
    leading right-hand-side axis on every leaf (the batched-CG caller) with
    ``torch.func.vmap``, as JAX vmaps it: one batched product, not one
    product a right-hand side.  An instance closes over one batch.
    """

    _block = None  # subclass hook

    def __init__(self, model, params, inputs, targets, loss, *,
                 damping: float = 0.0, cfg: Optional[ExtensionConfig] = None,
                 mesh=None, shard_axes: Sequence[str] = ("data",)):
        refuse_mesh(type(self).__name__, mesh, shard_axes)
        self.model = model
        self.params = params
        self.inputs = inputs
        self.targets = targets
        self.loss = loss
        self.damping = damping
        self.cfg = cfg

    def mv(self, v):
        out = _product(type(self)._block, self.model, self.params, self.inputs,
                       self.targets, self.loss, v, cfg=self.cfg)
        if self.damping:
            d = float(self.damping)
            out = tree_map(lambda o, t: o + d * t.to(o.dtype), out, v)
        return out

    def mv_stacked(self, V):
        return torch.func.vmap(self.mv)(V)

    @property
    def dim(self) -> int:
        """Number of parameters the operator acts on."""
        return sum(leaf.numel() for leaf in tree_leaves(self.params))


class GGNOperator(_CurvOperator):
    """``(G + damping·I)`` with ``G`` the GGN of the mean loss."""

    _block = staticmethod(_ggn_vp_block)


class HessianOperator(_CurvOperator):
    """``(H + damping·I)`` with ``H`` the full Hessian of the mean loss."""

    _block = staticmethod(_hvp_block)
