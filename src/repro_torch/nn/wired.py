"""Wired — modules with a dict of children and free dataflow between them.

Port of ``src/repro/nn/wired.py``.  A ``Wired`` module owns a dict of
*children* (Dense / Embedding / norms / Param, the parameter holders) and a
``wire(call, params, x)`` function describing the dataflow between them
(attention mixing, SSM scans, residual adds: any tensor code).  Its params
are a dict keyed by the child names, sorted, as JAX's ``init`` builds it.

Backward strategy.  The sweeps need, for each child, the cotangent of the
loss with respect to that child's output: its hand-written ``backward`` /
``curv_backward`` then produce the gradients and every statistic, with no
per-architecture derivation.  JAX adds a zero "tap" to each child output,
re-runs ``wire`` in every sweep and takes ``jax.vjp`` with respect to
``(x, taps)``; XLA removes the duplicate forward inside one ``jit``.
PyTorch has no such elimination, so the port records the wiring once:
``forward_tape`` runs ``wire`` with autograd on (from an input that
requires grad; a child output that does not depend on it, such as an
Embedding's or a Param's, is made a leaf that does) and keeps the graph in
the tape.  ``backward``, ``jac_t_mat`` and every ``curv_backward`` then call
``torch.autograd.grad(..., retain_graph=True)`` on it, with respect to the
input and the children's outputs: the forward runs once a ``run`` and each
sweep once through the graph.  A factor ``S [C, ...]`` goes through the
graph one column at a time (a loop over C): ``torch.func.vmap`` cannot batch
a graph that holds the card's attention and WKV kernels, whose backward is
an ``autograd.Function`` (:mod:`repro_torch.kernels.ops`).  C is 1 in the MC
sweep and ``cfg.class_chunk`` in the exact sweep.
"""
from __future__ import annotations

from typing import Dict

import torch
from torch import nn

from repro_torch.core.module import Module
from repro_torch.core.tree import tree_leaves, tree_map, tree_unflatten


def _grad_leaf(x):
    """x detached, requiring grad where it is floating point."""
    x = x.detach()
    return x.requires_grad_(True) if x.is_floating_point() else x


def _on_graph(y):
    """y itself where autograd tracks it, else a leaf copy that requires grad."""
    return y if y.requires_grad else y.detach().requires_grad_(True)


class _Recorded:
    """The graph of one ``wire`` run: its output ``y``, the input leaves and
    the children's outputs it is differentiated with respect to."""

    def __init__(self, y, x, outs):
        self.y, self.x, self.outs = y, x, outs
        self.x_leaves = [t for t in tree_leaves(x) if t.requires_grad]
        self.names = sorted(outs)
        self.out_leaves = [tree_leaves(outs[n]) for n in self.names]
        self.inputs = self.x_leaves + [t for ls in self.out_leaves for t in ls]

    def vjp(self, g, with_outs=True):
        """(g_x, {child: cotangent of its output}) for the output cotangent g."""
        inputs = self.inputs if with_outs else self.x_leaves
        if not inputs:
            return None, {}
        gs = torch.autograd.grad(self.y, inputs, g.to(self.y.dtype), retain_graph=True,
                                 allow_unused=True)
        gs = [torch.zeros_like(t) if gi is None else gi for t, gi in zip(inputs, gs)]
        nx = len(self.x_leaves)
        g_x = self._x_tree(gs[:nx])
        if not with_outs:
            return g_x, {}
        rest, g_outs = gs[nx:], {}
        for name, leaves in zip(self.names, self.out_leaves):
            g_outs[name] = tree_unflatten(self.outs[name], rest[:len(leaves)])
            rest = rest[len(leaves):]
        return g_x, g_outs

    def _x_tree(self, gx_leaves):
        """The input cotangent in x's structure (None at integer leaves), or
        None where no input leaf is floating point."""
        if not self.x_leaves:
            return None
        it = iter(gx_leaves)
        return tree_map(lambda t: next(it) if t.requires_grad else None, self.x)

    def vjp_rows(self, S, with_outs=True):
        """:meth:`vjp` of each row of S [C, ...], stacked on a leading C axis."""
        rows = [self.vjp(S[c], with_outs) for c in range(S.shape[0])]
        g_x = (None if rows[0][0] is None else
               tree_map(lambda *ts: None if ts[0] is None else torch.stack(ts),
                        *[r[0] for r in rows]))
        g_outs = {n: tree_map(lambda *ts: torch.stack(ts), *[r[1][n] for r in rows])
                  for n in rows[0][1]}
        return g_x, g_outs


class Wired(Module):
    """Subclasses call :meth:`set_children` and implement ``wire``."""

    def set_children(self, children: Dict[str, Module]) -> None:
        self.children_map = nn.ModuleDict(children)

    def wire(self, call, params, x):
        raise NotImplementedError

    # optional decode-time wiring; ``call_step(name, x)`` applies a child
    def wire_step(self, call_step, params, x, cache):
        raise NotImplementedError(f"{type(self).__name__} has no decode path")

    def params(self):
        return {n: self.children_map[n].params() for n in sorted(self.children_map)}

    def call(self, params, x):
        def call(name, xin):
            return self.children_map[name].call(params[name], xin)

        return self.wire(call, params, x)

    # -- the sweeps ---------------------------------------------------------------
    def forward_tape(self, params, x):
        """Run ``wire`` once, recording its graph; the tape is (child tapes,
        the recorded graph)."""
        tapes, outs = {}, {}

        def call(name, xin):
            y, t = self.children_map[name].forward_tape(params[name], xin)
            tapes[name] = tree_map(lambda a: a.detach() if isinstance(a, torch.Tensor) else a, t)
            y = tree_map(_on_graph, y)
            outs[name] = y
            return y

        with torch.enable_grad():
            xg = tree_map(_grad_leaf, x)
            y = self.wire(call, params, xg)
        for n in self.children_map:
            tapes.setdefault(n, ())
        return y.detach(), (tapes, _Recorded(y, xg, outs))

    def backward(self, params, tape, g, exts, cfg):
        tapes, rec = tape
        g_x, g_outs = rec.vjp(g)
        grads, stats = {}, {}
        for name, child in self.children_map.items():
            if name in g_outs:
                _, grads[name], st = child.backward(params[name], tapes[name], g_outs[name],
                                                    exts, cfg)
            else:  # a child the wiring does not reach (a static config branch)
                grads[name] = tree_map(torch.zeros_like, params[name])
                st = {}
            for k, v in st.items():
                stats.setdefault(k, {})[name] = v
        # keep each extension's stat tree aligned with the params dict
        for k in stats:
            for name in self.children_map:
                stats[k].setdefault(name, ())
        return g_x, grads, stats

    def jac_t_mat(self, params, tape, M):
        return tape[1].vjp_rows(M, with_outs=False)[0]

    def curv_backward(self, params, tape, S, exts, cfg, ext_prefix):
        tapes, rec = tape
        S_x, S_outs = rec.vjp_rows(S)
        curv = {}
        for name, child in self.children_map.items():
            cv = {}
            if name in S_outs:
                _, cv = child.curv_backward(params[name], tapes[name], S_outs[name], exts, cfg,
                                            ext_prefix)
            for k, v in cv.items():
                curv.setdefault(k, {})[name] = v
        for k in curv:
            for name in self.children_map:
                curv[k].setdefault(name, ())
        return S_x, curv

    # -- serving ----------------------------------------------------------------
    def decode_step(self, params, x, cache):
        def call_step(name, xin):
            return self.children_map[name].call(params[name], xin)

        return self.wire_step(call_step, params, x, cache)
