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

Inputs, outputs and cotangents may be trees of tensors, as JAX's pytrees
(Whisper's ``DecBlock`` takes and returns the tuple (y, enc)).  A child
that records a graph of its own (a ``Wired`` block or a ``ScanStack`` of
them, as in ``WhisperModel``) returns outputs that this graph does not
connect to the child's input: such an *opaque* child is crossed by its own
sweep, the children called after it first, so every child's sweep runs
once and the cotangents of what feeds it include what flows back through
it.
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


def _tracked(tree):
    return [t for t in tree_leaves(tree) if isinstance(t, torch.Tensor) and t.requires_grad]


def _cuts_graph(xin, y):
    """Whether a child's ``forward_tape`` returned outputs that autograd does
    not connect to its tracked inputs: a child that records its own graph (a
    ``Wired`` block, a ``ScanStack`` of them)."""
    return bool(_tracked(xin)) and not _tracked(y)


def _stack_rows(rows):
    return tree_map(lambda *ts: torch.stack(ts), *rows)


def _unstack_rows(tree, c):
    return [tree_map(lambda t: t[i], tree) for i in range(c)]


class _Recorded:
    """The graph of one ``wire`` run: its output ``y`` (a tree), the input
    leaves and the children's outputs it is differentiated with respect to.

    ``opaque`` lists, in call order, the children whose outputs the graph
    does not connect to their inputs (``_cuts_graph``) with the input each
    was given.  A cotangent crosses such a child through the child's own
    sweep (``through``): the children called after it are pulled back
    first, then its output cotangent goes through it and its input
    cotangent back into the graph, so each child's sweep runs once."""

    def __init__(self, y, x, outs, opaque=()):
        self.y, self.x, self.outs, self.opaque = y, x, outs, list(opaque)
        self.x_leaves = [t for t in tree_leaves(x) if t.requires_grad]
        self.names = sorted(outs)
        self.out_leaves = [tree_leaves(outs[n]) for n in self.names]
        self.inputs = self.x_leaves + [t for ls in self.out_leaves for t in ls]
        opaque_names = {n for n, _ in self.opaque}
        self.cut_inputs = self.x_leaves + [t for n, ls in zip(self.names, self.out_leaves)
                                           if n in opaque_names for t in ls]

    @staticmethod
    def _grad(outputs, g, inputs):
        """autograd's cotangents of ``inputs`` (None where unused) for the
        tree ``outputs`` given the cotangent tree ``g``."""
        ys, gs = [], []

        def pair(t, gi):
            if gi is not None and t.requires_grad:
                ys.append(t)
                gs.append(gi.to(t.dtype))

        tree_map(pair, outputs, g)
        if not ys:
            return [None] * len(inputs)
        return list(torch.autograd.grad(ys, inputs, gs, retain_graph=True, allow_unused=True))

    def pullback(self, rows, with_outs=True, through=None):
        """(g_x, {child: cotangent of its output}) for each output cotangent
        tree of ``rows``.  ``through(name, rows)`` takes an opaque child's
        output cotangents (a list, one a row) and returns its input
        cotangents."""
        inputs = self.inputs if with_outs else self.cut_inputs
        if not inputs:
            return [None] * len(rows), [{} for _ in rows]
        acc = [self._grad(self.y, g, inputs) for g in rows]
        index = {id(t): i for i, t in enumerate(inputs)}
        for name, xin in reversed(self.opaque):
            leaves = tree_leaves(self.outs[name])
            g_out = [tree_unflatten(self.outs[name], [
                torch.zeros_like(t) if a[index[id(t)]] is None else a[index[id(t)]]
                for t in leaves]) for a in acc]
            for r, g_in in enumerate(through(name, g_out)):
                for i, c in enumerate(self._grad(xin, g_in, inputs)):
                    if c is not None:
                        acc[r][i] = c if acc[r][i] is None else acc[r][i] + c
        nx = len(self.x_leaves)
        out_x, out_outs = [], []
        for a in acc:
            gs = [torch.zeros_like(t) if gi is None else gi for t, gi in zip(inputs, a)]
            out_x.append(self._x_tree(gs[:nx]))
            rest, g_outs = gs[nx:], {}
            if with_outs:
                for name, leaves in zip(self.names, self.out_leaves):
                    g_outs[name] = tree_unflatten(self.outs[name], rest[:len(leaves)])
                    rest = rest[len(leaves):]
            out_outs.append(g_outs)
        return out_x, out_outs

    def vjp(self, g, with_outs=True, through=None):
        """(g_x, {child: cotangent of its output}) for the output cotangent g."""
        g_x, g_outs = self.pullback([g], with_outs, through)
        return g_x[0], g_outs[0]

    def _x_tree(self, gx_leaves):
        """The input cotangent in x's structure (None at integer leaves), or
        None where no input leaf is floating point."""
        if not self.x_leaves:
            return None
        it = iter(gx_leaves)
        return tree_map(lambda t: next(it) if t.requires_grad else None, self.x)

    def vjp_rows(self, S, with_outs=True, through=None):
        """:meth:`vjp` of each row of the tree S (leaves [C, ...]), stacked on
        a leading C axis."""
        rows = _unstack_rows(S, tree_leaves(S)[0].shape[0])
        g_xs, g_outs = self.pullback(rows, with_outs, through)
        g_x = (None if g_xs[0] is None else
               tree_map(lambda *ts: None if ts[0] is None else torch.stack(ts), *g_xs))
        return g_x, {n: _stack_rows([r[n] for r in g_outs]) for n in g_outs[0]}


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
        tapes, outs, opaque = {}, {}, []

        def call(name, xin):
            y, t = self.children_map[name].forward_tape(params[name], xin)
            tapes[name] = tree_map(lambda a: a.detach() if isinstance(a, torch.Tensor) else a, t)
            if _cuts_graph(xin, y):
                opaque.append((name, xin))
            y = tree_map(_on_graph, y)
            outs[name] = y
            return y

        with torch.enable_grad():
            xg = tree_map(_grad_leaf, x)
            y = self.wire(call, params, xg)
        for n in self.children_map:
            tapes.setdefault(n, ())
        return tree_map(torch.Tensor.detach, y), (tapes, _Recorded(y, xg, outs, opaque))

    def backward(self, params, tape, g, exts, cfg):
        tapes, rec = tape
        done = {}  # the opaque children's (grads, stats), from inside the pullback

        def through(name, rows):
            g_in, *done[name] = self.children_map[name].backward(
                params[name], tapes[name], rows[0], exts, cfg)
            return [g_in]

        g_x, g_outs = rec.vjp(g, through=through)
        grads, stats = {}, {}
        for name, child in self.children_map.items():
            if name in done:
                grads[name], st = done[name]
            elif name in g_outs:
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
        tapes, rec = tape

        def through(name, rows):
            return _unstack_rows(self.children_map[name].jac_t_mat(
                params[name], tapes[name], _stack_rows(rows)), len(rows))

        return rec.vjp_rows(M, with_outs=False, through=through)[0]

    def curv_backward(self, params, tape, S, exts, cfg, ext_prefix):
        tapes, rec = tape
        done = {}

        def through(name, rows):
            S_in, done[name] = self.children_map[name].curv_backward(
                params[name], tapes[name], _stack_rows(rows), exts, cfg, ext_prefix)
            return _unstack_rows(S_in, len(rows))

        S_x, S_outs = rec.vjp_rows(S, through=through)
        curv = {}
        for name, child in self.children_map.items():
            cv = done.get(name, {})
            if name not in done and name in S_outs:
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
