"""Wired — modules with a dict of children and free dataflow between them.

Port of ``src/repro/nn/wired.py`` (forward and decode).  A ``Wired`` module
owns a dict of *children* (Dense / Embedding / norms / Param, the parameter
holders) and a ``wire(call, params, x)`` function describing the dataflow
between them (attention mixing, SSM scans, residual adds: any tensor code).
Its params are a dict keyed by the child names, sorted, as JAX's ``init``
builds it.  The tap-VJP machinery (``_tap_vjp``, ``backward``,
``curv_backward``: BackPACK through a ``wire``) comes with BackPACK on
language models.
"""
from __future__ import annotations

from typing import Dict

from torch import nn

from repro_torch.core.module import Module


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

    # -- serving ----------------------------------------------------------------
    def decode_step(self, params, x, cache):
        def call_step(name, xin):
            return self.children_map[name].call(params[name], xin)

        return self.wire_step(call_step, params, x, cache)
