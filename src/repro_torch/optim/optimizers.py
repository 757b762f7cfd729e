"""Self-contained first-order optimizers ((init, update) pairs, as optax).

Port of ``src/repro/optim/optimizers.py``.  Parameters, gradients, updates
and states are pytrees of tensors (:mod:`repro_torch.core.tree`); an update
makes new tensors and leaves its inputs as they are, as in JAX.

Buffers (non-trainable leaves in the params tree) are frozen: any leaf whose
path holds a key ending in ``_buf``, or whose dtype is not floating, gets a
zero update.  Each update leaf is cast to its parameter's dtype as it is
made, so a step holds one leaf's float32 update at a time, not a float32
copy of every parameter.
"""
from __future__ import annotations

from typing import Any, Callable, NamedTuple

import torch

from repro_torch.core.tree import tree_map, tree_map_with_path


class Optimizer(NamedTuple):
    init: Callable[[Any], Any]
    update: Callable[..., Any]  # (grads, state, params) -> (updates, state)


def _is_buffer_path(path) -> bool:
    return any(isinstance(k, str) and k.endswith("_buf") for k in path)


def _finish(path, u, p):
    """The update leaf ``u`` of parameter ``p`` in ``p``'s dtype; a buffer's is 0."""
    if _is_buffer_path(path) or not p.dtype.is_floating_point:
        return torch.zeros_like(p)
    return u.to(p.dtype)


def _leafwise(fn, params, *trees):
    """``fn(*leaves, p)`` finished (``_finish``) leaf by leaf."""
    return tree_map_with_path(lambda path, p, *xs: _finish(path, fn(*xs, p), p),
                              params, *trees)


def apply_updates(params, updates):
    return tree_map(lambda p, u: p + u.to(p.dtype), params, updates)


def _zeros_f32(p):
    return torch.zeros(p.shape, dtype=torch.float32, device=p.device)


def sgd(lr):
    def init(params):
        return ()

    def update(grads, state, params, **kw):
        return _leafwise(lambda g, p: -lr * g.float(), params, grads), state

    return Optimizer(init, update)


def momentum_sgd(lr, rho=0.9):
    def init(params):
        return tree_map(_zeros_f32, params)

    def update(grads, state, params, **kw):
        new_m = tree_map(lambda m, g: rho * m + g.float(), state, grads)
        return _leafwise(lambda m, p: -lr * m, params, new_m), new_m

    return Optimizer(init, update)


def adamw(lr, b1=0.9, b2=0.999, eps=1e-8, weight_decay=0.0):
    def init(params):
        return {"m": tree_map(_zeros_f32, params),
                "v": tree_map(_zeros_f32, params), "t": 0}

    def update(grads, state, params, lr_scale=1.0, **kw):
        t = state["t"] + 1
        b1t, b2t = 1 - b1 ** t, 1 - b2 ** t
        m = tree_map(lambda m_, g: b1 * m_ + (1 - b1) * g.float(), state["m"], grads)
        v = tree_map(lambda v_, g: b2 * v_ + (1 - b2) * g.float().square(),
                     state["v"], grads)

        def upd(m_, v_, p):
            return -lr * lr_scale * ((m_ / b1t) / ((v_ / b2t).sqrt() + eps)
                                     + weight_decay * p.float())

        return _leafwise(upd, params, m, v), {"m": m, "v": v, "t": t}

    return Optimizer(init, update)
