"""Weight bridge: parameters of the JAX package in and out as numpy.

Both packages keep one parameter layout (Dense ``w`` ``[d_in, d_out]``,
Conv2d ``w`` ``[kh·kw·C_in, C_out]``, the params tree of ``Sequential.init``),
so a JAX model's parameters, turned into numpy arrays, copy straight into the
port's modules.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.module import Module, resolve_device
from repro_torch.core.tree import tree_leaves, tree_map


def _structure(tree):
    return tree_map(lambda _: 0, tree)


def params_from_numpy(model: Module, np_params, device="cuda"):
    """Copy a tree of numpy arrays (the JAX params, e.g. through
    ``jax.tree.map(np.asarray, params)``) into ``model`` on ``device`` and
    return ``model.params()``."""
    device = resolve_device(device)
    model.to(device)
    params = model.params()
    if _structure(params) != _structure(np_params):
        raise ValueError("parameter trees differ: the model has "
                         f"{_structure(params)}, the arrays {_structure(np_params)}")
    for p, a in zip(tree_leaves(params), tree_leaves(np_params)):
        a = np.asarray(a)
        if tuple(p.shape) != a.shape:
            raise ValueError(f"parameter of shape {tuple(p.shape)} given an array "
                             f"of shape {a.shape}")
        p.data.copy_(torch.tensor(a, dtype=torch.float32))
    return model.params()


def params_to_numpy(params):
    """The inverse: a params tree of tensors as a tree of numpy arrays."""
    return tree_map(lambda p: p.detach().cpu().numpy(), params)
