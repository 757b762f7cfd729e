"""Weight bridge: parameters of the JAX package in and out as numpy.

Both packages keep one parameter layout (Dense ``w`` ``[d_in, d_out]``,
Conv2d ``w`` ``[kh·kw·C_in, C_out]``, the params tree of ``Sequential.init``),
so a JAX model's parameters, turned into numpy arrays, copy straight into the
port's modules, each leaf in the port parameter's own dtype (a bfloat16
model's weights cross as they are: bfloat16 → float32 → bfloat16 is exact).
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.module import Module, resolve_device
from repro_torch.core.tree import tree_leaves, tree_map, tree_structure


def params_from_numpy(model: Module, np_params, device="cuda"):
    """Copy a tree of numpy arrays (the JAX params, e.g. through
    ``jax.tree.map(np.asarray, params)``) into ``model`` on ``device`` and
    return ``model.params()``."""
    device = resolve_device(device)
    model.to(device)
    params = model.params()
    if tree_structure(params) != tree_structure(np_params):
        raise ValueError("parameter trees differ: the model has "
                         f"{tree_structure(params)}, the arrays {tree_structure(np_params)}")
    for p, a in zip(tree_leaves(params), tree_leaves(np_params)):
        # float32 first: numpy has no bfloat16 of its own, and JAX's
        # (ml_dtypes) converts exactly; then the parameter's own dtype.
        a = np.asarray(a, np.float32)
        if tuple(p.shape) != a.shape:
            raise ValueError(f"parameter of shape {tuple(p.shape)} given an array "
                             f"of shape {a.shape}")
        p.data.copy_(torch.tensor(a).to(p.dtype))
    return model.params()


def params_to_numpy(params):
    """The inverse: a params tree of tensors as a tree of numpy arrays
    (float32 for bfloat16 leaves, which numpy cannot hold)."""
    def leaf(p):
        p = p.detach().cpu()
        return (p.float() if p.dtype == torch.bfloat16 else p).numpy()

    return tree_map(leaf, params)
