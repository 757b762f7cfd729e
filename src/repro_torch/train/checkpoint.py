"""npz checkpoints: atomic, keep-k, checked on restore.

Layout: ``<dir>/step_<n>/arrays.npz`` + ``manifest.json``, written into a
``.tmp_save_*`` directory and renamed into place, so a crashed save never
shadows a good checkpoint.  Tensors go to numpy on save (from whatever device
they lie on) and come back as CPU tensors of the target's dtype; the caller
moves them to its device (``SweepStream.load_state`` does).

Port of ``src/repro/train/checkpoint.py``.  The tree structure is recorded in
the manifest as JSON (dict keys sorted, as
:func:`~repro_torch.core.tree.tree_leaves` orders the leaves) and checked on
restore, with every leaf's shape.  :mod:`repro_torch.obs` records JAX's
``ckpt/save`` (``bytes``, the saved arrays' sum, and ``arrays``) with its
``ckpt/gc`` child, ``ckpt/restore`` (``bytes`` of the file), ``ckpt.saves``
and ``ckpt.restores``.
"""
from __future__ import annotations

import json
import os
import shutil
import tempfile

import numpy as np
import torch

from repro_torch import obs
from repro_torch.core.tree import tree_leaves, tree_unflatten


def _treedef(tree):
    """The structure of ``tree`` as JSON: objects for dicts, ``["tuple",
    ...]`` / ``["list", ...]`` for sequences, null for None, ``"*"`` for a
    leaf."""
    if isinstance(tree, dict):
        return {k: _treedef(tree[k]) for k in sorted(tree)}
    if isinstance(tree, (tuple, list)):
        return [type(tree).__name__] + [_treedef(c) for c in tree]
    return None if tree is None else "*"


def _saved_tree(node):
    """The tree a :func:`_treedef` describes, with ``"*"`` leaves."""
    if isinstance(node, dict):
        return {k: _saved_tree(v) for k, v in node.items()}
    if isinstance(node, list):
        return {"tuple": tuple, "list": list}[node[0]](_saved_tree(c) for c in node[1:])
    return node


def _leaf_paths(tree, path=""):
    """Each leaf's path, ``['params']['b']`` style, in :func:`tree_leaves`
    order."""
    if isinstance(tree, dict):
        return [p for k in sorted(tree) for p in _leaf_paths(tree[k], f"{path}[{k!r}]")]
    if isinstance(tree, (tuple, list)):
        return [p for i, c in enumerate(tree) for p in _leaf_paths(c, f"{path}[{i}]")]
    if tree is None:
        return []
    return [path]


def _to_numpy(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu()
        if x.dtype == torch.bfloat16:  # numpy has no bfloat16; widened exactly
            x = x.float()
        return x.numpy()
    return np.asarray(x)


def save(path, step, params, opt_state=None, extra=None, keep=3):
    """Write ``{'params': params[, 'opt': opt_state]}`` as ``step_<step>``
    and keep the newest ``keep`` (at least 1) checkpoints."""
    if keep < 1:
        # Fail before any disk work: a save always keeps what it writes.
        raise ValueError(f"keep must be >= 1 (got {keep}) — a save always "
                         "retains at least the checkpoint it just wrote")
    os.makedirs(path, exist_ok=True)
    state = {"params": params}
    if opt_state is not None:
        state["opt"] = opt_state
    flat = tree_leaves(state)
    tmp = tempfile.mkdtemp(dir=path, prefix=".tmp_save_")
    with obs.span("ckpt/save", step=int(step)) as sp:
        try:
            arrays = {f"a{i}": _to_numpy(x) for i, x in enumerate(flat)}
            sp.set(bytes=sum(int(a.nbytes) for a in arrays.values()), arrays=len(arrays))
            np.savez(os.path.join(tmp, "arrays.npz"), **arrays)
            manifest = {"step": int(step), "n_arrays": len(flat),
                        "treedef": _treedef(state), "extra": extra or {}}
            with open(os.path.join(tmp, "manifest.json"), "w") as f:
                json.dump(manifest, f)
            final = os.path.join(path, f"step_{int(step):08d}")
            if os.path.exists(final):
                shutil.rmtree(final)
            os.rename(tmp, final)
        except Exception:
            shutil.rmtree(tmp, ignore_errors=True)
            raise
        with obs.span("ckpt/gc", keep=int(keep)):
            _gc(path, keep)
    obs.count("ckpt.saves")
    return final


def _gc(path, keep):
    """Prune to the newest ``keep`` checkpoints and sweep crash debris.

    ``keep`` must be at least 1 (``steps[:-0]`` would keep everything).
    Stale ``.tmp_save_*`` directories, left by a process killed between
    ``mkdtemp`` and the rename, are removed too: any still present when a
    later save collects is an orphan (that save renamed its own away)."""
    if keep < 1:
        raise ValueError(f"keep must be >= 1 (got {keep})")
    steps = sorted(d for d in os.listdir(path)
                   if d.startswith("step_") and os.path.isdir(os.path.join(path, d)))
    for d in steps[:-keep]:
        shutil.rmtree(os.path.join(path, d), ignore_errors=True)
    for d in os.listdir(path):
        if d.startswith(".tmp_save_") and os.path.isdir(os.path.join(path, d)):
            shutil.rmtree(os.path.join(path, d), ignore_errors=True)


def latest_step(path):
    """The newest complete checkpoint's step, or None."""
    if not os.path.isdir(path):
        return None
    steps = sorted(int(d.split("_")[1]) for d in os.listdir(path)
                   if d.startswith("step_")
                   and os.path.exists(os.path.join(path, d, "manifest.json")))
    return steps[-1] if steps else None


def _like(arr: np.ndarray, like):
    """``arr`` as ``like`` holds it: a CPU tensor of its dtype, or a numpy
    array of its dtype; a CPU tensor as saved where ``like`` is the
    checkpoint's own leaf (``"*"``)."""
    if isinstance(like, str):
        return torch.from_numpy(np.array(arr))
    if isinstance(like, torch.Tensor):
        return torch.from_numpy(np.array(arr)).to(like.dtype)
    if hasattr(like, "dtype"):
        return arr.astype(like.dtype)
    return arr


def _grown(like, saved):
    """``like`` with each None where ``saved`` (a :func:`_saved_tree`)
    holds a subtree replaced by that subtree: state that a step grows from
    None (a running average's first statistics) restores into the saved
    structure; everything else stays the target's."""
    if like is None:
        return saved
    if isinstance(like, dict) and isinstance(saved, dict):
        return {k: _grown(v, saved.get(k)) for k, v in like.items()}
    if isinstance(like, (tuple, list)) and isinstance(saved, (tuple, list)) \
            and len(like) == len(saved):
        return type(like)(_grown(a, b) for a, b in zip(like, saved))
    return like


def restore(path, step, params_like, opt_like=None):
    """Load ``step_<step>`` into the structure of ``params_like`` /
    ``opt_like``: ``(params[, opt], manifest)``.  The recorded structure and
    every leaf's shape must match the target's; the first mismatch raises.
    A None in ``opt_like`` where the checkpoint holds a subtree (a curvature
    optimizer's running average, None until its first step) takes the
    saved subtree, as CPU tensors."""
    d = os.path.join(path, f"step_{int(step):08d}")
    with obs.span("ckpt/restore", step=int(step),
                  bytes=os.path.getsize(os.path.join(d, "arrays.npz"))):
        obs.count("ckpt.restores")
        return _restore(d, step, params_like, opt_like)


def _restore(d, step, params_like, opt_like):
    with open(os.path.join(d, "manifest.json")) as f:
        manifest = json.load(f)
    state_like = {"params": params_like}
    if opt_like is not None:
        state_like["opt"] = _grown(opt_like, _saved_tree(manifest["treedef"]).get("opt"))
    flat_like = tree_leaves(state_like)
    if len(flat_like) != manifest["n_arrays"]:
        raise ValueError(
            f"checkpoint has {manifest['n_arrays']} arrays; target structure "
            f"expects {len(flat_like)} — config mismatch?")
    saved, target = manifest.get("treedef"), _treedef(state_like)
    if saved is not None and saved != target:
        raise ValueError(
            "checkpoint tree structure does not match the target "
            f"structure ({manifest['n_arrays']} leaves in both — config "
            f"mismatch?)\n  saved:  {json.dumps(saved)}\n  target: {json.dumps(target)}")
    paths = _leaf_paths(state_like)
    flat = []
    with np.load(os.path.join(d, "arrays.npz")) as data:
        for i, leaf in enumerate(flat_like):
            arr = data[f"a{i}"]
            want = tuple(getattr(leaf, "shape", arr.shape))
            if tuple(arr.shape) != want:
                raise ValueError(
                    f"checkpoint leaf {paths[i]!r} (array {i} of "
                    f"step_{int(step):08d}) has shape {tuple(arr.shape)}; the "
                    f"target structure expects {want} — first mismatching "
                    "leaf; was the model/optimizer config changed between "
                    "save and restore?")
            flat.append(_like(arr, leaf))
    state = tree_unflatten(state_like, flat)
    out = [state["params"], manifest]
    if opt_like is not None:
        out.insert(1, state["opt"])
    return tuple(out)


class SweepCheckpointer:
    """On-disk snapshot store of a checkpointed sweep stream.

    The interface ``AccumulatedSweepPlan.run_checkpointed`` drives:

    * ``save(cursor, state, meta)`` — a ``SweepStream.state_arrays()`` tree
      at work unit ``cursor``, with the stream's ``schedule_meta()`` in the
      manifest;
    * ``restore_latest(state_like) -> (cursor, state, meta) | None`` — the
      newest snapshot in the structure of ``state_like`` (None on a cold
      start).

    Snapshots use the ``step_<cursor>`` layout above: the atomic rename,
    keep-k, the sweep of stale tmp directories and the checks on restore.

    Parameters
    ----------
    path : str
        Snapshot directory (made at the first save).
    keep : int
        Newest snapshots kept (at least 1); 2 by default, so a corrupt last
        write still leaves one to resume from.
    """

    def __init__(self, path, keep: int = 2):
        if keep < 1:
            raise ValueError(f"keep must be >= 1 (got {keep})")
        self.path = str(path)
        self.keep = int(keep)

    def save(self, cursor, state, meta=None):
        return save(self.path, int(cursor), state, extra={"sweep": meta or {}},
                    keep=self.keep)

    def latest(self):
        """Newest snapshot cursor, or None."""
        return latest_step(self.path)

    def restore_latest(self, state_like):
        cursor = latest_step(self.path)
        if cursor is None:
            return None
        state, manifest = restore(self.path, cursor, state_like)
        return cursor, state, manifest.get("extra", {}).get("sweep", {})
