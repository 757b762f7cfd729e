"""The Reducer protocol — how partial extension results combine.

Port of ``src/repro/core/reducers.py``.  Each :class:`Reducer` instance is one
combination rule, declared on an :class:`~repro_torch.core.extensions.Extension`
and driven by the accumulated sweep lane (``SweepPlan.accumulate``): a
weighted left fold over the slices of a batch::

    acc = reducer.init(zero_tree)
    acc = reducer.update(acc, partial, meta)   # meta = {'weight': rows, ...}
    out = reducer.finalize(acc, meta)          # meta carries the total counts

``merge(a, b)`` combines two accumulated partials; it is associative and,
unless ``commutative`` is False, order-invariant.  String names still
resolve, as deprecated aliases (:func:`resolve_reducer` warns).

Capability flags, what the lane dispatches on:

``supports_streaming``
    The accumulated lane can fold this reducer slice by slice; a reducer
    that needs the whole batch resident sets it False and is refused.
``local_rows``
    Outputs keep per-sample rows on axis 0 (``placement``).
``streams_rows``
    The lane writes this reducer's rows slice by slice into a buffer of the
    whole batch, in sample order, instead of carrying an accumulator.
``pairwise``
    Gram family: entries pair samples across slices, so the lane runs one
    extra pass per slice pair and scatters each block into an ``[n, n, ...]``
    buffer of zeros (disjoint blocks: the fold is an add).
``supports_checkpoint``
    The accumulator round-trips through ``serialize`` / ``deserialize`` as a
    tree of tensors, so a checkpointed sweep (``engine.SweepStream``) can
    snapshot and restore it.

The cross-device half of the protocol (``shard_reduce``) belongs to the
batch-sharded lane, ROADMAP queue A item 12, and is not ported yet.
"""
from __future__ import annotations

import functools
import warnings
from typing import Any, Dict

import torch

from .tree import tree_map


# ---------------------------------------------------------------------------
# shared tree helpers (also used by the engine)
# ---------------------------------------------------------------------------


def merge_stat_trees(model_stats, key):
    """Extract the ``stats[key]`` sub-tree from the nested per-module stats."""

    def rec(node):
        if isinstance(node, dict):
            # module-level stats dict keyed by extension name
            return node.get(key, ())
        if isinstance(node, (tuple, list)):
            return tuple(rec(c) for c in node)
        return ()

    return rec(model_stats)


def _tree_add(a, b):
    return tree_map(torch.add, a, b)


def _tree_axpy(w, x, y):
    """y + w·x leaf-wise (the weighted running-mean accumulator step)."""
    return tree_map(lambda xl, yl: yl + w * xl, x, y)


def _chan_merge(a, b):
    """Merge two (count, mean, M2) triples — Chan et al.'s pairwise update."""
    na, ma, m2a = a
    nb, mb, m2b = b
    n = na + nb
    d = mb - ma
    mean = ma + d * (nb / n)
    m2 = m2a + m2b + d * d * (na * nb / n)
    return n, mean, m2


def _is_moment_triple(x) -> bool:
    return isinstance(x, dict) and set(x) == {"n", "mean", "m2"}


def _map_triples(fn, tree, *rest):
    """``fn`` over the (count, mean, M2) triples of ``tree`` (and of the
    trees in ``rest``, walked in lockstep)."""
    if _is_moment_triple(tree):
        return fn(tree, *rest)
    if isinstance(tree, dict):
        return {k: _map_triples(fn, v, *(r[k] for r in rest)) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return tuple(_map_triples(fn, *z) for z in zip(tree, *rest))
    return tree


def _merge_moment_triples(acc, new):
    """Fold one partial batch's (count, mean, M2) triples into the running
    ones."""

    def merge(a, b):
        n, mean, m2 = _chan_merge((a["n"], a["mean"], a["m2"]),
                                  (b["n"], b["mean"], b["m2"]))
        return {"n": n, "mean": mean, "m2": m2}

    return _map_triples(merge, acc, new)


def _finalize_moment_triples(tree):
    """n·M2 — the engine's ``n·Σg² − (Σg)²`` variance convention."""
    return _map_triples(lambda t: t["n"] * t["m2"], tree)


def _kron_map(fn, tree, *rest):
    """Walk Kronecker stats trees applying ``fn(kind, leaf, *others)``:
    ``kind`` is ``'A'`` for A/``A_diag`` factors, ``'B'`` for B factors,
    ``None`` for stray tensor leaves.  Extra trees walk in lockstep."""

    def rec(node, *others):
        if isinstance(node, dict):
            out = {}
            for k, v in node.items():
                o = tuple(d[k] for d in others)
                if k in ("A", "A_diag"):
                    out[k] = tree_map(functools.partial(fn, "A"), v, *o)
                elif k == "B":
                    out[k] = tree_map(functools.partial(fn, "B"), v, *o)
                else:
                    out[k] = rec(v, *o)
            return out
        if isinstance(node, (tuple, list)):
            return tuple(rec(*z) for z in zip(node, *others))
        if isinstance(node, torch.Tensor):
            return fn(None, node, *others)
        return node

    return rec(tree, *rest)


def _is_kfra_partial(x) -> bool:
    """Marker of KFRA's streamed emission: the loss Hessian's mean
    contribution and the per-layer chain partials."""
    return isinstance(x, dict) and set(x) == {"gbar", "partials"}


# ---------------------------------------------------------------------------
# the protocol
# ---------------------------------------------------------------------------


class Reducer:
    """How one extension's partial results combine across a split batch.

    The base class is ``'psum'`` (a sum of partial batch reductions);
    subclasses override what differs.  Instances are stateless singletons.
    """

    name = "psum"
    supports_streaming = True
    supports_checkpoint = True
    local_rows = False
    streams_rows = False
    pairwise = False
    commutative = True
    streaming_form = "running sum"

    @property
    def placement(self) -> str:
        """Where outputs over a split batch live: per-sample rows on axis 0,
        or one reduction."""
        return "sharded(axis0)" if self.local_rows else "replicated"

    # -- sequential (cross-slice) ------------------------------------------
    def init(self, zero):
        """Initial accumulator from a zeros-like of one partial emission."""
        return zero

    def update(self, acc, new, meta: Dict[str, Any]):
        """Fold one slice's emission into the accumulator; ``meta['weight']``
        is the slice's sample count."""
        return _tree_add(acc, new)

    def merge(self, a, b):
        """Combine two accumulated partials (associative; commutative
        unless ``commutative`` is False)."""
        return _tree_add(a, b)

    def finalize(self, acc, meta: Dict[str, Any]):
        """Accumulated partials → the monolithic statistic; ``meta`` carries
        ``total_batch`` / ``total_units`` (and, for reducers that replay
        model structure, the engine's callbacks)."""
        return acc

    # -- checkpointing -------------------------------------------------------
    def serialize(self, acc):
        """Accumulator → a tree of tensors for a snapshot.  The identity:
        every built-in accumulator already is one.  The serialized form
        keeps one tree structure and one set of leaf shapes over the whole
        sweep (the checkpoint layer checks both on restore)."""
        return acc

    def deserialize(self, payload):
        """Inverse of :meth:`serialize`: restored tensors → an accumulator
        ``update``/``merge``/``finalize`` can keep folding."""
        return payload


class PsumReducer(Reducer):
    """Sum of partial batch reductions (GGN/Hessian diagonals, moments)."""


class ConcatReducer(Reducer):
    """Per-sample rows, concatenated in sample order (not commutative)."""

    name = "concat"
    local_rows = True
    streams_rows = True
    commutative = False
    streaming_form = "row append"

    def update(self, acc, new, meta):
        return self.merge(acc, new)

    def merge(self, a, b):
        return tree_map(lambda x, y: torch.cat([x, y], 0), a, b)


class GramReducer(Reducer):
    """Pairwise per-sample statistics ([N, N] Gram blocks).

    Streamed: each slice's run gives its diagonal block, one extra pass per
    slice pair gives the off-diagonal blocks, and every block is scattered
    into an [N, N] buffer of zeros, so the fold adds matrices of disjoint
    blocks (associative, commutative)."""

    name = "gram"
    local_rows = True
    pairwise = True
    streaming_form = "row-block scatter (diag in-place, pairs streamed)"

    @staticmethod
    def transpose_block(x):
        """Off-diagonal block (p, q) → its mirror (q, p): the two sample
        axes swap, trailing axes (the class axis of ``ntk_classwise``)
        ride along."""
        return x.transpose(0, 1)


class GramPairReducer(GramReducer):
    """Gram blocks whose trailing axes are a column pair (``ggn_gram``'s
    ``[N, M, C̃, C̃]``): entry (n, m, c, c') mirrors to (m, n, c', c)."""

    name = "gram_pair"

    @staticmethod
    def transpose_block(x):
        return x.transpose(0, 1).transpose(2, 3)


class KronReducer(Reducer):
    """Kronecker factor pairs: A factors are batch means (a running
    sample-weighted mean), B factors batch sums (a running sum)."""

    name = "kron"
    streaming_form = "weighted A mean + B sum"

    def update(self, acc, new, meta):
        w = meta["weight"]

        def step(kind, n_leaf, a_leaf):
            if kind == "A":
                return a_leaf + w * n_leaf
            return a_leaf + n_leaf

        return _kron_map(step, new, acc)

    def merge(self, a, b):
        return _kron_map(lambda kind, x, y: x + y, a, b)

    def finalize(self, acc, meta):
        n_total = meta["total_batch"]
        return _kron_map(lambda kind, x: x / n_total if kind == "A" else x, acc)


class MomentMergeReducer(Reducer):
    """Mean and variance by the stable pairwise (Chan) moment merge: a
    sequential fold of (count, mean, M2) triples."""

    name = "moment_merge"
    streaming_form = "sequential Chan merge"

    def update(self, acc, new, meta):
        return self.merge(acc, new)

    def merge(self, a, b):
        return _merge_moment_triples(a, b)

    def finalize(self, acc, meta):
        return _finalize_moment_triples(acc)


class MeanReducer(Reducer):
    """Batch-averaged statistics (``'pmean'``): a sample-weighted running
    mean.

    KFRA's Ḡ recursion needs the whole batch's expectation at every layer,
    so its streamed emission is a ``{'gbar', 'partials'}`` pair: the loss
    Hessian's mean contribution (summed over slices) and the per-layer
    expectation partials (weighted means); ``finalize`` replays the
    recursion on them through the engine's ``meta['replay']``."""

    name = "pmean"
    streaming_form = "weighted partial means (+ chain replay for KFRA)"

    def update(self, acc, new, meta):
        w = meta["weight"]
        if _is_kfra_partial(new):
            return {"gbar": _tree_add(acc["gbar"], new["gbar"]),
                    "partials": _tree_axpy(w, new["partials"], acc["partials"])}
        return _tree_axpy(w, new, acc)

    def merge(self, a, b):
        return _tree_add(a, b)

    def finalize(self, acc, meta):
        n_total = meta["total_batch"]
        if _is_kfra_partial(acc):
            partials = tree_map(lambda x: x / n_total, acc["partials"])
            return meta["replay"](acc["gbar"], partials)
        return tree_map(lambda x: x / n_total, acc)


# ---------------------------------------------------------------------------
# registry + deprecated string aliases
# ---------------------------------------------------------------------------

PSUM = PsumReducer()
CONCAT = ConcatReducer()
GRAM = GramReducer()
GRAM_PAIR = GramPairReducer()
KRON = KronReducer()
MOMENT_MERGE = MomentMergeReducer()
PMEAN = MeanReducer()

REDUCERS: Dict[str, Reducer] = {}


def register_reducer(reducer: Reducer) -> Reducer:
    """Add a reducer to the registry (string aliases resolve through it)."""
    REDUCERS[reducer.name] = reducer
    return reducer


for _r in (PSUM, CONCAT, GRAM, GRAM_PAIR, KRON, MOMENT_MERGE, PMEAN):
    register_reducer(_r)


_ALIAS_REPLACEMENT = {
    "psum": "repro_torch.core.reducers.PSUM",
    "concat": "repro_torch.core.reducers.CONCAT",
    "gram": "repro_torch.core.reducers.GRAM",
    "kron": "repro_torch.core.reducers.KRON",
    "moment_merge": "repro_torch.core.reducers.MOMENT_MERGE",
    "pmean": "repro_torch.core.reducers.PMEAN",
}


def resolve_reducer(spec) -> Reducer:
    """Reducer instance for ``spec``: a :class:`Reducer` passes through; a
    registered string name resolves as a deprecated alias."""
    if isinstance(spec, Reducer):
        return spec
    if isinstance(spec, str):
        if spec not in REDUCERS:
            raise ValueError(
                f"unknown reducer {spec!r}: registered reducers are "
                f"{sorted(REDUCERS)} (register_reducer adds new ones)")
        warnings.warn(
            f"string reduce specs are deprecated: reduce={spec!r} — "
            f"declare the Reducer instance instead "
            f"({_ALIAS_REPLACEMENT.get(spec, f'repro_torch.core.reducers.REDUCERS[{spec!r}]')})",
            DeprecationWarning, stacklevel=3)
        return REDUCERS[spec]
    raise TypeError(f"reduce spec must be a Reducer or a registered "
                    f"string name, got {type(spec).__name__}")
