"""The port's Reducer protocol held against the JAX package's.

The port of ``tests/test_reducers.py``: for every registered reducer, the
algebra the accumulated lane relies on (``merge`` associative, commutative
where declared, an ``update`` fold then ``finalize`` independent of the
slice order), each result also held against the JAX reducer's on the same
numpy partials; the capability flags and ``transpose_block`` as JAX has them;
the deprecated string aliases (a ``DeprecationWarning`` naming the
replacement), unknown names and types, and a third-party reducer through
``register_reducer``.  Tolerances: rtol 1e-5, atol 1e-6.
"""
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import REDUCERS as JREDUCERS
from repro.core.extensions import Extension as JExtension
from repro_torch.core import REDUCERS, Reducer, register_reducer, resolve_reducer
from repro_torch.core.extensions import Extension
from repro_torch.core.tree import tree_leaves, tree_map

ALL_NAMES = sorted(REDUCERS)
COMMUTATIVE_NAMES = [n for n in ALL_NAMES if REDUCERS[n].commutative]
SEEDS = (0, 1, 2)
TOL = dict(rtol=1e-5, atol=1e-6)


def _partial(name, rng):
    """A random accumulated partial in reducer ``name``'s algebra (numpy)."""
    if name == "kron":
        return {"w": {"A": rng.normal(size=(3, 3)), "B": rng.normal(size=(2, 2))}}
    if name == "moment_merge":
        rows = rng.normal(size=(4, 3)) * 2.0
        s = rows.sum(0)
        return {"n": np.float32(4.0), "mean": s / 4.0, "m2": (rows ** 2).sum(0) - s ** 2 / 4.0}
    if name == "concat":
        return rng.normal(size=(int(rng.integers(1, 4)), 3))
    if name == "gram":
        # disjoint-block scatters into one [N, N] frame of zeros
        full = np.zeros((6, 6))
        i = int(rng.integers(0, 3)) * 2
        full[i:i + 2, i:i + 2] = rng.normal(size=(2, 2))
        return full
    if name == "gram_pair":
        full = np.zeros((6, 6, 2, 2))
        i = int(rng.integers(0, 3)) * 2
        blk = rng.normal(size=(2, 2, 2, 2))
        full[i:i + 2, i:i + 2] = blk + blk.transpose(1, 0, 3, 2)
        j = (i + 2) % 6
        off = rng.normal(size=(2, 2, 2, 2))
        full[j:j + 2, i:i + 2] = off.transpose(1, 0, 3, 2)
        full[i:i + 2, j:j + 2] = off
        return full
    return rng.normal(size=(3, 2))


def _torch(tree):
    return tree_map(lambda a: torch.as_tensor(np.asarray(a, np.float32)), tree)


def _jax(tree):
    return jax.tree.map(lambda a: jnp.asarray(np.asarray(a, np.float32)), tree)


def _assert_close(a, b, err_msg=""):
    """Leafwise closeness of two trees (torch or JAX leaves, sorted keys)."""
    la, lb = tree_leaves(a), tree_leaves(b)
    assert len(la) == len(lb), err_msg
    for x, y in zip(la, lb):
        np.testing.assert_allclose(np.asarray(x), np.asarray(y), err_msg=err_msg, **TOL)


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("name", ALL_NAMES)
def test_merge_is_associative(name, seed):
    red, jred = REDUCERS[name], JREDUCERS[name]
    rng = np.random.default_rng(seed)
    a, b, c = (_partial(name, rng) for _ in range(3))
    left = red.merge(red.merge(_torch(a), _torch(b)), _torch(c))
    _assert_close(left, red.merge(_torch(a), red.merge(_torch(b), _torch(c))),
                  f"{name} merge associativity")
    _assert_close(left, jred.merge(jred.merge(_jax(a), _jax(b)), _jax(c)), f"{name} vs JAX")


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("name", COMMUTATIVE_NAMES)
def test_merge_is_commutative_when_declared(name, seed):
    red = REDUCERS[name]
    rng = np.random.default_rng(seed)
    a, b = _partial(name, rng), _partial(name, rng)
    _assert_close(red.merge(_torch(a), _torch(b)), red.merge(_torch(b), _torch(a)),
                  f"{name} merge commutativity")


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("name", COMMUTATIVE_NAMES)
def test_update_fold_is_order_invariant(name, seed):
    """init → update (any slice order) → finalize gives one result, and the
    JAX reducer's on the same partials and weights."""
    red, jred = REDUCERS[name], JREDUCERS[name]
    rng = np.random.default_rng(seed)
    parts = [_partial(name, rng) for _ in range(4)]
    weights = [2.0, 3.0, 1.0, 4.0]
    meta_fin = {"total_batch": float(sum(weights))}
    perm = np.random.default_rng(seed + 100).permutation(len(parts))

    def fold(order):
        acc = red.init(tree_map(torch.zeros_like, _torch(parts[0])))
        for i in order:
            acc = red.update(acc, _torch(parts[i]), {"weight": weights[i]})
        return red.finalize(acc, meta_fin)

    jacc = jred.init(jax.tree.map(jnp.zeros_like, _jax(parts[0])))
    for i in range(len(parts)):
        jacc = jred.update(jacc, _jax(parts[i]), {"weight": weights[i]})
    got = fold(range(len(parts)))
    _assert_close(got, fold(perm), f"{name} update order invariance")
    _assert_close(got, jred.finalize(jacc, meta_fin), f"{name} finalize vs JAX")


def test_concat_fold_matches_jax():
    """concat is order-dependent: rows append in slice order, as in JAX."""
    rng = np.random.default_rng(3)
    parts = [_partial("concat", rng) for _ in range(3)]
    red, jred = REDUCERS["concat"], JREDUCERS["concat"]
    acc, jacc = _torch(parts[0]), _jax(parts[0])
    for p in parts[1:]:
        acc = red.update(acc, _torch(p), {"weight": 1.0})
        jacc = jred.update(jacc, _jax(p), {"weight": 1.0})
    _assert_close(red.finalize(acc, {}), jred.finalize(jacc, {}), "concat")


@pytest.mark.parametrize("name", ALL_NAMES)
def test_placement_and_streaming_form_are_reported(name):
    """Every capability flag as the JAX reducer declares it."""
    red, jred = REDUCERS[name], JREDUCERS[name]
    for flag in ("supports_streaming", "supports_checkpoint", "local_rows", "streams_rows",
                 "pairwise", "commutative", "streaming_form", "placement"):
        assert getattr(red, flag) == getattr(jred, flag), (name, flag)
    assert isinstance(red.streaming_form, str) and red.streaming_form
    assert sorted(REDUCERS) == sorted(JREDUCERS)


def test_gram_pair_capability_flags():
    red = REDUCERS["gram_pair"]
    assert red.pairwise and red.local_rows and red.commutative
    assert red.placement == "sharded(axis0)"
    assert REDUCERS["psum"].placement == "replicated"
    assert REDUCERS["concat"].placement == "sharded(axis0)"


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("name", ["gram", "gram_pair"])
def test_transpose_block_matches_jax(name, seed):
    """transpose_block mirrors block (p, q) to (q, p): gram swaps the sample
    axes, gram_pair the column pair too; twice is the identity."""
    rng = np.random.default_rng(seed)
    blk = rng.normal(size=(3, 2, 4, 4)).astype(np.float32)
    t = REDUCERS[name].transpose_block(torch.from_numpy(blk))
    assert tuple(t.shape) == (2, 3, 4, 4)
    np.testing.assert_array_equal(t.numpy(),
                                  np.asarray(JREDUCERS[name].transpose_block(jnp.asarray(blk))))
    np.testing.assert_array_equal(REDUCERS[name].transpose_block(t).numpy(), blk)


@pytest.mark.parametrize("alias", ["psum", "concat", "gram", "kron", "moment_merge", "pmean"])
def test_string_alias_warns_with_replacement(alias):
    with pytest.warns(DeprecationWarning, match=f"repro_torch.core.reducers.{alias.upper()}"):
        r = resolve_reducer(alias)
    assert r is REDUCERS[alias]


def test_extension_resolves_string_alias_with_warning():
    with pytest.warns(DeprecationWarning, match="GRAM"):
        e = Extension("_tmp_stat", "first", reduce="gram")
    assert e.reduce is REDUCERS["gram"]
    with pytest.warns(DeprecationWarning, match="GRAM"):
        je = JExtension("_tmp_stat", "first", reduce="gram")
    assert e.reduce.name == je.reduce.name


def test_reducer_instance_passes_through_silently():
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        assert resolve_reducer(REDUCERS["kron"]) is REDUCERS["kron"]


def test_unknown_string_raises_with_registry():
    with pytest.raises(ValueError, match="registered reducers"):
        resolve_reducer("definitely_not_a_reducer")


def test_bad_spec_type_raises():
    with pytest.raises(TypeError, match="Reducer"):
        resolve_reducer(42)


def test_register_reducer_roundtrip():
    class MyReducer(Reducer):
        name = "my_test_reducer"

    r = register_reducer(MyReducer())
    try:
        with pytest.warns(DeprecationWarning):
            assert resolve_reducer("my_test_reducer") is r
    finally:
        del REDUCERS["my_test_reducer"]
