"""The port's accumulated lane held against the JAX package's on the CPU.

* ``plan_sweeps(...).accumulate(k).run`` against JAX's ``accumulate(k)`` for
  every extension without MC draws (first-order, exact GGN, the Gram family;
  KFRA and DiagHessian on the chain model), on the mlp and c2d2 of
  ``tests/test_torch_engine.py``, k ∈ {1, 3, N} (k = 3 leaves a tail slice),
  the port on its plain route and on its kernel route (the kernels' plain
  versions on the CPU).  JAX runs its plain route, jitted.
* With MC draws, the port's accumulated run against the port's monolithic
  run on one ``mc_seed`` and on one set of given draws, fused and
  per-extension: the slices take the whole batch's draws.
* Masked targets (the global 1/M), the refusal of a reducer that cannot
  stream, ``num_microbatches`` < 1, MC without a seed or draws, ``describe``
  (as JAX's), and ``plan_for_batch``.
* The pair passes' pairwise hooks on two row sets (``cross_split``):
  ``per_sample_dots``, the NTK and GGNGram blocks on every route, and
  ``ops.cross_dot``'s plain version, against JAX's cross forms.

Tolerances of ``tests/test_torch_engine.py``: loss rtol 1e-6, logits and
gradients rtol 1e-5 / atol 1e-6, statistics rtol = atol = 3e-5.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import papernets as jnets
from repro.core import CrossEntropyLoss as JCrossEntropy
from repro.core import ExtensionConfig as JConfig
from repro.core import by_name as jby_name
from repro.core import module as jmodule
from repro.core import plan_sweeps as jplan_sweeps
from repro_torch.bridge import params_from_numpy
from repro_torch.configs import papernets as tnets
from repro_torch.core import (
    AccumulatedSweepPlan,
    CrossEntropyLoss,
    DiagGGNMC,
    Extension,
    ExtensionConfig,
    Reducer,
    by_name,
    plan_for_batch,
    plan_sweeps,
    run,
)
from repro_torch.core import module as tmodule
from repro_torch.core.loss_hessian import MCUniforms
from repro_torch.core.tree import tree_leaves
from repro_torch.kernels import ops as kops

FIRST = ("batch_grad", "batch_l2", "second_moment", "variance", "batch_dot")
EXACT = ("diag_ggn", "kflr", "ggn_trace")
GRAM = ("ntk", "ntk_classwise", "ggn_gram")
CHAIN = ("kfra", "diag_hessian")
MC = ("diag_ggn_mc", "kfac")
# N = 7 and 5: k = 3 gives slices of 3 + 3 + 1 and 2 + 2 + 1 (a tail).
NETS = {"mlp": (dict(in_dim=20, hidden=(16, 12)), (7, 20), FIRST + EXACT + GRAM + CHAIN),
        "c2d2": (dict(img=8), (5, 8, 8, 1), FIRST + EXACT + GRAM)}
STAT = dict(rtol=3e-5, atol=3e-5)


def _batch(net):
    kw, shape, names = NETS[net]
    rs = np.random.RandomState(1)
    x = rs.randn(*shape).astype(np.float32)
    y = rs.randint(0, 10, shape[0])
    return kw, x, y, names


_JAX = {}


def jax_reference(net, k):
    """JAX's accumulate(k) (plain route, jitted) of one net's non-MC
    extensions, and its numpy params (computed once)."""
    if (net, k) not in _JAX:
        kw, x, y, names = _batch(net)
        model = getattr(jnets, net)(**kw)
        params = model.init(jax.random.PRNGKey(0))
        plan = jplan_sweeps(tuple(jby_name(n) for n in names), JConfig()).accumulate(k)

        @jax.jit
        def go(p, xx, yy):
            r = plan.run(model, p, xx, yy, JCrossEntropy(), cfg=JConfig())
            return r.loss, r.grads, r.logits, r.ext

        res = jax.tree.map(np.asarray, go(params, jnp.asarray(x), jnp.asarray(y)))
        _JAX[net, k] = (jax.tree.map(np.asarray, params), res)
    return _JAX[net, k]


def _port(net, np_params):
    kw = NETS[net][0]
    model = getattr(tnets, net)(**kw, device="cpu")
    return model, params_from_numpy(model, np_params, "cpu")


@pytest.mark.parametrize("use_kernels", [False, True], ids=["einsum", "kernels"])
@pytest.mark.parametrize("k", [1, 3, "N"])
@pytest.mark.parametrize("net", sorted(NETS))
def test_accumulate_matches_jax(net, k, use_kernels):
    kw, x, y, names = _batch(net)
    k = x.shape[0] if k == "N" else k
    np_params, (jloss, jgrads, jlogits, jext) = jax_reference(net, k)
    model, params = _port(net, np_params)
    cfg = ExtensionConfig(use_kernels=use_kernels, use_fused=True)
    plan = plan_sweeps(tuple(by_name(n) for n in names), cfg).accumulate(k)
    res = plan.run(model, params, torch.from_numpy(x), torch.from_numpy(y), CrossEntropyLoss(),
                   cfg=cfg)
    np.testing.assert_allclose(res.loss.numpy(), jloss, rtol=1e-6)
    np.testing.assert_allclose(res.logits.numpy(), jlogits, rtol=1e-5, atol=1e-6)
    for a, b in zip(tree_leaves(res.grads), jax.tree.leaves(jgrads), strict=True):
        np.testing.assert_allclose(a.numpy(), b, rtol=1e-5, atol=1e-6)
    assert set(res.ext) == set(names)
    for name in names:
        port, want = tree_leaves(res.ext[name]), jax.tree.leaves(jext[name])
        assert len(port) == len(want) and want, name
        for a, b in zip(port, want):
            assert tuple(a.shape) == b.shape, name
            np.testing.assert_allclose(a.numpy(), b, err_msg=name, **STAT)


def _c2d2():
    kw, x, y, _ = _batch("c2d2")
    model = tnets.c2d2(**kw, device="cpu", generator=torch.Generator().manual_seed(0))
    return model, model.params(), torch.from_numpy(x), torch.from_numpy(y)


def _assert_results_close(got, want, names, tol=STAT):
    torch.testing.assert_close(got.loss, want.loss, rtol=1e-6, atol=0)
    for a, b in zip(tree_leaves(got.grads), tree_leaves(want.grads), strict=True):
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-6)
    for name in names:
        for a, b in zip(tree_leaves(got.ext[name]), tree_leaves(want.ext[name]), strict=True):
            torch.testing.assert_close(a, b, msg=name, **tol)


@pytest.mark.parametrize("draws", ["mc_seed", "draws", "uniforms"])
@pytest.mark.parametrize("use_fused", [True, False], ids=["fused", "per_extension"])
def test_accumulate_mc_matches_monolithic(use_fused, draws):
    """The MC sweep in slices draws what the monolithic sweep draws: one
    ``mc_seed`` (the uniforms made once for the whole batch), given class
    draws, or given uniforms, the slices taking their columns."""
    model, params, x, y = _c2d2()
    names = MC + ("variance",)
    exts = tuple(by_name(n) for n in names)
    cfg = ExtensionConfig(mc_samples=2, use_kernels=True, use_fused=use_fused,
                          mc_seed=11 if draws == "mc_seed" else None)
    gen = torch.Generator().manual_seed(3)
    rng = {"mc_seed": None, "draws": torch.randint(0, 10, (2, x.shape[0]), generator=gen),
           "uniforms": MCUniforms(torch.rand(2, x.shape[0], generator=gen))}[draws]
    want = run(model, params, x, y, CrossEntropyLoss(), exts, cfg, rng)
    got = plan_sweeps(exts, cfg).accumulate(3).run(model, params, x, y, CrossEntropyLoss(),
                                                   cfg=cfg, rng=rng)
    _assert_results_close(got, want, names)


def test_masked_targets_accumulate_exactly():
    """Uneven masks over the slices: the whole batch's mask-aware unit count
    keeps the 1/M exact though one slice is almost all padding."""
    model, params, x, y = _c2d2()
    y = y.clone()
    y[:3] = -1
    y[0] = 1
    names = ("batch_l2", "diag_ggn", "variance", "kflr")
    exts = tuple(by_name(n) for n in names)
    cfg = ExtensionConfig(use_kernels=True)
    want = run(model, params, x, y, CrossEntropyLoss(), exts, cfg)
    got = plan_sweeps(exts, cfg).accumulate(3).run(model, params, x, y, CrossEntropyLoss(),
                                                   cfg=cfg)
    _assert_results_close(got, want, names)


def test_accumulate_rejects_non_streaming_reducers():
    class WholeBatchReducer(Reducer):
        name = "whole_batch_test"
        supports_streaming = False

    ext = Extension("_whole_batch_stat", "first", reduce=WholeBatchReducer())
    plan = plan_sweeps((ext,), ExtensionConfig()).accumulate(2)
    with pytest.raises(ValueError, match="sequential accumulator") as ei:
        plan._check_extensions((ext,))
    for word in ("_whole_batch_stat", "whole_batch_test", "supports_streaming"):
        assert word in str(ei.value)
    model, params, x, y = _c2d2()
    with pytest.raises(ValueError, match="sequential accumulator"):
        plan.run(model, params, x, y, CrossEntropyLoss())


def test_accumulate_validates_num_microbatches():
    with pytest.raises(ValueError, match="num_microbatches"):
        plan_sweeps((), ExtensionConfig()).accumulate(0)


def test_accumulated_mc_needs_seed_or_rng():
    model, params, x, y = _c2d2()
    plan = plan_sweeps((DiagGGNMC,), ExtensionConfig()).accumulate(2)
    with pytest.raises(ValueError, match="rng"):
        plan.run(model, params, x, y, CrossEntropyLoss())


@pytest.mark.parametrize("use_kernels", [False, True])
def test_describe_reports_accumulation(use_kernels):
    names = ("batch_l2", "variance", "kflr", "batch_dot", "ggn_gram")
    got = plan_sweeps(tuple(by_name(n) for n in names),
                      ExtensionConfig(use_kernels=use_kernels)).accumulate(4).describe()
    want = jplan_sweeps(tuple(jby_name(n) for n in names),
                        JConfig(use_kernels=use_kernels)).accumulate(4).describe()
    assert got == want
    assert "accumulate=4 microbatches" in got
    assert "variance:moment_merge(sequential Chan merge)" in got


def test_plan_for_batch_composes_the_accumulated_lane():
    exts = (by_name("kfac"),)
    plan = plan_for_batch(exts, None, 10, microbatch_size=4)
    assert isinstance(plan, AccumulatedSweepPlan) and plan.num_microbatches == 3
    plan = plan_for_batch(exts, ExtensionConfig(microbatch_size=5), 10)
    assert isinstance(plan, AccumulatedSweepPlan) and plan.num_microbatches == 2
    assert not isinstance(plan_for_batch(exts, ExtensionConfig(microbatch_size=10), 10),
                          AccumulatedSweepPlan)
    with pytest.raises(NotImplementedError, match="item 12"):
        plan_for_batch(exts, None, 10, mesh=object(), microbatch_size=4)


# -- the pair passes' hooks on two row sets ------------------------------------

# (N1, N2, R, a, b): a tail pair off the tiles, a dense layer (R = 1), and
# the two row sets of one size.
CROSS_SHAPES = [(5, 3, 4, 7, 6), (4, 4, 1, 9, 5), (3, 2, 6, 5, 3)]


def _cross_inputs(shape, classes=0):
    n1, n2, r, a, b = shape
    rs = np.random.RandomState(sum(shape))
    A = rs.randn(n1 + n2, r, a).astype(np.float32)
    B = rs.randn(*((classes,) if classes else ()), n1 + n2, r, b).astype(np.float32)
    return A, B


@pytest.mark.parametrize("shape", CROSS_SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_per_sample_dots_cross_matches_jax(shape):
    """The plain BatchDot cross block, ``ops.cross_dot``'s plain version on
    the two row sets (the kernel route of a pair pass) and the first-order
    hook under ``cross_split`` on every route, against JAX's cross form."""
    n1 = shape[0]
    A, B = _cross_inputs(shape)
    want = np.asarray(jmodule.per_sample_dots(jnp.asarray(A), jnp.asarray(B),
                                              cross_split=n1))
    tol = dict(rtol=3e-5, atol=3e-5 * np.abs(want).max())
    At, Bt = torch.from_numpy(A), torch.from_numpy(B)
    np.testing.assert_allclose(tmodule.per_sample_dots(At, Bt, n1).numpy(), want, **tol)
    np.testing.assert_allclose(kops.cross_dot(At[:n1], Bt[:n1], At[n1:], Bt[n1:]).numpy(),
                               want, **tol)
    for use_kernels, use_fused in ((False, True), (True, True), (True, False)):
        cfg = ExtensionConfig(use_kernels=use_kernels, use_fused=use_fused, cross_split=n1)
        out = tmodule.dense_first_order_stats(At, Bt, (by_name("batch_dot"),), cfg, True)
        np.testing.assert_allclose(out["batch_dot"]["w"].numpy(), want, **tol)
        jb = np.asarray(jmodule._pairwise_rows(jnp.asarray(B).sum(1), cross_split=n1))
        np.testing.assert_allclose(out["batch_dot"]["b"].numpy(), jb, rtol=3e-5,
                                   atol=3e-5 * np.abs(jb).max())


@pytest.mark.parametrize("route", ["einsum", "kernels"])
@pytest.mark.parametrize("shape", CROSS_SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_gram_hooks_cross_match_jax(shape, route):
    """The NTK / NTKClasswise and GGNGram hooks under ``cross_split``
    against JAX's on the same factors (C = 3 classes)."""
    n1 = shape[0]
    A, S = _cross_inputs(shape, classes=3)
    uk = route == "kernels"
    cfg = ExtensionConfig(use_kernels=uk, use_fused=True, cross_split=n1)
    jcfg = JConfig(use_kernels=False, cross_split=n1)
    At, St = torch.from_numpy(A), torch.from_numpy(S)
    got = tmodule._dense_ntk_stats(At, St, {"ntk", "ntk_classwise"}, cfg, True)
    got.update(tmodule._dense_ggn_gram_stats(At, St, cfg, True))
    want = jmodule._dense_ntk_stats(jnp.asarray(A), jnp.asarray(S), {"ntk", "ntk_classwise"},
                                    jcfg, True)
    want.update(jmodule._dense_ggn_gram_stats(jnp.asarray(A), jnp.asarray(S), jcfg, True))
    for name in ("ntk", "ntk_classwise", "ggn_gram"):
        for key in ("w", "b"):
            w = np.asarray(want[name][key])
            assert tuple(got[name][key].shape) == w.shape, (name, key)
            np.testing.assert_allclose(got[name][key].numpy(), w, rtol=3e-5,
                                       atol=3e-5 * np.abs(w).max(), err_msg=f"{name} {key}")


def test_cross_split_never_reads_as_one_row_set():
    """Two slices of one tensor are two row sets: the cross block of a
    batch against itself shifted is not the symmetric Gram."""
    A, B = _cross_inputs((4, 4, 3, 5, 6))
    At, Bt = torch.from_numpy(A), torch.from_numpy(B)
    cross = kops.cross_dot(At[:4], Bt[:4], At[4:], Bt[4:])
    full = tmodule.per_sample_dots(At, Bt)
    torch.testing.assert_close(cross, full[:4, 4:], rtol=3e-5, atol=3e-5)
    assert not torch.allclose(cross, full[:4, :4])
    cfg = dataclasses.replace(ExtensionConfig(), cross_split=None)
    assert tmodule._pair_split(cfg) is None
