"""The port's ``run`` held against the JAX package's ``run`` on the CPU.

Each paper network is initialised in JAX, its parameters cross into the port
through numpy (``repro_torch.bridge``), and both packages run the same
numpy-made batch.  The JAX side is the reference: ``use_kernels=True``
(Pallas interpret mode), all extensions in one jitted call.  The port runs
every sweep with ``use_kernels`` off and on (on the CPU the kernels' plain
versions run).  The MC sweep gets JAX's own draws, computed with
``jax.random`` exactly as ``repro/core/loss_hessian.py`` draws them.

Tolerances are those of ``tests/test_differential.py``: loss rtol 1e-6,
logits and gradients rtol 1e-5 / atol 1e-6, statistics rtol = atol = 3e-5.
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
from repro.core import MSELoss as JMSE
from repro.core import by_name as jby_name
from repro.core import plan_sweeps as jplan_sweeps
from repro.core import run as jrun
from repro.core.module import per_sample_dots as jper_sample_dots
from repro.nn.layers import MaxPool2d as JMaxPool2d
from repro_torch.bridge import params_from_numpy, params_to_numpy
from repro_torch.configs import papernets as tnets
from repro_torch.core import CrossEntropyLoss, ExtensionConfig, MSELoss, by_name, plan_sweeps, run
from repro_torch.core.module import per_sample_dots
from repro_torch.core.tree import tree_leaves
from repro_torch.nn.layers import MaxPool2d

SWEEPS = {
    "first": ("batch_grad", "batch_l2", "second_moment", "variance", "batch_dot"),
    "exact": ("diag_ggn", "kflr", "ggn_trace"),
    "mc": ("diag_ggn_mc", "kfac"),
    "chain": ("kfra", "diag_hessian"),
}
MC_SAMPLES = 2


@dataclasses.dataclass(frozen=True)
class Case:
    net: str
    kwargs: tuple
    input_shape: tuple
    loss: str = "ce"
    n_classes: int = 10

    @property
    def sweeps(self):
        chain = self.net in ("logreg", "mlp")  # KFRA / DiagHessian: chain models only
        return [s for s in SWEEPS if chain or s != "chain"]


CASES = {
    "logreg": Case("logreg", (("in_dim", 20),), (7, 20)),
    "mlp": Case("mlp", (("in_dim", 20), ("hidden", (16, 12))), (6, 20)),
    "mlp_mse": Case("mlp", (("in_dim", 20), ("hidden", (16, 12)), ("n_classes", 5)),
                    (6, 20), loss="mse", n_classes=5),
    "c2d2": Case("c2d2", (("img", 8),), (5, 8, 8, 1)),
    "c3d3": Case("c3d3", (("img", 8),), (4, 8, 8, 3)),
    # img 16 gives the stride-2 SAME convs (odd padding) and the VALID 3x3 room.
    "allcnnc": Case("allcnnc", (("img", 16), ("width", 8), ("n_classes", 10)),
                    (4, 16, 16, 3)),
}


def _jax_draws(case, logits, rng, k):
    """JAX's MC draws, made as ``sqrt_hessian_mc`` makes them."""
    keys = jax.vmap(jax.random.fold_in, in_axes=(None, 0))(
        rng, jnp.arange(logits.shape[0]))
    if case.loss == "ce":
        draw = jax.vmap(lambda key, zn: jax.random.categorical(
            key, zn, axis=-1, shape=(k,)))
    else:
        draw = jax.vmap(lambda key, zn: jax.random.rademacher(
            key, (k,) + zn.shape, dtype=jnp.float32))
    return np.asarray(jnp.moveaxis(draw(keys, logits), 1, 0))


_REFERENCE = {}


def reference(name):
    """JAX model, params, batch and results for one case (computed once)."""
    if name in _REFERENCE:
        return _REFERENCE[name]
    case = CASES[name]
    model = getattr(jnets, case.net)(**dict(case.kwargs))
    params = model.init(jax.random.PRNGKey(0))
    rs = np.random.RandomState(1)
    x = rs.randn(*case.input_shape).astype(np.float32)
    n = case.input_shape[0]
    if case.loss == "ce":
        y, loss = rs.randint(0, case.n_classes, n), JCrossEntropy()
    else:
        y, loss = rs.randn(n, case.n_classes).astype(np.float32), JMSE()
    names = tuple(e for s in case.sweeps for e in SWEEPS[s])
    exts = tuple(jby_name(e) for e in names)
    rng = jax.random.PRNGKey(42)
    cfg = JConfig(use_kernels=True, mc_samples=MC_SAMPLES)

    @jax.jit
    def go(p, xx, yy):
        r = jrun(model, p, xx, yy, loss, extensions=exts, cfg=cfg, rng=rng)
        return r.loss, r.grads, r.logits, r.ext

    res = jax.tree.map(np.asarray, go(params, jnp.asarray(x), jnp.asarray(y)))
    draws = _jax_draws(case, jnp.asarray(res[2]), rng, MC_SAMPLES)
    _REFERENCE[name] = dict(case=case, np_params=jax.tree.map(np.asarray, params),
                            x=x, y=y, res=res, draws=draws)
    return _REFERENCE[name]


def port_run(ref, names, **cfg):
    case = ref["case"]
    model = getattr(tnets, case.net)(**dict(case.kwargs), device="cpu")
    params = params_from_numpy(model, ref["np_params"], "cpu")
    loss = CrossEntropyLoss() if case.loss == "ce" else MSELoss()
    return run(model, params, torch.from_numpy(ref["x"]), torch.from_numpy(ref["y"]),
               loss, extensions=tuple(by_name(n) for n in names),
               cfg=ExtensionConfig(mc_samples=MC_SAMPLES, **cfg),
               rng=torch.tensor(ref["draws"]))


def assert_matches(res, ref, names):
    jloss, jgrads, jlogits, jext = ref["res"]
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
            np.testing.assert_allclose(a.numpy(), b, rtol=3e-5, atol=3e-5,
                                       err_msg=name)


PARAMS = [(c, s, k) for c in CASES for s in CASES[c].sweeps for k in (False, True)]


@pytest.mark.parametrize("case,sweep,use_kernels", PARAMS,
                         ids=[f"{c}-{s}-{'kernels' if k else 'einsum'}"
                              for c, s, k in PARAMS])
def test_run_matches_jax(case, sweep, use_kernels):
    ref = reference(case)
    names = SWEEPS[sweep]
    assert_matches(port_run(ref, names, use_kernels=use_kernels), ref, names)


@pytest.mark.parametrize("use_kernels", [False, True], ids=["einsum", "kernels"])
@pytest.mark.parametrize("case", ["c2d2", "mlp_mse"])
def test_class_chunk_matches_jax(case, use_kernels):
    ref = reference(case)
    names = SWEEPS["exact"]
    res = port_run(ref, names, use_kernels=use_kernels, class_chunk=3)
    assert_matches(res, ref, names)


def test_unported_routing_raises():
    ref = reference("mlp")
    with pytest.raises(ValueError, match="per_sample_moment and batch_l2"):
        port_run(ref, SWEEPS["first"], use_kernels=True, use_fused=False)


def test_mc_seed_draws_are_deterministic():
    ref = reference("c2d2")
    model = tnets.c2d2(img=8, device="cpu")
    params = params_from_numpy(model, ref["np_params"], "cpu")
    x, y = torch.from_numpy(ref["x"]), torch.from_numpy(ref["y"])
    exts = tuple(by_name(n) for n in SWEEPS["mc"])

    def diag(seed):
        cfg = ExtensionConfig(mc_samples=4, mc_seed=seed, use_kernels=True)
        res = run(model, params, x, y, CrossEntropyLoss(), exts, cfg)
        return tree_leaves(res["diag_ggn_mc"])[0]

    torch.testing.assert_close(diag(0), diag(0), rtol=0, atol=0)
    assert not torch.equal(diag(0), diag(1))
    with pytest.raises(ValueError, match="MC extensions need an rng"):
        run(model, params, x, y, CrossEntropyLoss(), exts, ExtensionConfig())


@pytest.mark.parametrize("names", [SWEEPS["first"], SWEEPS["exact"] + SWEEPS["mc"],
                                   ("batch_l2", "kfra"), ()])
@pytest.mark.parametrize("use_kernels", [False, True])
def test_plan_describe_matches_jax(names, use_kernels):
    got = plan_sweeps(tuple(by_name(n) for n in names),
                      ExtensionConfig(use_kernels=use_kernels)).describe()
    want = jplan_sweeps(tuple(jby_name(n) for n in names),
                        JConfig(use_kernels=use_kernels)).describe()
    assert got == want


def test_maxpool_tied_windows_match_jax():
    """After a ReLU whole windows are 0: the cotangent must go where JAX's
    reduce_window max gradient sends it (the first maximum)."""
    rs = np.random.RandomState(3)
    x = np.maximum(rs.randint(-2, 2, (3, 6, 6, 4)), 0).astype(np.float32)
    x[0, :2, :2, :] = 0.0                      # a window of equal zeros
    x[1, 2:4, 2:4, 1] = 1.0                    # a window of equal ones
    g = rs.randn(3, 3, 3, 4).astype(np.float32)
    jpool = JMaxPool2d(2)
    jy, vjp = jax.vjp(lambda xx: jpool.apply((), xx), jnp.asarray(x))
    pool = MaxPool2d(2)
    y, tape = pool.forward_tape((), torch.from_numpy(x))
    gx, _, _ = pool.backward((), tape, torch.from_numpy(g), (), None)
    np.testing.assert_array_equal(y.numpy(), np.asarray(jy))
    np.testing.assert_array_equal(gx.numpy(), np.asarray(vjp(jnp.asarray(g))[0]))


def test_weight_bridge_round_trips():
    ref = reference("c3d3")
    model = tnets.c3d3(img=8, device="cpu")
    params = params_from_numpy(model, ref["np_params"], "cpu")
    back = params_to_numpy(params)
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(ref["np_params"]), strict=True):
        np.testing.assert_array_equal(a, b)
    assert jax.tree.structure(back) == jax.tree.structure(ref["np_params"])
    with pytest.raises(ValueError, match="parameter trees differ"):
        params_from_numpy(tnets.c2d2(img=8, device="cpu"), ref["np_params"], "cpu")


@pytest.mark.parametrize("shape", [(6, 1, 20, 12), (3, 4, 10, 9), (4, 64, 75, 64)],
                         ids=["dense-gram-trick", "conv-gram-trick", "conv-gradients"])
def test_per_sample_dots_matches_jax(shape):
    """Both forms of the plain BatchDot (Gram trick where [N,N,R,R] is the
    smaller, per-sample gradients else) against JAX's Gram trick."""
    n, r, a, b = shape
    rs = np.random.RandomState(4)
    A = rs.randn(n, r, a).astype(np.float32)
    B = rs.randn(n, r, b).astype(np.float32)
    got = per_sample_dots(torch.from_numpy(A), torch.from_numpy(B)).numpy()
    want = np.asarray(jper_sample_dots(jnp.asarray(A), jnp.asarray(B)))
    np.testing.assert_allclose(got, want, rtol=3e-5, atol=3e-5 * np.abs(want).max())
