"""The Gram family of the port held against the JAX package on the CPU.

* ``cross_dot``'s plain version (what ``repro_torch.kernels.ops`` runs for
  CPU tensors) against the JAX registry (``repro.kernels.ops``, Pallas
  interpret mode) and the JAX oracle, at small ragged shapes, and its
  shared-input forms (one A for every group, A rows read class-major)
  against the explicit broadcast.
* ``run`` with NTK, NTKClasswise and GGNGram against JAX's ``run`` on
  logreg, mlp (CE and MSE) and c2d2, on every routing of the port
  (``use_kernels`` off, on with ``use_fused``, on without it); JAX runs
  its plain route everywhere and its kernel route (Pallas interpret) on
  c2d2.  ``ntk_total``, ``gram_total`` and the two ``ValueError``\\ s.
* ``kernel_ngd_direction`` against JAX's on mlp and c2d2.

Parameters cross from JAX through numpy (``repro_torch.bridge``); inputs are
made with numpy from a seed.  Tolerances: statistics rtol = atol = 3e-5 as
in ``tests/test_differential.py``, the atol of a Gram block scaled by its
largest entry (off-diagonal entries cancel, their rounding error scales with
the diagonal); the kernel plain versions rtol 1e-5 with the same scaled
atol; the natural-gradient direction rtol 1e-4 (a linear solve in float32).
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
from repro.core import gram_total as jgram_total
from repro.core import ntk_total as jntk_total
from repro.core import plan_sweeps as jplan_sweeps
from repro.core import run as jrun
from repro.curv.ngd import kernel_ngd_direction as jkernel_ngd_direction
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro_torch.bridge import params_from_numpy
from repro_torch.configs import papernets as tnets
from repro_torch.core import (
    CrossEntropyLoss,
    Dense,
    ExtensionConfig,
    GGNGram,
    MSELoss,
    NTK,
    NTKClasswise,
    Sequential,
    by_name,
    gram_total,
    ntk_total,
    plan_sweeps,
    run,
)
from repro_torch.core.tree import tree_leaves
from repro_torch.curv import kernel_ngd_direction
from repro_torch.kernels import ops

GRAM = ("ntk", "ntk_classwise", "ggn_gram")
ROUTES = {"plain": dict(use_kernels=False), "kernels": dict(use_kernels=True),
          "per_extension": dict(use_kernels=True, use_fused=False)}


def _rand(seed, *shape):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


def _gram_close(got, want, rtol=3e-5, atol=3e-5, msg=""):
    want = np.asarray(want)
    np.testing.assert_allclose(np.asarray(got), want, rtol=rtol,
                               atol=atol * max(1.0, np.abs(want).max()), err_msg=msg)


# ---------------------------------------------------------------------------
# cross_dot: the plain version against the Pallas kernel (interpret) and oracle
# ---------------------------------------------------------------------------

# (E, N1, N2, R, a, b): groups, unequal row sets, a rank-1 R, ragged widths.
CROSS_SHAPES = {"e3": (3, 5, 5, 7, 9, 13), "n1_ne_n2": (1, 6, 4, 5, 10, 6),
                "r1": (2, 4, 3, 1, 11, 5), "wide": (1, 3, 7, 4, 130, 9)}


@pytest.mark.parametrize("shape", CROSS_SHAPES.values(), ids=CROSS_SHAPES)
def test_cross_dot_matches_jax(shape):
    e, n1, n2, r, a, b = shape
    A1, B1 = _rand(0, e, n1, r, a), _rand(1, e, n1, r, b)
    A2, B2 = _rand(2, e, n2, r, a), _rand(3, e, n2, r, b)
    got = ops.cross_dot(*map(torch.from_numpy, (A1, B1, A2, B2)))
    j = tuple(map(jnp.asarray, (A1, B1, A2, B2)))
    for want in (jops.cross_dot(*j), jref.cross_dot(*j)):
        _gram_close(got.numpy(), want, rtol=1e-5, atol=1e-5)


def test_cross_dot_three_dim_inputs_match_jax():
    A, B = _rand(4, 6, 3, 8), _rand(5, 6, 3, 5)
    got = ops.cross_dot(*(torch.from_numpy(v) for v in (A, B, A, B)))
    want = jops.cross_dot(*(jnp.asarray(v) for v in (A, B, A, B)))
    assert got.shape == (6, 6)
    _gram_close(got.numpy(), want, rtol=1e-5, atol=1e-5)


def test_cross_dot_shared_inputs_match_the_broadcast():
    """One A for every group (the NTK's E = C) and A rows read class-major
    (GGNGram's C·N rows) are the JAX call on the broadcast input."""
    c, n, r, a, b = 3, 4, 5, 7, 6
    A, S = _rand(6, n, r, a), _rand(7, c, n, r, b)
    At, St = torch.from_numpy(A), torch.from_numpy(S)
    Arep = np.broadcast_to(A[None], (c, n, r, a))
    got = ops.cross_dot(At[None], St, At[None], St)
    want = jops.cross_dot(*(jnp.asarray(v) for v in (Arep, S, Arep, S)))
    _gram_close(got.numpy(), want, rtol=1e-5, atol=1e-5)
    rows = St.reshape(1, c * n, r, b)
    got = ops.cross_dot(At[None], rows, At[None], rows)
    flat = (jnp.asarray(Arep.reshape(1, c * n, r, a)), jnp.asarray(S.reshape(1, c * n, r, b)))
    _gram_close(got.numpy(), jops.cross_dot(*flat, *flat), rtol=1e-5, atol=1e-5)


# ---------------------------------------------------------------------------
# run with the Gram family against JAX's run
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class Case:
    net: str
    kwargs: tuple
    input_shape: tuple
    loss: str = "ce"
    n_classes: int = 10


CASES = {
    "logreg": Case("logreg", (("in_dim", 12),), (5, 12)),
    "mlp": Case("mlp", (("in_dim", 12), ("hidden", (9, 7))), (6, 12)),
    "mlp_mse": Case("mlp", (("in_dim", 12), ("hidden", (9, 7)), ("n_classes", 4)),
                    (6, 12), loss="mse", n_classes=4),
    "c2d2": Case("c2d2", (("img", 8),), (5, 8, 8, 1)),
}
_REFERENCE = {}


def reference(name, jax_kernels=False):
    """JAX model, params, batch and the Gram family's results (once)."""
    key = (name, jax_kernels)
    if key not in _REFERENCE:
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
        res = jrun(model, params, jnp.asarray(x), jnp.asarray(y), loss,
                   extensions=tuple(jby_name(g) for g in GRAM),
                   cfg=JConfig(use_kernels=jax_kernels))
        _REFERENCE[key] = dict(case=case, model=model, params=params, loss=loss,
                               np_params=jax.tree.map(np.asarray, params), x=x, y=y,
                               ext=jax.tree.map(np.asarray, res.ext))
    return _REFERENCE[key]


def port_setup(ref):
    case = ref["case"]
    model = getattr(tnets, case.net)(**dict(case.kwargs), device="cpu")
    params = params_from_numpy(model, ref["np_params"], "cpu")
    loss = CrossEntropyLoss() if case.loss == "ce" else MSELoss()
    return model, params, torch.from_numpy(ref["x"]), torch.from_numpy(ref["y"]), loss


def port_run(ref, route, names=GRAM, **cfg):
    model, params, x, y, loss = port_setup(ref)
    return run(model, params, x, y, loss, extensions=tuple(by_name(g) for g in names),
               cfg=ExtensionConfig(**ROUTES[route], **cfg))


PARAMS = [(c, r, False) for c in CASES for r in ROUTES] + [("c2d2", r, True) for r in ROUTES]


@pytest.mark.parametrize("case,route,jax_kernels", PARAMS,
                         ids=[f"{c}-{r}-jax_{'kernels' if k else 'plain'}"
                              for c, r, k in PARAMS])
def test_gram_family_matches_jax(case, route, jax_kernels):
    ref = reference(case, jax_kernels)
    res = port_run(ref, route)
    assert set(res.ext) == set(GRAM)
    for name in GRAM:
        port, want = tree_leaves(res.ext[name]), jax.tree.leaves(ref["ext"][name])
        assert len(port) == len(want) and want, name
        for a, b in zip(port, want):
            assert tuple(a.shape) == b.shape, name
            _gram_close(a.numpy(), b, msg=name)
    _gram_close(ntk_total(res.ext["ntk"]).numpy(), jntk_total(ref["ext"]["ntk"]))
    _gram_close(gram_total(res.ext["ggn_gram"]).numpy(), jgram_total(ref["ext"]["ggn_gram"]))


def test_ntk_totals_are_symmetric_and_classwise_sums():
    res = port_run(reference("c2d2"), "kernels")
    ntk = ntk_total(res.ext["ntk"])
    torch.testing.assert_close(ntk, ntk.T, rtol=0, atol=0)
    assert (torch.diagonal(ntk) >= 0).all()
    torch.testing.assert_close(ntk_total(res.ext["ntk_classwise"]).sum(-1), ntk,
                               rtol=1e-5, atol=1e-5 * ntk.abs().max().item())
    K = gram_total(res.ext["ggn_gram"])
    n, _, c, _ = K.shape
    K2 = K.permute(0, 2, 1, 3).reshape(n * c, n * c)
    torch.testing.assert_close(K2, K2.T, rtol=1e-6, atol=1e-6 * K2.abs().max().item())


def test_gram_family_calls_cross_dot(monkeypatch):
    """On the fused kernel route each conv layer sends the NTK and GGNGram
    Grams through ops.cross_dot (spied: on the CPU no launch is counted),
    and no other kernel runs; the dense layers take the closed forms."""
    calls = {k: 0 for k in ops.KERNELS}
    for k in ops.KERNELS:
        def spy(*args, _k=k, _f=getattr(ops, k), **kw):
            calls[_k] += 1
            return _f(*args, **kw)
        monkeypatch.setattr(ops, k, spy)
    port_run(reference("c2d2"), "kernels")
    assert calls == dict({k: 0 for k in ops.KERNELS}, cross_dot=4)


def test_ntk_needs_flat_outputs():
    model = Sequential([Dense(4, 3, device="cpu")])
    x, y = torch.randn(2, 5, 4), torch.zeros(2, 5, dtype=torch.long)
    with pytest.raises(ValueError, match="flat"):
        run(model, model.params(), x, y, CrossEntropyLoss(), extensions=(NTK,))
    with pytest.raises(ValueError, match="empty NTK"):
        ntk_total(())
    with pytest.raises(ValueError, match="empty GGN-Gram"):
        gram_total({})


def test_ggn_gram_refuses_class_chunk():
    ref = reference("mlp")
    with pytest.raises(ValueError, match="class_chunk"):
        port_run(ref, "kernels", names=("ggn_gram",), class_chunk=3)
    res = port_run(ref, "kernels", names=("ggn_gram",), class_chunk=10)  # one chunk
    _gram_close(gram_total(res.ext["ggn_gram"]).numpy(), jgram_total(ref["ext"]["ggn_gram"]))


@pytest.mark.parametrize("names", [("ntk",), ("ntk", "ggn_gram", "diag_ggn"),
                                   ("ntk_classwise", "kflr", "batch_l2")])
def test_plan_describe_matches_jax(names):
    got = plan_sweeps(tuple(by_name(n) for n in names), ExtensionConfig()).describe()
    want = jplan_sweeps(tuple(jby_name(n) for n in names), JConfig(use_kernels=True)).describe()
    assert got == want


# ---------------------------------------------------------------------------
# kernel-space natural gradient
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("route", ["plain", "kernels"])
@pytest.mark.parametrize("case", ["mlp", "c2d2"])
def test_kernel_ngd_direction_matches_jax(case, route):
    ref = reference(case)
    jd, _ = jkernel_ngd_direction(ref["model"], ref["params"], jnp.asarray(ref["x"]),
                                  jnp.asarray(ref["y"]), ref["loss"], damping=0.5,
                                  cfg=JConfig(use_kernels=False))
    model, params, x, y, loss = port_setup(ref)
    d, res = kernel_ngd_direction(model, params, x, y, loss, damping=0.5,
                                  cfg=ExtensionConfig(**ROUTES[route]))
    assert "ggn_gram" in res.ext
    for a, b in zip(tree_leaves(d), jax.tree.leaves(jd), strict=True):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-4,
                                   atol=1e-4 * np.abs(np.asarray(b)).max())
