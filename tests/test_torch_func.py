"""``torch.func`` through the card's two autograd Functions, on the CPU.

``kernels/ops.py``'s ``_FlashAttentionFn`` and ``_WkvFn`` launch their
kernel in the forward and take the plain version's derivatives: a VJP
(backward), a JVP (forward mode) and a vmap rule that folds the mapped axis
into the kernel's batch.  Here ``ops._on_card`` answers True for CPU tensors
and the ``*_cuda`` names point at the plain versions (on detached inputs, as
a kernel sees them), so the Functions' code paths run on the CPU: jvp, vjp,
grad, jvp of grad (``hvp``'s forward-over-reverse) and vmap through each
must equal the same transform of the plain version (float32, ≤ 1e-6
relative: the same arithmetic, attention's backward summed over blocks of
queries), with one kernel launch counted a forward.  Then ``ggn_vp`` and
``hvp`` on the reduced StableLM-2 (a ``ScanStack`` of two blocks) through
the Functions equal the plain route, with flash_attention launched twice a
layer (jvp, then vjp) and once (jvp of grad).  No JAX: the reference is the
port's own plain version.
"""
import numpy as np
import pytest
import torch
from _torch_threads import one_torch_thread  # noqa: F401 (autouse)

from repro_torch.configs import get_config
from repro_torch.core import CrossEntropyLoss
from repro_torch.core.tree import tree_leaves, tree_map
from repro_torch.curv import ggn_vp, hvp
from repro_torch.kernels import ops, ref
from repro_torch.nn.models import build_model

TOL = 1e-6


@pytest.fixture
def pretend_card(monkeypatch):
    monkeypatch.setattr(ops, "_on_card", lambda kernel, *xs: True)
    monkeypatch.setattr(ops, "flash_attention_cuda", lambda q, k, v, **kw: ref.flash_attention(
        q.detach(), k.detach(), v.detach(), **kw))
    monkeypatch.setattr(ops, "wkv_cuda", lambda r, k, v, w, u, s0, c: ref.wkv(
        r.detach(), k.detach(), v.detach(), w.detach(), None if u is None else u.detach(),
        None if s0 is None else s0.detach(), c))
    monkeypatch.setattr(ops, "ATTN_GRAD_Q_CHUNK", 4)  # three query blocks at T = 10
    ops.reset_launch_counts()
    yield
    ops.reset_launch_counts()


def _inputs(name):
    gen = torch.Generator().manual_seed(0)

    def rn(*shape):
        return torch.randn(*shape, generator=gen)

    if name == "flash_attention":
        xs = (rn(2, 10, 4, 8), rn(2, 10, 2, 8), rn(2, 10, 2, 8))
        return (xs, lambda *x: ops.flash_attention(*x, window=6),
                lambda *x: ref.flash_attention(*x, window=6))
    xs = (rn(2, 8, 3, 4), rn(2, 8, 3, 4), rn(2, 8, 3, 5), -torch.rand(2, 8, 3, 4, generator=gen),
          rn(3, 4), rn(2, 3, 4, 5))
    # both outputs (y, state): the state's derivatives go through the Function too
    return (xs, lambda *x: ops.wkv(*x, chunk=4), lambda *x: ref.wkv(*x, chunk=4))


def _close(a, b):
    for x, y in zip(tree_leaves(a), tree_leaves(b), strict=True):
        err = ((x - y).abs().max() / y.abs().max()).item()
        assert err <= TOL, err


def _tangents(xs, seed):
    gen = torch.Generator().manual_seed(seed)
    return tuple(torch.randn(x.shape, generator=gen) for x in xs)


def _objective(f):
    return lambda *x: sum((o ** 2).sum() for o in tree_leaves(f(*x)))


KERNELS = ["flash_attention", "wkv"]


@pytest.mark.parametrize("name", KERNELS)
def test_jvp_through_function(pretend_card, name):
    xs, card, plain = _inputs(name)
    ts = _tangents(xs, 1)
    got = torch.func.jvp(card, xs, ts)
    assert ops.launch_counts()[name] == 1
    _close(got, torch.func.jvp(plain, xs, ts))


@pytest.mark.parametrize("name", KERNELS)
def test_vjp_through_function(pretend_card, name):
    xs, card, plain = _inputs(name)
    out, pull = torch.func.vjp(card, *xs)
    assert ops.launch_counts()[name] == 1
    want, pull_plain = torch.func.vjp(plain, *xs)
    _close(out, want)
    cot = tree_map(lambda o: torch.randn(o.shape, generator=torch.Generator().manual_seed(2)),
                   want)
    _close(pull(cot), pull_plain(cot))


@pytest.mark.parametrize("name", KERNELS)
def test_grad_through_function(pretend_card, name):
    xs, card, plain = _inputs(name)
    argnums = tuple(range(len(xs)))
    got = torch.func.grad(_objective(card), argnums)(*xs)
    assert ops.launch_counts()[name] == 1
    _close(got, torch.func.grad(_objective(plain), argnums)(*xs))


@pytest.mark.parametrize("name", KERNELS)
def test_jvp_of_grad_through_function(pretend_card, name):
    """Forward over reverse: the backward's own derivative in forward mode."""
    xs, card, plain = _inputs(name)
    argnums = tuple(range(len(xs)))
    ts = _tangents(xs, 3)
    got = torch.func.jvp(torch.func.grad(_objective(card), argnums), xs, ts)
    assert ops.launch_counts()[name] == 1
    _close(got, torch.func.jvp(torch.func.grad(_objective(plain), argnums), xs, ts))


@pytest.mark.parametrize("name,mapped", [("flash_attention", "first"), ("flash_attention", "all"),
                                          ("wkv", "first"), ("wkv", "all"), ("wkv", "u")])
def test_vmap_through_function(pretend_card, name, mapped):
    """Mapped over the first input (one launch: the axis folds into the
    batch), over every input, or (wkv) over u alone; a mapped u (which the
    kernel shares across the batch) takes a launch a slice."""
    xs, card, plain = _inputs(name)
    idx = {"first": [0], "all": list(range(len(xs))), "u": [4]}[mapped]
    args = tuple(torch.stack([x, x.flip(0) * 0.5, x * 0.9]) if i in idx else x
                 for i, x in enumerate(xs))
    dims = tuple(0 if i in idx else None for i in range(len(xs)))
    got = torch.func.vmap(card, in_dims=dims)(*args)
    assert ops.launch_counts()[name] == (3 if name == "wkv" and 4 in idx else 1)
    _close(got, torch.func.vmap(plain, in_dims=dims)(*args))


def test_vmap_of_jvp_through_attention(pretend_card):
    """``GGNOperator.mv_stacked``'s shape: vmap over tangents of a jvp."""
    xs, card, plain = _inputs("flash_attention")
    T = torch.stack([t for t in _tangents(xs, 4)[:1] * 3]) * torch.tensor([1.0, -2.0, 0.5])[
        :, None, None, None, None]

    def jvp_of(f):
        return lambda tq: torch.func.jvp(f, xs, (tq,) + tuple(torch.zeros_like(x)
                                                               for x in xs[1:]))[1]

    _close(torch.func.vmap(jvp_of(card))(T), torch.func.vmap(jvp_of(plain))(T))


@pytest.fixture(scope="module")
def lm():
    cfg = get_config("stablelm-1.6b").reduced()
    model = build_model(cfg, device="cpu", generator=torch.Generator().manual_seed(0))
    rs = np.random.RandomState(1)
    toks = torch.from_numpy(rs.randint(0, cfg.vocab, (2, 12)).astype(np.int32))
    labels = torch.from_numpy(rs.randint(0, cfg.vocab, (2, 12)).astype(np.int32))
    gen = torch.Generator().manual_seed(2)
    v = tree_map(lambda p: torch.randn(p.shape, generator=gen), model.params())
    return cfg, model, toks, labels, v


@pytest.mark.parametrize("product,per_layer", [(ggn_vp, 2), (hvp, 1)], ids=["ggn_vp", "hvp"])
def test_lm_curvature_products_through_functions(lm, monkeypatch, product, per_layer):
    """The reduced StableLM-2's products through the Functions (the launch
    counts derived: ggn_vp runs the forward under jvp, then under vjp) equal
    the plain route's.  The tangent's dict keys come in the engine's order,
    not the parameters': the products take them in either."""
    cfg, model, toks, labels, v = lm
    params = model.params()
    want = product(model, params, toks, labels, CrossEntropyLoss(), v)
    with monkeypatch.context() as m:
        m.setattr(ops, "_on_card", lambda kernel, *xs: True)
        m.setattr(ops, "flash_attention_cuda", lambda q, k, v_, **kw: ref.flash_attention(
            q.detach(), k.detach(), v_.detach(), **kw))
        ops.reset_launch_counts()
        reordered = tuple({k: c[k] for k in reversed(list(c))} if isinstance(c, dict) else c
                          for c in v)
        got = product(model, params, toks, labels, CrossEntropyLoss(), reordered)
        assert ops.launch_counts() == {k: per_layer * cfg.n_layers if k == "flash_attention"
                                       else 0 for k in ops.KERNELS}
    for a, b in zip(tree_leaves(got), tree_leaves(want), strict=True):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-5, atol=1e-6)
