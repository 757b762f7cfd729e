"""BackPACK ``run`` on language models: the port on the CPU against the JAX
package.

Tokens and labels (a few positions masked with −1) come from numpy with a
seed; the weights are JAX's ``init`` carried across with
``repro_torch.bridge.params_from_numpy``; MC sweeps take JAX's own draws
(``fold_in(rng, sample index)``), passed in as the port's ``rng``.  Every
statistic is held leaf by leaf:

* reduced StableLM-2 (LayerNorm, partial RoPE, qkv biases; its two layers a
  ``ScanStack``) with every first-order extension, on the fused route and
  the per-extension route (``use_fused=False``), and without kernels: the
  oracle of ``tests/test_system.py``'s Fig. 1 workflow, value by value;
* the exact sweep (DiagGGN, KFLR, GGNTrace) on reduced StableLM-2 through
  ``class_chunk``;
* reduced Gemma-3 (GeGLU, a window-8 and a global layer) with KFAC and
  DiagGGN-MC under JAX's draws, and a nested stack of it (a ``ScanStack``
  of a ``Sequential`` holding a ``ScanStack``);
* reduced Hymba (attention and the SSD scan: wkv's gradient) with the
  first-order extensions and DiagGGN-MC;
* internvl2 through ``PrefixEmbed``: the gradient reaches the prefix;
* the ``ScanStack`` cases of ``tests/test_combinators.py`` with a ``Wired``
  block (a gated mixer, since ``Residual`` / ``Parallel`` are not ported):
  grads against autograd, per-sample grads ``[N, L, ...]`` against autograd
  per sample, the deep DiagGGN against JAX, MC against the exact diagonal;
* the card's two ``autograd.Function``s (attention, WKV), run here with the
  kernels' names pointed at their plain versions: their backward against
  autograd through the plain version, the forward of a call that needs a
  gradient counted as a kernel launch.

Tolerances: 1e-5 relative on the loss, 1e-4 on grads and statistics (float32,
sums in another order through up to three layers), stated per call.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.core import CrossEntropyLoss as JCrossEntropy
from repro.core import Dense as JDense
from repro.core import ExtensionConfig as JConfig
from repro.core import RMSNorm as JRMSNorm
from repro.core import ScanStack as JScanStack
from repro.core import Sequential as JSequential
from repro.core import by_name as jby_name
from repro.core import Embedding as JEmbedding
from repro.core import run as jrun
from repro.nn.models import build_model as jax_build_model
from repro.nn.wired import Wired as JWired
from repro_torch.bridge import params_from_numpy
from repro_torch.configs import get_config
from repro_torch.core import CrossEntropyLoss, ExtensionConfig, by_name, run
from repro_torch.core.module import Dense, Embedding, RMSNorm, ScanStack, Sequential
from repro_torch.core.tree import tree_leaves, tree_map
from repro_torch.kernels import ops as kops
from repro_torch.kernels import ref
from repro_torch.nn.models import build_model
from repro_torch.nn.wired import Wired

FIRST = ("batch_grad", "batch_l2", "second_moment", "variance", "batch_dot")
EXACT = ("diag_ggn", "kflr", "ggn_trace")
MC = ("diag_ggn_mc", "kfac")
TOL = 1e-4


def _t(a):
    return torch.tensor(np.asarray(a))


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _jax_draws(logits, labels, rng, k):
    """JAX's CE MC draws [k, N, T], made as ``sqrt_hessian_mc`` makes them."""
    keys = jax.vmap(jax.random.fold_in, in_axes=(None, 0))(rng, jnp.arange(logits.shape[0]))
    draw = jax.vmap(lambda key, zn, yn: jax.random.categorical(
        key, zn, axis=-1, shape=(k,) + yn.shape))
    return np.asarray(jnp.moveaxis(draw(keys, logits.astype(jnp.float32), labels), 1, 0))


def _batch(cfg, n, t, seed, masked=3):
    rs = np.random.RandomState(seed)
    toks = rs.randint(0, cfg.vocab, (n, t)).astype(np.int32)
    labels = rs.randint(0, cfg.vocab, (n, t)).astype(np.int32)
    labels.reshape(-1)[rs.choice(n * t, masked, replace=False)] = -1
    return toks, labels


def _jax_run(model, params, x, y, names, rng=None, **cfg):
    exts = tuple(jby_name(e) for e in names)
    jcfg = JConfig(**{"use_kernels": True, **cfg})

    @jax.jit
    def go(p, xx, yy):
        r = jrun(model, p, xx, yy, JCrossEntropy(), extensions=exts, cfg=jcfg, rng=rng)
        return r.loss, r.grads, r.logits, r.ext

    return jax.tree.map(np.asarray, go(params, x, y))


def _port_run(model, params, x, y, names, draws=None, **cfg):
    return run(model, params, x, _t(y), CrossEntropyLoss(),
               extensions=tuple(by_name(e) for e in names), cfg=ExtensionConfig(**cfg),
               rng=None if draws is None else _t(draws))


def _assert_matches(res, want, names, tol=TOL):
    jloss, jgrads, jlogits, jext = want
    np.testing.assert_allclose(res.loss.numpy(), jloss, rtol=1e-5)
    np.testing.assert_allclose(res.logits.numpy(), jlogits, rtol=tol, atol=tol)
    for a, b in zip(tree_leaves(res.grads), jax.tree.leaves(jgrads), strict=True):
        np.testing.assert_allclose(a.numpy(), b, rtol=tol, atol=tol * 1e-2)
    assert set(res.ext) == set(names)
    for name in names:
        port, ref_ = tree_leaves(res.ext[name]), jax.tree.leaves(jext[name])
        assert len(port) == len(ref_) and ref_, name
        for a, b in zip(port, ref_):
            assert tuple(a.shape) == b.shape, name
            scale = max(float(np.abs(b).max()), 1e-12)
            np.testing.assert_allclose(a.numpy() / scale, b / scale, rtol=tol, atol=tol,
                                       err_msg=name)


def _autograd_grads(pm, pp, tok, y):
    """autograd's gradient of the masked mean loss through ``pm.call``, in
    ``tree_leaves`` order."""
    tracked = tree_map(lambda p: p.detach().clone().requires_grad_(True), pp)
    loss = CrossEntropyLoss().value(pm.call(tracked, _t(tok)), _t(y))
    return torch.autograd.grad(loss, tree_leaves(tracked))


_LMS = {}


def _lm(arch, **replace):
    """(JAX cfg, JAX model, JAX params, port model, port params), built once."""
    key = (arch, repr(sorted(replace.items())))
    if key not in _LMS:
        jcfg = dataclasses.replace(jax_get_config(arch).reduced(), **replace)
        pcfg = dataclasses.replace(get_config(arch).reduced(), **replace)
        jm, pm = jax_build_model(jcfg), build_model(pcfg, device="cpu")
        jp = jm.init(jax.random.PRNGKey(0))
        # the norms' ones and the biases' zeros at init hide a mix-up
        rs = np.random.RandomState(1)
        jp = jax.tree.map(lambda a: jnp.asarray(np.asarray(a, np.float32) + 0.1 * rs.randn(
            *a.shape).astype(np.float32)) if a.shape[-1:] == (jcfg.d_model,) and a.ndim <= 2
            else a, jp)
        _LMS[key] = (jcfg, jm, jp, pm, params_from_numpy(pm, _np(jp), device="cpu"))
    return _LMS[key]


# ---------------------------------------------------------------------------
# reduced StableLM-2: the first-order sweep on every route, the exact sweep
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def stablelm_first():
    cfg, jm, jp, pm, pp = _lm("stablelm-1.6b")
    toks, labels = _batch(cfg, 4, 16, 2)
    want = _jax_run(jm, jp, jnp.asarray(toks), jnp.asarray(labels), FIRST)
    return cfg, pm, pp, toks, labels, want


ROUTES = {"fused": dict(use_kernels=True, use_fused=True),
          "per_extension": dict(use_kernels=True, use_fused=False),
          "einsum": dict(use_kernels=False)}


@pytest.mark.parametrize("route", sorted(ROUTES))
def test_stablelm_first_order_matches_jax(stablelm_first, route):
    cfg, pm, pp, toks, labels, want = stablelm_first
    res = _port_run(pm, pp, _t(toks), labels, FIRST, **ROUTES[route])
    _assert_matches(res, want, FIRST)
    # the Fig. 1 workflow's own checks: Σ_n batch_grad = grad, variance ≥ 0
    for bg, g in zip(tree_leaves(res["batch_grad"]), tree_leaves(res.grads)):
        np.testing.assert_allclose(bg.sum(0).numpy(), g.numpy(), rtol=TOL, atol=1e-6)
    assert all(float(v.min()) > -1e-6 for v in tree_leaves(res["variance"]))


def test_stablelm_grads_match_autograd_through_call(stablelm_first):
    cfg, pm, pp, toks, labels, _ = stablelm_first
    res = _port_run(pm, pp, _t(toks), labels, ())
    grads = _autograd_grads(pm, pp, toks, labels)
    for a, b in zip(tree_leaves(res.grads), grads, strict=True):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=TOL, atol=1e-7)


def test_stablelm_exact_sweep_in_class_chunks_matches_jax():
    cfg, jm, jp, pm, pp = _lm("stablelm-1.6b")
    toks, labels = _batch(cfg, 2, 6, 3, masked=2)
    chunk = cfg.vocab  # T·V = 582 columns in 6 chunks
    want = _jax_run(jm, jp, jnp.asarray(toks), jnp.asarray(labels), EXACT, class_chunk=chunk)
    res = _port_run(pm, pp, _t(toks), labels, EXACT, class_chunk=chunk)
    _assert_matches(res, want, EXACT)


# ---------------------------------------------------------------------------
# reduced Gemma-3: KFAC and DiagGGN-MC under JAX's draws
# ---------------------------------------------------------------------------


GEMMA = {"pattern": {},  # [(8, 1), (None, 1)]: a Sequential of two blocks
         "nested": dict(n_layers=6, window_segments=[(4, 2), (None, 1)], pattern_repeat=2)}


@pytest.mark.parametrize("use_fused", [True, False], ids=["fused", "per_extension"])
@pytest.mark.parametrize("layout", sorted(GEMMA))
def test_gemma3_kfac_and_diag_ggn_mc_match_jax(layout, use_fused):
    cfg, jm, jp, pm, pp = _lm("gemma3-12b", **GEMMA[layout])
    toks, labels = _batch(cfg, 2, 12, 4)
    rng = jax.random.PRNGKey(5)
    want = _jax_run(jm, jp, jnp.asarray(toks), jnp.asarray(labels), MC, rng=rng,
                    mc_samples=1, use_fused=use_fused)
    draws = _jax_draws(jnp.asarray(want[2]), jnp.asarray(labels), rng, 1)
    res = _port_run(pm, pp, _t(toks), labels, MC, draws=draws, mc_samples=1,
                    use_fused=use_fused)
    _assert_matches(res, want, MC)
    assert all(float(v.min()) >= 0 for v in tree_leaves(res["diag_ggn_mc"]))
    emb = res["kfac"][0]["emb"]["w"]  # the Embedding's diagonal A: token counts / N·T
    assert set(emb) == {"A", "A_diag", "B"} and abs(float(emb["A_diag"].sum()) - 1) < 1e-6


# ---------------------------------------------------------------------------
# reduced Hymba (wkv's gradient) and internvl2's prefix
# ---------------------------------------------------------------------------


def test_hymba_first_order_and_mc_match_jax():
    cfg, jm, jp, pm, pp = _lm("hymba-1.5b")
    toks, labels = _batch(cfg, 2, 16, 6)
    names = FIRST + ("diag_ggn_mc",)
    rng = jax.random.PRNGKey(7)
    want = _jax_run(jm, jp, jnp.asarray(toks), jnp.asarray(labels), names, rng=rng,
                    mc_samples=1)
    draws = _jax_draws(jnp.asarray(want[2]), jnp.asarray(labels), rng, 1)
    res = _port_run(pm, pp, _t(toks), labels, names, draws=draws, mc_samples=1)
    _assert_matches(res, want, names)


def test_internvl2_prefix_run_matches_jax():
    cfg, jm, jp, pm, pp = _lm("internvl2-2b")
    toks, _ = _batch(cfg, 2, 6, 8)
    prefix = np.random.RandomState(9).randn(2, cfg.n_prefix, cfg.d_model).astype(np.float32)
    labels = np.random.RandomState(10).randint(0, cfg.vocab, (2, cfg.n_prefix + 6))
    labels[:, :cfg.n_prefix] = -1  # no loss on the image rows
    labels = labels.astype(np.int32)
    names = ("batch_grad", "variance")
    want = _jax_run(jm, jp, {"tokens": jnp.asarray(toks), "prefix": jnp.asarray(prefix)},
                    jnp.asarray(labels), names)
    res = _port_run(pm, pp, {"tokens": _t(toks), "prefix": _t(prefix)}, labels, names)
    _assert_matches(res, want, names)


# ---------------------------------------------------------------------------
# ScanStack through a Wired block (tests/test_combinators.py's cases)
# ---------------------------------------------------------------------------


V, D, T, N, L = 11, 8, 5, 4, 2


class _JGated(JWired):
    def __init__(self):
        self.children_map = {"norm": JRMSNorm(D), "a": JDense(D, D),
                             "b": JDense(D, D, use_bias=False), "out": JDense(D, D)}

    def wire(self, call, params, x):
        h = call("norm", x)
        return x + call("out", call("a", h) * jax.nn.sigmoid(call("b", h)))


class _PGated(Wired):
    def __init__(self, device="cpu"):
        super().__init__()
        self.set_children({"norm": RMSNorm(D, device=device), "a": Dense(D, D, device=device),
                           "b": Dense(D, D, use_bias=False, device=device),
                           "out": Dense(D, D, device=device)})

    def wire(self, call, params, x):
        h = call("norm", x)
        return x + call("out", call("a", h) * torch.sigmoid(call("b", h)))


@pytest.fixture(scope="module")
def scan_setup():
    jm = JSequential([JEmbedding(V, D), JScanStack(_JGated(), L), JRMSNorm(D),
                      JDense(D, V, use_bias=False)])
    pm = Sequential([Embedding(V, D, device="cpu"), ScanStack(_PGated, L, device="cpu"),
                     RMSNorm(D, device="cpu"), Dense(D, V, use_bias=False, device="cpu")])
    jp = jm.init(jax.random.PRNGKey(0))
    rs = np.random.RandomState(1)
    jp = jax.tree.map(lambda a: jnp.asarray(np.asarray(a) + 0.1 * rs.randn(*a.shape)
                                            .astype(np.float32)), jp)
    pp = params_from_numpy(pm, _np(jp), device="cpu")
    tok = rs.randint(0, V, (N, T)).astype(np.int32)
    y = rs.randint(0, V, (N, T)).astype(np.int32)
    names = FIRST + ("diag_ggn",)
    res = _port_run(pm, pp, _t(tok), y, names)
    return jm, jp, pm, pp, tok, y, names, res




def test_scanstack_grads_match_autograd(scan_setup):
    _, _, pm, pp, tok, y, _, res = scan_setup
    for a, b in zip(tree_leaves(res.grads), _autograd_grads(pm, pp, tok, y), strict=True):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=2e-4, atol=1e-6)


def test_scanstack_batch_grad_is_sample_then_layer(scan_setup):
    """Per-sample stats of scan-stacked params are [N, L, ...]: each sample's
    row is autograd's gradient of that sample's share of the mean loss."""
    _, _, pm, pp, tok, y, _, res = scan_setup
    stack_bg = res["batch_grad"][1]["a"]["w"]
    assert tuple(stack_bg.shape) == (N, L, D, D)
    for n in range(N):
        yn = np.full_like(y, -1)
        yn[n] = y[n]
        # the sample's labels alone, rescaled from its own mean to the batch's
        gn = _autograd_grads(pm, pp, tok, yn)
        for a, b in zip(tree_leaves(res["batch_grad"]), gn, strict=True):
            np.testing.assert_allclose(a[n].numpy(), b.numpy() / N, rtol=2e-4, atol=1e-6)


def test_scanstack_sweeps_match_jax(scan_setup):
    jm, jp, _, _, tok, y, names, res = scan_setup
    want = _jax_run(jm, jp, jnp.asarray(tok), jnp.asarray(y), names)
    _assert_matches(res, want, names)


def test_scanstack_mc_tracks_the_exact_diagonal(scan_setup):
    _, _, pm, pp, tok, y, _, res = scan_setup
    mc = run(pm, pp, _t(tok), _t(y), CrossEntropyLoss(), extensions=(by_name("diag_ggn_mc"),),
             cfg=ExtensionConfig(mc_samples=64), rng=torch.Generator().manual_seed(9))
    a = torch.cat([v.reshape(-1) for v in tree_leaves(mc["diag_ggn_mc"])])
    b = torch.cat([v.reshape(-1) for v in tree_leaves(res["diag_ggn"])])
    assert np.corrcoef(a.numpy(), b.numpy())[0, 1] > 0.95


# ---------------------------------------------------------------------------
# the card's autograd Functions, with the kernels' names at the plain versions
# ---------------------------------------------------------------------------


@pytest.fixture
def pretend_card(monkeypatch):
    """``ops`` taking CPU tensors for the card's, the ``*_cuda`` names
    pointed at the plain versions: the Functions' code paths run here."""
    monkeypatch.setattr(kops, "_on_card", lambda kernel, *xs: True)
    monkeypatch.setattr(kops, "flash_attention_cuda", lambda q, k, v, **kw: ref.flash_attention(
        q.detach(), k.detach(), v.detach(), **kw))
    monkeypatch.setattr(kops, "wkv_cuda", lambda r, k, v, w, u, s0, c: ref.wkv(
        r.detach(), k.detach(), v.detach(), w.detach(), None if u is None else u.detach(),
        None if s0 is None else s0.detach(), c))
    kops.reset_launch_counts()
    yield
    kops.reset_launch_counts()


def _grads_of(fn, xs, seed):
    xs = [x.detach().clone().requires_grad_(True) for x in xs]
    out = fn(*xs)
    out = out if isinstance(out, tuple) else (out,)
    gen = torch.Generator().manual_seed(seed)
    cot = [torch.randn(o.shape, generator=gen) for o in out]
    return torch.autograd.grad(out, xs, cot)


@pytest.mark.parametrize("window", [None, 5])
def test_attention_function_backward_matches_plain(pretend_card, monkeypatch, window):
    monkeypatch.setattr(kops, "ATTN_GRAD_Q_CHUNK", 4)  # three query blocks at T = 10
    gen = torch.Generator().manual_seed(0)
    q, k, v = (torch.randn(2, 10, 4, 8, generator=gen), torch.randn(2, 10, 2, 8, generator=gen),
               torch.randn(2, 10, 2, 8, generator=gen))

    def plain(q, k, v):
        return ref.flash_attention(q, k, v, window=window)

    def card(q, k, v):
        return kops.flash_attention(q, k, v, window=window)

    for a, b in zip(_grads_of(card, (q, k, v), 1), _grads_of(plain, (q, k, v), 1)):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-5, atol=1e-6)
    assert kops.launch_counts()["flash_attention"] == 1  # the forward, on the kernel
    with torch.no_grad():
        kops.flash_attention(q, k, v)
    assert kops.launch_counts()["flash_attention"] == 2


def test_wkv_function_backward_matches_plain(pretend_card):
    gen = torch.Generator().manual_seed(2)
    r, k = torch.randn(2, 8, 2, 4, generator=gen), torch.randn(2, 8, 2, 4, generator=gen)
    v = torch.randn(2, 8, 2, 6, generator=gen)
    log_w = -torch.rand(2, 8, 2, 4, generator=gen) - 0.1
    u = torch.randn(2, 4, generator=gen)
    s0 = torch.randn(2, 2, 4, 6, generator=gen)

    def plain(*xs):
        return ref.wkv(*xs, 4)

    def card(*xs):
        return kops.wkv(*xs, 4)

    xs = (r, k, v, log_w, u, s0)
    for a, b in zip(_grads_of(card, xs, 3), _grads_of(plain, xs, 3)):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-5, atol=1e-6)
    assert kops.launch_counts()["wkv"] == 1
