"""Mixture-of-experts language models (``capacity``, ``route``,
``moe_apply``, ``BatchedDense``, ``AttnMoEBlock``, the ``moe_gqa`` kind):
the port on the CPU against the JAX package.

The reduced Granite-3.0-1B-A400M (d 64, four heads over two KV heads of 16,
4 experts, top-2, d_expert 32, 2 layers, vocabulary 97) from JAX's ``init``
(the norms' gains moved off 1), carried across with
``bridge.params_from_numpy``; tokens 2 × 8, whose routing drops 3 and 4
(token, slot) pairs in the two layers (capacity 10), so the masked path is
in every sweep:

* ``capacity`` (JAX's ``+ 0.999``, not a ceiling), ``route`` with exact
  ties (the lower expert first, as ``jax.lax.top_k``) and ``moe_apply``
  with overflow, float32 within 1e-6;
* ``BatchedDense``'s ``backward`` (both routes), ``jac_t_mat`` and
  ``curv_backward`` against JAX's; the plain ``fused_first_order``'s R = 1
  closed forms against the materialized G;
* the logits, greedy decoding token for token and the decode chain against
  JAX's chain (and against the forward where nothing is dropped);
* ``run`` with the ten extensions JAX's MoE supports on the fused route (2
  layers) and the per-extension route (1 layer), JAX's run computed once a
  route, MC with JAX's draws: every leaf within ``TOL`` of its largest
  entry, the entry trees equal (no expert entry in BatchGrad, BatchL2,
  BatchDot); the gradient against autograd; KFRA and DiagHessian raise;
* two ``fit`` steps of AdamW and DiagGGN-MC on JAX's batches;
* KFAC on the stacked per-expert factors: JAX's preconditioner fails, the
  port's and the launcher refuse; the launchers on the CPU.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _torch_threads import one_torch_thread  # noqa: F401 (autouse)
from test_torch_lm_backpack import _batch, _jax_draws, _jax_run, _lm, _np, _port_run, _t

from repro.configs import SHAPES as JSHAPES
from repro.configs import get_config as jax_get_config
from repro.core import ExtensionConfig as JConfig
from repro.core import UnsupportedSweep as JUnsupportedSweep
from repro.core import by_name as jby_name
from repro.data import synthetic as jsyn
from repro.nn.layers import BatchedDense as JBatchedDense
from repro.nn.moe import capacity as jcapacity
from repro.nn.moe import moe_apply as jmoe_apply
from repro.nn.moe import route as jroute
from repro.optim import curvature_optimizer as jcurv
from repro.serve.engine import ServeConfig as JServeConfig
from repro.serve.engine import generate as jax_generate
from repro_torch.bridge import params_from_numpy
from repro_torch.configs import SHAPES, get_config
from repro_torch.core import CrossEntropyLoss, ExtensionConfig, by_name, kron
from repro_torch.core.module import UnsupportedSweep
from repro_torch.core.tree import tree_leaves, tree_map
from repro_torch.kernels import ref
from repro_torch.launch import serve, train
from repro_torch.nn import AttnMoEBlock, BatchedDense
from repro_torch.nn.models import build_model
from repro_torch.nn.moe import capacity, dropped, moe_apply, route
from repro_torch.optim import curvature_optimizer
from repro_torch.serve import ServeConfig, generate
from repro_torch.train import loop

ARCH = "granite-moe-1b-a400m"
BATCH, SEQ = 2, 8
TEN = ("batch_grad", "batch_l2", "second_moment", "variance", "batch_dot",
       "diag_ggn", "kflr", "ggn_trace", "diag_ggn_mc", "kfac")
EXPERTS = ("e_down", "e_gate", "e_up")
TOL = 1e-5     # float32, sums in another order through two layers
ROUTE_TOL = 1e-6
JAX_TRACE_TOL = 1e-4  # JAX's float32 einsum route to GGNTrace against float64
CHAIN_TOL = 2e-4  # tests/test_archs_smoke.py's decode-vs-forward limit


def _close(got, want, tol, what=""):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, what
    scale = max(float(np.abs(want).max()), 1e-30)
    err = float(np.abs(got - want).max()) / scale if want.size else 0.0
    assert err <= tol, f"{what}: {err:.3g} of the largest entry > {tol}"


# ---------------------------------------------------------------------------
# routing
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("n,e,k,f", [(16, 4, 2, 1.25), (2, 32, 8, 1.25), (8192, 32, 8, 1.25),
                                     (2000001, 2000, 1, 1.0), (4, 32, 8, 4.0)])
def test_capacity_matches_jax(n, e, k, f):
    """(2000001, 2000, 1, 1.0) has the fraction 0.0005: 1000, where a
    ceiling gives 1001."""
    assert capacity(n, e, k, f) == jcapacity(n, e, k, f)
    assert capacity(2000001, 2000, 1, 1.0) == 1000


def _route_cases():
    rs = np.random.RandomState(0)
    ties = np.tile(np.array([[.1, .3, .3, .2, .3, .1]], np.float32), (5, 1))
    coarse = rs.randint(0, 3, (64, 32)).astype(np.float32)  # many exact ties
    return {"ties": (np.log(ties), 2), "coarse": (coarse, 8),
            "random": (rs.randn(40, 6).astype(np.float32), 3)}


@pytest.mark.parametrize("case", sorted(_route_cases()))
def test_route_matches_jax(case):
    logits, k = _route_cases()[case]
    gates, idx, pos, probs = route(torch.from_numpy(logits), k)
    jg, ji, jpos, jprobs = jax.jit(jroute, static_argnums=1)(jnp.asarray(logits), k)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(ji))
    np.testing.assert_array_equal(pos.numpy(), np.asarray(jpos))
    assert pos.dtype == torch.int32
    _close(gates.numpy(), jg, ROUTE_TOL, "gates")
    _close(probs.numpy(), jprobs, ROUTE_TOL, "probs")
    if case == "ties":  # JAX's order among equal values: the lower index first
        assert idx[0].tolist() == [1, 2]


def _expert_weights(e, d, f, seed):
    rs = np.random.RandomState(seed)
    return {"e_gate": (rs.randn(e, d, f) / np.sqrt(d)).astype(np.float32),
            "e_up": (rs.randn(e, d, f) / np.sqrt(d)).astype(np.float32),
            "e_down": (rs.randn(e, f, d) / np.sqrt(f)).astype(np.float32)}


@pytest.mark.parametrize("case", ["overflow_and_ties", "balanced"])
def test_moe_apply_matches_jax(case):
    """16 tokens, 4 experts, top-2, capacity 10: in ``overflow_and_ties``
    every token's first choice is expert 0 and its second a tie of experts
    1 and 3 (1 wins), so 6 pairs overflow each of experts 0 and 1; in
    ``balanced`` token t prefers expert t mod 4, then t + 1 mod 4: 8 pairs
    an expert, none dropped."""
    e, d, f, k = 4, 8, 6, 2
    rs = np.random.RandomState(1)
    h = rs.randn(2, 8, d).astype(np.float32)
    if case == "overflow_and_ties":
        logits = np.tile(np.array([3.0, 1.0, 0.0, 1.0], np.float32), (2, 8, 1))
    else:
        t = np.arange(16)
        logits = 0.1 * rs.randn(16, e)
        logits[t, t % 4] += 2.0
        logits[t, (t + 1) % 4] += 1.0
        logits = logits.reshape(2, 8, e).astype(np.float32)
    w = _expert_weights(e, d, f, 2)
    got = moe_apply(lambda n, x: torch.bmm(x, torch.from_numpy(w[n])), torch.from_numpy(h),
                    torch.from_numpy(logits), e, k, 1.25, torch.nn.functional.silu)
    want = jax.jit(lambda hh, lg: jmoe_apply(
        lambda n, x: jnp.einsum("eca,eab->ecb", x, w[n]), hh, lg, e, k, 1.25, jax.nn.silu))(
        jnp.asarray(h), jnp.asarray(logits))
    _close(got.numpy(), want, ROUTE_TOL, case)
    n_drop = dropped(torch.from_numpy(logits), k, 1.25)
    assert n_drop == (12 if case == "overflow_and_ties" else 0)
    if case == "overflow_and_ties":  # the dropped pairs add nothing: tokens 10+ see no expert
        assert float(got.reshape(16, d)[10:].abs().max()) == 0.0


# ---------------------------------------------------------------------------
# BatchedDense
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def batched():
    e, cap, a, b = 3, 5, 6, 4
    rs = np.random.RandomState(3)
    w = rs.randn(e, a, b).astype(np.float32)
    x, g = rs.randn(e, cap, a).astype(np.float32), rs.randn(e, cap, b).astype(np.float32)
    S = rs.randn(2, e, cap, b).astype(np.float32)
    pm = BatchedDense(e, a, b, device="cpu")
    pm.w.data.copy_(torch.from_numpy(w))
    return JBatchedDense(e, a, b), {"w": jnp.asarray(w)}, pm, pm.params(), x, g, S


@pytest.mark.parametrize("fused", [True, False])
def test_batched_dense_backward_matches_jax(batched, fused):
    jm, jp, pm, pp, x, g, _ = batched
    names = ("second_moment", "kfac")
    want = jm.backward(jp, jnp.asarray(x), jnp.asarray(g), tuple(jby_name(n) for n in names),
                       JConfig(use_kernels=True, use_fused=fused))
    got = pm.backward(pp, _t(x), _t(g), tuple(by_name(n) for n in names),
                      ExtensionConfig(use_kernels=True, use_fused=fused))
    assert sorted(got[2]) == sorted(want[2]) == ["_kron_a", "_sum_grad2"]
    for a, b_ in zip(tree_leaves(got), jax.tree.leaves(want), strict=True):
        _close(a.numpy(), b_, ROUTE_TOL)
    assert tuple(pm.call(pp, _t(x)).shape) == (3, 5, 4)
    _close(pm.call(pp, _t(x)).numpy(), jm.apply(jp, jnp.asarray(x)), ROUTE_TOL)


@pytest.mark.parametrize("prefix,names", [("exact", ("diag_ggn", "kflr")),
                                          ("mc", ("diag_ggn_mc", "kfac"))])
def test_batched_dense_curv_backward_matches_jax(batched, prefix, names):
    jm, jp, pm, pp, x, _, S = batched
    want = jm.curv_backward(jp, jnp.asarray(x), jnp.asarray(S),
                            tuple(jby_name(n) for n in names), JConfig(), prefix)
    got = pm.curv_backward(pp, _t(x), _t(S), tuple(by_name(n) for n in names),
                           ExtensionConfig(), prefix)
    assert sorted(got[1]) == sorted(want[1]) == sorted(names)
    for a, b_ in zip(tree_leaves(got), jax.tree.leaves(want), strict=True):
        _close(a.numpy(), b_, ROUTE_TOL)
    _close(pm.jac_t_mat(pp, _t(x), _t(S)).numpy(), jm.jac_t_mat(jp, jnp.asarray(x),
                                                                 jnp.asarray(S)), ROUTE_TOL)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_plain_fused_first_order_rank_one_matches_materialized(dtype):
    """The closed forms at R = 1 against G [E, N, a, b] formed and reduced."""
    gen = torch.Generator().manual_seed(4)
    A, B = torch.randn(3, 7, 1, 5, generator=gen), torch.randn(3, 7, 1, 6, generator=gen)
    got = ref.fused_first_order(A, B, want_l2=True, want_moment=True, want_dot=True,
                                dtype=dtype)
    G = torch.einsum("enra,enrb->enab", A.to(dtype), B.to(dtype))
    want = {"l2": (G * G).sum(dim=(2, 3)), "moment": (G * G).sum(dim=1),
            "dot": torch.einsum("enk,emk->enm", G.flatten(2), G.flatten(2))}
    for k in want:
        assert got[k].dtype == dtype and got[k].shape == want[k].shape, k
        _close(got[k].numpy(), want[k].numpy(), 1e-6 if dtype == torch.float32 else 1e-14, k)


# ---------------------------------------------------------------------------
# the model: its tree, logits, decoding
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def granite():
    return _lm(ARCH)


def test_moe_block_has_jax_children_and_no_dense_ffn(granite):
    cfg, jm, jp, pm, pp = granite
    layer = pp[1]
    assert sorted(layer) == sorted(jp[1]) == ["e_down", "e_gate", "e_up", "ln1", "ln2",
                                              "router", "wk", "wo", "wq", "wv"]
    assert tuple(layer["e_gate"]["w"].shape) == (2, 4, 64, 32)   # [L, E, a, b]
    assert tuple(layer["e_down"]["w"].shape) == (2, 4, 32, 64)
    assert tuple(layer["router"]["w"].shape) == (2, 64, 4)
    for a, b in zip(tree_leaves(pp), jax.tree.leaves(jp), strict=True):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    blk = AttnMoEBlock(64, 4, 2, 32, 4, 2, head_dim=16, device="meta")
    assert not {"w_gate", "w_up", "w_down"} & set(blk.children_map)


def test_active_param_count_matches_jax():
    cfg, jcfg = get_config(ARCH).reduced(), jax_get_config(ARCH).reduced()
    assert cfg.param_count() == jcfg.param_count()
    assert cfg.active_param_count() == jcfg.active_param_count()
    # the published config, counted by hand: embedding and untied head, the
    # final norm, and a layer's two norms, attention, router and experts
    full = get_config(ARCH)
    d, v, e, de = 1024, 49155, 32, 512
    layer = 2 * d + d * 1024 + 2 * d * 512 + 1024 * d + d * e + 3 * e * d * de
    assert full.param_count() == 2 * v * d + d + 24 * layer == 1_384_963_072
    assert full.active_param_count() == full.param_count() - 24 * (e - 8) * 3 * d * de
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA device"):
            build_model(get_config(ARCH))


def test_logits_match_jax(granite):
    cfg, jm, jp, pm, pp = granite
    toks, _ = _batch(cfg, BATCH, SEQ, 2)
    _close(pm.call(pp, _t(toks)).numpy(), jm.apply(jp, jnp.asarray(toks)), TOL)


def test_greedy_generate_matches_jax(granite):
    cfg, jm, jp, pm, pp = granite
    prompts = np.random.RandomState(3).randint(0, cfg.vocab, (3, 5)).astype(np.int32)
    want = np.asarray(jax_generate(jm, jp, jnp.asarray(prompts), JServeConfig(max_len=14)))
    got = generate(pm, pp, _t(prompts), ServeConfig(max_len=14))
    np.testing.assert_array_equal(got.numpy(), want)


def test_decode_chain_matches_jax(granite):
    """The serve_step chain against JAX's (the forward of these 16 tokens
    drops pairs that a step of 2 never does, so it is not the reference
    here)."""
    cfg, jm, jp, pm, pp = granite
    toks, _ = _batch(cfg, BATCH, SEQ, 2)
    jc = jm.init_serve_cache(jp, BATCH, SEQ, jnp.float32)
    pc = pm.init_serve_cache(pp, BATCH, SEQ, torch.float32)
    jstep = jax.jit(jm.serve_step)
    for t in range(SEQ):
        jl, jc = jstep(jp, jc, jnp.asarray(toks[:, t]), jnp.asarray(t, jnp.int32))
        pl, pc = pm.serve_step(pp, pc, _t(toks[:, t]), t)
        _close(pl.numpy(), jl, TOL, f"step {t}")


def test_decode_chain_matches_the_forward_without_drops(granite):
    """At capacity factor E / top_k = 2 the forward drops nothing (capacity
    16 for 16 tokens), and the chain matches it."""
    cfg, jm, jp, _, _ = granite
    cfg = dataclasses.replace(cfg, capacity_factor=cfg.n_experts / cfg.top_k)
    pm = build_model(cfg, device="cpu")
    pp = params_from_numpy(pm, _np(jp), device="cpu")
    toks, _ = _batch(cfg, BATCH, SEQ, 2)
    full = pm.call(pp, _t(toks))
    pc = pm.init_serve_cache(pp, BATCH, SEQ, torch.float32)
    for t in range(SEQ):
        pl, pc = pm.serve_step(pp, pc, _t(toks[:, t]), t)
        _close(pl.numpy(), full[:, t].numpy(), CHAIN_TOL, f"step {t} vs the forward")


# ---------------------------------------------------------------------------
# BackPACK's run
# ---------------------------------------------------------------------------


# (use_fused, the reduced config's changes); the port's routes take use_kernels=True
ROUTES = {"fused": (True, {}), "per_extension": (False, {"n_layers": 1})}


@pytest.fixture(scope="module", params=sorted(ROUTES))
def runs(request):
    """JAX's run and the port's with the ten extensions, once a route, the
    per-extension route at one layer.  JAX's run takes its fused route with
    its kernels (interpreted), and for the per-extension route its plain
    reference (``use_kernels=False``): the interpreted per-extension
    kernels took 29 s to compile there, the plain reference 8 s."""
    fused, changes = ROUTES[request.param]
    cfg, jm, jp, pm, pp = _lm(ARCH, **changes)
    toks, labels = _batch(cfg, BATCH, SEQ, 2)
    rng = jax.random.PRNGKey(3)
    want = _jax_run(jm, jp, jnp.asarray(toks), jnp.asarray(labels), TEN, rng=rng,
                    mc_samples=1, use_fused=fused, use_kernels=fused)
    draws = _jax_draws(jnp.asarray(want[2]), jnp.asarray(labels), rng, 1)
    got = _port_run(pm, pp, _t(toks), labels, TEN, draws=draws, mc_samples=1,
                    use_kernels=True, use_fused=fused)
    f64 = None
    if not fused:  # GGNTrace in float64: JAX's einsum route sums 6.4M float32 squares
        f64 = _port_run(pm, tree_map(torch.Tensor.double, pp), _t(toks), labels,
                        ("ggn_trace",), use_kernels=False)["ggn_trace"]
    return request.param, (pm, pp, toks, labels), got, want, f64


def test_run_loss_logits_grads_match_jax(runs):
    _, _, got, (jloss, jgrads, jlogits, _), _ = runs
    np.testing.assert_allclose(got.loss.numpy(), jloss, rtol=1e-5)
    _close(got.logits.numpy(), jlogits, TOL, "logits")
    for a, b in zip(tree_leaves(got.grads), jax.tree.leaves(jgrads), strict=True):
        _close(a.numpy(), b, TOL, "grads")


@pytest.mark.parametrize("name", TEN)
def test_run_extension_matches_jax(runs, name):
    """Each leaf within ``TOL`` of JAX's.  GGNTrace on the per-extension
    route is held to its float64 value instead: JAX's plain reference there
    sums the [C, N, a, b] squares (C = T·V = 776 columns) in float32 and
    reads up to 4.6e-5 of the leaf's largest entry from float64 (the port's
    sum 4.3e-7), which ``JAX_TRACE_TOL`` records."""
    route_, _, got, want, f64 = runs
    assert (jax.tree.structure(_np(tree_map(lambda t: t.numpy(), got.ext[name])))
            == jax.tree.structure(want[3][name])), name
    port, ref_ = tree_leaves(got.ext[name]), jax.tree.leaves(want[3][name])
    assert len(port) == len(ref_) and ref_, name
    if name == "ggn_trace" and f64 is not None:
        for a, b, c in zip(port, ref_, tree_leaves(f64), strict=True):
            _close(a.numpy(), c.numpy(), TOL, f"{route_} {name} vs float64")
            _close(b, c.numpy(), JAX_TRACE_TOL, f"JAX's {route_} {name} vs float64")
        ref_ = []
    for a, b in zip(port, ref_):
        _close(a.numpy(), b, TOL, f"{route_} {name}")
    layer = got.ext[name][1]
    if name in ("batch_grad", "batch_l2", "batch_dot", "ggn_trace"):
        assert all(layer[k] == () for k in EXPERTS) and layer["router"] != (), name
    else:
        assert all(layer[k] != () for k in EXPERTS), name


def test_run_grads_match_autograd(runs):
    _, (pm, pp, toks, labels), got, _, _ = runs
    tracked = tree_map(lambda p: p.detach().clone().requires_grad_(True), pp)
    lv = CrossEntropyLoss().value(pm.call(tracked, _t(toks)), _t(labels))
    auto = torch.autograd.grad(lv, tree_leaves(tracked))
    for a, b in zip(tree_leaves(got.grads), auto, strict=True):
        _close(a.numpy(), b.numpy(), TOL)


@pytest.mark.parametrize("name", ["kfra", "diag_hessian"])
def test_kfra_and_diag_hessian_raise(granite, name):
    cfg, jm, jp, pm, pp = granite
    toks, labels = _batch(cfg, BATCH, SEQ, 2)
    with pytest.raises(JUnsupportedSweep, match="RMSNorm"):
        _jax_run(jm, jp, jnp.asarray(toks), jnp.asarray(labels), (name,))
    with pytest.raises(UnsupportedSweep, match="RMSNorm"):
        _port_run(pm, pp, _t(toks), labels, (name,))


# ---------------------------------------------------------------------------
# training
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", ["adamw", "diag_ggn_mc"])
def test_fit_steps_match_jax(granite, monkeypatch, name):
    """Two ``fit`` steps from the same weights (JAX's ``init`` patched to
    return them) on JAX's batches and, for the MC steps, JAX's draws."""
    from test_torch_loop import _feed, _jax_fit, _leaf_errs, _optimizers

    cfg, jm, jp, pm, pp = granite
    jshape = dataclasses.replace(JSHAPES["train_4k"], seq_len=SEQ, global_batch=BATCH)
    jcfg = jax_get_config(ARCH).reduced()
    s = dict(jmodel=jm, jcfg=jcfg, jshape=jshape,
             batches=[jax.tree.map(np.asarray, jsyn.batch_for(jcfg, jshape, i))
                      for i in range(2)])
    (jopt, jexts, jext_cfg, _), (opt, exts, ext_cfg, _) = _optimizers(name, jm, pm)
    monkeypatch.setattr(jm, "init", lambda key: jp)
    (jparams, _, jhist, _), draws = _jax_fit(s, monkeypatch, jopt, jexts, jext_cfg, None,
                                             steps=2)
    _feed(monkeypatch, s, draws if jexts else None)
    got, _, hist, _ = loop.fit(pm, cfg, dataclasses.replace(SHAPES["train_4k"], seq_len=SEQ,
                                                            global_batch=BATCH), opt,
                               loop.LoopConfig(steps=2, log_every=100), extensions=exts,
                               ext_cfg=ext_cfg, log_fn=lambda *_: None,
                               params=tree_map(torch.clone, pp))
    np.testing.assert_allclose([h["loss"] for h in hist], [h["loss"] for h in jhist],
                               rtol=1e-5)
    assert max(_leaf_errs(got, jparams, whole_tree=name == "adamw")) <= 1e-4


def test_kfac_on_per_expert_factors_fails_in_jax_and_is_refused(runs):
    """JAX's preconditioner vmaps once over a B of 3 dimensions; the stacked
    experts' B is [L, E, b, b] (``src/repro/optim/precond.py:62-64``).  The
    port refuses, naming that fault, in the optimizer and the launcher."""
    route_, (pm, pp, _, _), got, (_, jgrads, _, jext), _ = runs
    jparams = jax.tree.map(jnp.asarray, _np(tree_map(lambda t: t.numpy(), pp)))
    if route_ == "fused":  # two layers: the stacked factors
        assert tuple(got.ext["kfac"][1]["e_gate"]["w"]["B"].shape) == (2, 4, 32, 32)
        jopt = jcurv(0.3, 1e-1, "kfac")
        with pytest.raises(TypeError, match="incompatible shapes"):
            jopt.update(jgrads, jopt.init(jparams), jparams, curv=jext["kfac"])
        opt = curvature_optimizer(0.3, 1e-1, "kfac")
        with pytest.raises(NotImplementedError, match="precond.py:62-64"):
            opt.update(got.grads, opt.init(pp), pp, curv=got.ext["kfac"])
        with pytest.raises(NotImplementedError, match="precond.py:62-64"):
            train.main(["--arch", ARCH, "--seq", "8", "--batch", "2", "--steps", "1",
                        "--optimizer", "kfac", "--device", "cpu"])
    else:  # one layer: B [E, b, b], solved expert by expert as JAX's vmap does
        opt = curvature_optimizer(0.3, 1e-1, "kfac")
        ups, _ = opt.update(got.grads, opt.init(pp), pp, curv=got.ext["kfac"])
        c, g = got.ext["kfac"][1]["e_gate"]["w"], got.grads[1]["e_gate"]["w"]
        want = torch.stack([kron.kron_solve(c["A"][i], c["B"][i], g[i], 1e-1)
                            for i in range(g.shape[0])])
        _close(ups[1]["e_gate"]["w"].numpy(), -0.3 * want.numpy(), 1e-6, "e_gate")


@pytest.mark.parametrize("opt,extra", [("adamw", []), ("momentum", []),
                                       ("diag_ggn_mc", ["--track-variance"]), ("cg_ngd", [])])
def test_launcher_trains_granite(opt, extra):
    run = train.main(["--arch", ARCH, "--seq", "8", "--batch", "2", "--steps", "2",
                      "--optimizer", opt, "--cg-iters", "2", "--device", "cpu"] + extra)
    assert run["cfg"].kind == "moe_gqa"
    assert all(np.isfinite(h["loss"]) for h in run["history"])
    if extra:
        assert all(np.isfinite(h["variance_mean"]) for h in run["history"])


def test_serve_launcher_serves_granite(capsys):
    serve.main(["--arch", ARCH, "--batch", "2", "--prompt-len", "4", "--max-len", "10",
                "--device", "cpu"])
    assert "generated (2, 10) tokens" in capsys.readouterr().out
    serve.main(["--arch", ARCH, "--batch", "2", "--prompt-len", "4", "--uncertainty",
                "--device", "cpu"])
    assert "served mean+variance" in capsys.readouterr().out
