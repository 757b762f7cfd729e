"""DeepSeek-V2's MLA mixture of experts (``MLAMoEBlock``, the ``moe_mla``
kind): the port on the CPU against the JAX package.

The reduced DeepSeek-V2-Lite (d 64, four heads, kv_lora 32, qk_nope 16,
qk_rope 8, v 16, 4 routed experts top-2 of width 32 and one shared expert,
2 layers, vocabulary 97) from JAX's ``init`` (the norms' gains moved off 1),
carried across with ``bridge.params_from_numpy``; tokens 2 × 8, float32,
every comparison within ``TOL`` of each leaf's largest entry:

* the block's children and their shapes against JAX's, the bridge both
  ways, ``param_count`` and ``active_param_count`` (the published config
  counted by hand);
* the logits, greedy decoding token for token, the absorbed decode chain
  against JAX's chain and, at capacity factor E / top_k where the forward
  drops nothing, against the unabsorbed forward;
* ``run`` with the ten extensions JAX's MLA supports, MC on JAX's draws:
  the port's fused route against JAX's run (computed once, on its plain
  reference) and the port's per-extension route against its fused route;
  the gradient against autograd; KFRA and DiagHessian raise;
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
from repro.core import UnsupportedSweep as JUnsupportedSweep
from repro.data import synthetic as jsyn
from repro.optim import curvature_optimizer as jcurv
from repro.serve.engine import ServeConfig as JServeConfig
from repro.serve.engine import generate as jax_generate
from repro_torch.bridge import params_from_numpy, params_to_numpy
from repro_torch.configs import SHAPES, get_config
from repro_torch.core import CrossEntropyLoss
from repro_torch.core.module import UnsupportedSweep
from repro_torch.core.tree import tree_leaves, tree_map
from repro_torch.launch import serve, train
from repro_torch.nn import MLAMoEBlock
from repro_torch.nn.models import build_model
from repro_torch.nn.moe import dropped, moe_apply
from repro_torch.optim import curvature_optimizer
from repro_torch.serve import ServeConfig, generate
from repro_torch.train import loop

ARCH = "deepseek-v2-lite-16b"
BATCH, SEQ = 2, 8
TEN = ("batch_grad", "batch_l2", "second_moment", "variance", "batch_dot",
       "diag_ggn", "kflr", "ggn_trace", "diag_ggn_mc", "kfac")
EXPERTS = ("e_down", "e_gate", "e_up")
TOL = 1e-5     # float32, sums in another order through two layers
CHAIN_TOL = 2e-4  # tests/test_archs_smoke.py's decode-vs-forward limit
JAX_TRACE_TOL = 1e-4  # JAX's float32 einsum route to GGNTrace against float64


def _close(got, want, tol, what=""):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, what
    scale = max(float(np.abs(want).max()), 1e-30)
    err = float(np.abs(got - want).max()) / scale if want.size else 0.0
    assert err <= tol, f"{what}: {err:.3g} of the largest entry > {tol}"


@pytest.fixture(scope="module")
def mla():
    return _lm(ARCH)


# ---------------------------------------------------------------------------
# the model: its tree, logits, decoding
# ---------------------------------------------------------------------------


def test_mla_block_has_jax_children_and_shapes(mla):
    cfg, jm, jp, pm, pp = mla
    layer = pp[1]
    assert sorted(layer) == sorted(jp[1]) == [
        "dkv", "dq", "e_down", "e_gate", "e_up", "ln1", "ln2", "router",
        "s_down", "s_gate", "s_up", "uk", "uv", "wo"]
    shapes = {"dq": (2, 64, 4 * 24), "dkv": (2, 64, 32 + 8), "uk": (2, 32, 4 * 16),
              "uv": (2, 32, 4 * 16), "wo": (2, 64, 64), "router": (2, 64, 4),
              "e_gate": (2, 4, 64, 32), "e_down": (2, 4, 32, 64),
              "s_gate": (2, 64, 32), "s_down": (2, 32, 64)}
    for k, shape in shapes.items():
        assert tuple(layer[k]["w"].shape) == shape == jp[1][k]["w"].shape, k
    for a, b in zip(tree_leaves(pp), jax.tree.leaves(jp), strict=True):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    for a, b in zip(jax.tree.leaves(params_to_numpy(pp)), jax.tree.leaves(jp), strict=True):
        np.testing.assert_array_equal(a, np.asarray(b))
    blk = MLAMoEBlock(64, 4, 32, 4, 2, kv_lora=32, qk_nope=16, qk_rope=8, v_dim=16,
                      n_shared=0, device="meta")
    assert not {"s_gate", "s_up", "s_down"} & set(blk.children_map)


def test_active_param_count_matches_jax():
    cfg, jcfg = get_config(ARCH).reduced(), jax_get_config(ARCH).reduced()
    assert cfg.param_count() == jcfg.param_count()
    assert cfg.active_param_count() == jcfg.active_param_count()
    # the published config, counted by hand: embedding and untied head, the
    # final norm, and a layer's two norms, dq, dkv, uk, uv, wo, the router,
    # the 64 routed experts and the two shared ones (one GLU of 2 · 1408)
    full = get_config(ARCH)
    meta = build_model(full, device="meta")
    d, v, h, e, de = 2048, 102400, 16, 64, 1408
    layer = (2 * d + d * h * (128 + 64) + d * (512 + 64) + 2 * 512 * h * 128 + h * 128 * d
             + d * e + 3 * e * d * de + 3 * d * 2 * de)
    assert full.param_count(meta) == 2 * v * d + d + 27 * layer == 16_210_311_168
    assert full.active_param_count(meta) == full.param_count(meta) - 27 * (e - 6) * 3 * d * de
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA device"):
            build_model(full)


def test_logits_match_jax(mla, monkeypatch):
    """The forward drops pairs in both layers (capacity 10 for 16 tokens'
    32 pairs), so the masked path is in the comparison."""
    from repro_torch.nn import blocks

    cfg, jm, jp, pm, pp = mla
    toks, _ = _batch(cfg, BATCH, SEQ, 2)
    seen = []

    def spy(call, h, logits, *a):
        seen.append(dropped(logits, cfg.top_k, cfg.capacity_factor))
        return moe_apply(call, h, logits, *a)

    monkeypatch.setattr(blocks, "moe_apply", spy)
    _close(pm.call(pp, _t(toks)).numpy(), jm.apply(jp, jnp.asarray(toks)), TOL)
    assert len(seen) == 2 and min(seen) > 0, seen


def test_greedy_generate_matches_jax(mla):
    cfg, jm, jp, pm, pp = mla
    prompts = np.random.RandomState(3).randint(0, cfg.vocab, (3, 5)).astype(np.int32)
    want = np.asarray(jax_generate(jm, jp, jnp.asarray(prompts), JServeConfig(max_len=14)))
    got = generate(pm, pp, _t(prompts), ServeConfig(max_len=14))
    np.testing.assert_array_equal(got.numpy(), want)


def test_absorbed_decode_chain_matches_jax(mla):
    """The serve_step chain over the compressed cache against JAX's."""
    cfg, jm, jp, pm, pp = mla
    toks, _ = _batch(cfg, BATCH, SEQ, 2)
    jc = jm.init_serve_cache(jp, BATCH, SEQ, jnp.float32)
    pc = pm.init_serve_cache(pp, BATCH, SEQ, torch.float32)
    assert tuple(pc[0]["ckv"].shape) == (2, BATCH, SEQ, 32) == jc[0]["ckv"].shape
    assert tuple(pc[0]["kpe"].shape) == (2, BATCH, SEQ, 8) == jc[0]["kpe"].shape
    assert pc[0]["pos"].tolist() == [[-1] * SEQ] * 2
    jstep = jax.jit(jm.serve_step)
    for t in range(SEQ):
        jl, jc = jstep(jp, jc, jnp.asarray(toks[:, t]), jnp.asarray(t, jnp.int32))
        pl, pc = pm.serve_step(pp, pc, _t(toks[:, t]), t)
        _close(pl.numpy(), jl, TOL, f"step {t}")
    _close(pc[0]["ckv"].numpy(), jc[0]["ckv"], TOL, "ckv")
    _close(pc[0]["kpe"].numpy(), jc[0]["kpe"], TOL, "kpe")
    # past the cache's end the last slot is overwritten, as in JAX (no ring)
    jl, jc = jstep(jp, jc, jnp.asarray(toks[:, 0]), jnp.asarray(SEQ, jnp.int32))
    pl, pc = pm.serve_step(pp, pc, _t(toks[:, 0]), SEQ)
    _close(pl.numpy(), jl, TOL, "past the end")
    assert pc[0]["pos"][0].tolist() == list(range(SEQ - 1)) + [SEQ]


def test_absorbed_decode_chain_matches_the_forward_without_drops(mla):
    """At capacity factor E / top_k = 2 the forward drops nothing, and the
    absorbed chain matches the unabsorbed forward."""
    cfg, jm, jp, _, _ = mla
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


@pytest.fixture(scope="module")
def runs(mla):
    """JAX's run with the ten extensions, once, on its plain reference
    (``use_kernels=False``; ``test_torch_kernels.py`` holds the interpreted
    kernels), and the port's on its fused and per-extension routes, MC on
    JAX's draws."""
    cfg, jm, jp, pm, pp = mla
    toks, labels = _batch(cfg, BATCH, SEQ, 2)
    rng = jax.random.PRNGKey(3)
    want = _jax_run(jm, jp, jnp.asarray(toks), jnp.asarray(labels), TEN, rng=rng,
                    mc_samples=1, use_kernels=False)
    draws = _jax_draws(jnp.asarray(want[2]), jnp.asarray(labels), rng, 1)
    got = {fused: _port_run(pm, pp, _t(toks), labels, TEN, draws=draws, mc_samples=1,
                            use_kernels=True, use_fused=fused) for fused in (True, False)}
    # GGNTrace in float64: JAX's plain reference sums T·V = 776 columns'
    # squares in float32
    f64 = _port_run(pm, tree_map(torch.Tensor.double, pp), _t(toks), labels,
                    ("ggn_trace",), use_kernels=False)["ggn_trace"]
    return (pm, pp, toks, labels), got, want, f64


def test_run_loss_logits_grads_match_jax(runs):
    _, got, (jloss, jgrads, jlogits, _), _ = runs
    np.testing.assert_allclose(got[True].loss.numpy(), jloss, rtol=1e-5)
    _close(got[True].logits.numpy(), jlogits, TOL, "logits")
    for a, b in zip(tree_leaves(got[True].grads), jax.tree.leaves(jgrads), strict=True):
        _close(a.numpy(), b, TOL, "grads")


@pytest.mark.parametrize("name", TEN)
def test_run_extension_matches_jax(runs, name):
    """The fused route against JAX's, each leaf within ``TOL`` of its
    largest entry; the experts carry no per-sample entry.  GGNTrace is held
    to its float64 value instead: JAX's plain reference reads 1.3e-5 of the
    leaf's largest entry from it, which ``JAX_TRACE_TOL`` records."""
    _, got, want, f64 = runs
    res = got[True]
    assert (jax.tree.structure(_np(tree_map(lambda t: t.numpy(), res.ext[name])))
            == jax.tree.structure(want[3][name])), name
    port, ref_ = tree_leaves(res.ext[name]), jax.tree.leaves(want[3][name])
    assert len(port) == len(ref_) and ref_, name
    if name == "ggn_trace":
        for a, b, c in zip(port, ref_, tree_leaves(f64), strict=True):
            _close(a.numpy(), c.numpy(), TOL, f"{name} vs float64")
            _close(b, c.numpy(), JAX_TRACE_TOL, f"JAX's {name} vs float64")
        ref_ = []
    for a, b in zip(port, ref_):
        _close(a.numpy(), b, TOL, name)
    layer = res.ext[name][1]
    if name in ("batch_grad", "batch_l2", "batch_dot", "ggn_trace"):
        assert all(layer[k] == () for k in EXPERTS) and layer["uk"] != (), name
    else:
        assert all(layer[k] != () for k in EXPERTS), name


@pytest.mark.parametrize("name", TEN)
def test_per_extension_route_matches_fused(runs, name):
    _, got, _, _ = runs
    for a, b in zip(tree_leaves(got[False].ext[name]), tree_leaves(got[True].ext[name]),
                    strict=True):
        _close(a.numpy(), b.numpy(), TOL, name)


def test_run_grads_match_autograd(runs):
    (pm, pp, toks, labels), got, _, _ = runs
    tracked = tree_map(lambda p: p.detach().clone().requires_grad_(True), pp)
    lv = CrossEntropyLoss().value(pm.call(tracked, _t(toks)), _t(labels))
    auto = torch.autograd.grad(lv, tree_leaves(tracked))
    for a, b in zip(tree_leaves(got[True].grads), auto, strict=True):
        _close(a.numpy(), b.numpy(), TOL)


@pytest.mark.parametrize("name", ["kfra", "diag_hessian"])
def test_kfra_and_diag_hessian_raise(mla, name):
    cfg, jm, jp, pm, pp = mla
    toks, labels = _batch(cfg, BATCH, SEQ, 2)
    with pytest.raises(JUnsupportedSweep, match="RMSNorm"):
        _jax_run(jm, jp, jnp.asarray(toks), jnp.asarray(labels), (name,))
    with pytest.raises(UnsupportedSweep, match="RMSNorm"):
        _port_run(pm, pp, _t(toks), labels, (name,))


# ---------------------------------------------------------------------------
# training
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", ["adamw", "diag_ggn_mc"])
def test_fit_steps_match_jax(mla, monkeypatch, name):
    """Two ``fit`` steps from the same weights (JAX's ``init`` patched to
    return them) on JAX's batches and, for the MC steps, JAX's draws."""
    from test_torch_loop import _feed, _jax_fit, _leaf_errs, _optimizers

    cfg, jm, jp, pm, pp = mla
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
    (pm, pp, _, _), got, (_, jgrads, _, jext), _ = runs
    res = got[True]
    assert tuple(res.ext["kfac"][1]["e_gate"]["w"]["B"].shape) == (2, 4, 32, 32)
    jparams = jax.tree.map(jnp.asarray, _np(tree_map(lambda t: t.numpy(), pp)))
    jopt = jcurv(0.3, 1e-1, "kfac")
    with pytest.raises(TypeError, match="incompatible shapes"):
        jopt.update(jgrads, jopt.init(jparams), jparams, curv=jext["kfac"])
    opt = curvature_optimizer(0.3, 1e-1, "kfac")
    with pytest.raises(NotImplementedError, match="precond.py:62-64"):
        opt.update(res.grads, opt.init(pp), pp, curv=res.ext["kfac"])
    with pytest.raises(NotImplementedError, match="precond.py:62-64"):
        train.main(["--arch", ARCH, "--seq", "8", "--batch", "2", "--steps", "1",
                    "--optimizer", "kfac", "--device", "cpu"])


@pytest.mark.parametrize("opt,extra", [("adamw", []), ("diag_ggn_mc", ["--track-variance"])])
def test_launcher_trains_deepseek(opt, extra):
    run = train.main(["--arch", ARCH, "--seq", "8", "--batch", "2", "--steps", "2",
                      "--optimizer", opt, "--device", "cpu"] + extra)
    assert run["cfg"].kind == "moe_mla"
    assert all(np.isfinite(h["loss"]) for h in run["history"])
    if extra:
        assert all(np.isfinite(h["variance_mean"]) for h in run["history"])


def test_serve_launcher_serves_deepseek(capsys):
    serve.main(["--arch", ARCH, "--batch", "2", "--prompt-len", "4", "--max-len", "10",
                "--device", "cpu"])
    assert "generated (2, 10) tokens" in capsys.readouterr().out
