"""Whisper, the encoder-decoder (``WhisperModel``, ``EncBlock``,
``DecBlock``, ``sinusoid_pos``, ``generate_whisper``): the port on the CPU
against the JAX package.

The reduced whisper-tiny (d 64, four heads of 16, 2 encoder and 2 decoder
layers, so the decoder's (y, enc) carry crosses a layer; ``dec_len`` 8;
``pos_dec`` 448 rows) from JAX's ``init`` with every leaf moved off its
start by 0.1·N(0, 1) (biases at 0 and norms at 1 would hide a mix-up),
carried across with ``bridge.params_from_numpy``; the inputs are JAX's
``batch_for`` at 16 frames and 2 sequences:

* ``sinusoid_pos``, the logits, ``encode``, the serve_step chain (against
  JAX's serve_step and the forward, 2e-4 as ``tests/test_archs_smoke.py``)
  and ``generate_whisper``'s greedy tokens (equal);
* ``run`` with the ten extensions JAX's Whisper supports, JAX's run computed
  once for the module, the MC draws JAX's: every leaf within ``TOL`` of its
  largest entry; the gradient against autograd; KFRA and DiagHessian raise
  on both sides;
* one ``fit`` step of AdamW and of DiagGGN-MC on JAX's batch and draws;
* the training and serving launchers and the serving example on the CPU;
* the ``Wired`` repair on a small block that carries a tuple, inside a root
  ``Wired`` that holds its ``ScanStack``: every sweep against autograd.
"""
import dataclasses
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _torch_threads import one_torch_thread  # noqa: F401 (autouse)
from test_torch_lm_backpack import TOL, _jax_draws, _jax_run, _np, _port_run, _t

from repro.configs import SHAPES as JSHAPES
from repro.configs import get_config as jax_get_config
from repro.core import UnsupportedSweep as JUnsupportedSweep
from repro.data import synthetic as jsyn
from repro.nn.models import build_model as jax_build_model
from repro.nn.models import sinusoid_pos as jax_sinusoid_pos
from repro.serve.engine import ServeConfig as JServeConfig
from repro.serve.engine import generate_whisper as jax_generate_whisper
from repro_torch.bridge import params_from_numpy
from repro_torch.configs import SHAPES, get_config
from repro_torch.core import CrossEntropyLoss, ExtensionConfig, by_name
from repro_torch.core.module import Dense, ScanStack, UnsupportedSweep
from repro_torch.core.tree import tree_leaves, tree_map
from repro_torch.launch import serve, train
from repro_torch.nn.models import WhisperModel, build_model, sinusoid_pos
from repro_torch.nn.wired import Wired
from repro_torch.serve import ServeConfig, generate_whisper
from repro_torch.train import loop

ROOT = Path(__file__).resolve().parents[1]
ARCH = "whisper-tiny"
FRAMES, BATCH = 16, 2
TEN = ("batch_grad", "batch_l2", "second_moment", "variance", "batch_dot",
       "diag_ggn", "kflr", "ggn_trace", "diag_ggn_mc", "kfac")
CHAIN_TOL = 2e-4  # tests/test_archs_smoke.py's decode-vs-forward limit


def _shape(cls):
    return dataclasses.replace(cls["train_4k"], seq_len=FRAMES, global_batch=BATCH)


@pytest.fixture(scope="module")
def whisper():
    jcfg, cfg = jax_get_config(ARCH).reduced(), get_config(ARCH).reduced()
    jm = jax_build_model(jcfg)
    rs = np.random.RandomState(1)
    jp = jax.tree.map(lambda a: jnp.asarray(np.asarray(a, np.float32) + 0.1 * rs.randn(
        *a.shape).astype(np.float32)), jm.init(jax.random.PRNGKey(0)))
    pm = build_model(cfg, device="cpu")
    batch = jax.tree.map(np.asarray, jsyn.batch_for(jcfg, _shape(JSHAPES), 0))
    return cfg, jm, jp, pm, params_from_numpy(pm, _np(jp), device="cpu"), batch


def _x(batch):
    return {k: _t(v) for k, v in batch["inputs"].items()}


def _jx(batch):
    return {k: jnp.asarray(v) for k, v in batch["inputs"].items()}


def _close(got, want, tol, what=""):
    want = np.asarray(want, np.float32)
    scale = max(float(np.abs(want).max()), 1e-12)
    np.testing.assert_allclose(np.asarray(got) / scale, want / scale, rtol=tol, atol=tol,
                               err_msg=what)


@pytest.mark.parametrize("t,d", [(16, 64), (1500, 384)])
def test_sinusoid_pos_matches_jax(t, d):
    """The angles pos · 10000^(−2i/d) reach t − 1 rad: their float32 spacing
    there (1.2e-4 at 1499), where exp's last place differs between XLA and
    torch, bounds the difference (two steps, and 1e-6 for sin and cos)."""
    got = sinusoid_pos(t, d)
    assert got.dtype == torch.float32 and tuple(got.shape) == (t, d)
    np.testing.assert_allclose(got.numpy(), np.asarray(jax_sinusoid_pos(t, d)), rtol=0,
                               atol=2 * float(np.spacing(np.float32(t - 1))) + 1e-6)
    assert sinusoid_pos(t, d, torch.bfloat16).dtype == torch.bfloat16


def test_whisper_builds_with_jax_tree(whisper):
    cfg, jm, jp, pm, pp, batch = whisper
    assert isinstance(pm, WhisperModel) and pm.max_dec == 448
    assert sorted(pp) == sorted(jp) == ["dec", "emb", "enc", "head", "ln_f", "ln_post",
                                        "pos_dec"]
    for a, b in zip(tree_leaves(pp), jax.tree.leaves(jp), strict=True):
        assert tuple(a.shape) == b.shape
    assert tuple(pp["dec"]["ck"]["w"].shape) == (2, 64, 64) and "b" not in pp["dec"]["ck"]
    assert "b" not in pp["dec"]["wk"] and "b" in pp["enc"]["wk"]


def test_whisper_logits_match_jax(whisper):
    cfg, jm, jp, pm, pp, batch = whisper
    want = jm.apply(jp, _jx(batch))
    got = pm.call(pp, _x(batch))
    assert tuple(got.shape) == (BATCH, cfg.dec_len, cfg.vocab)
    _close(got.numpy(), want, 1e-5)


def test_encode_matches_jax(whisper):
    cfg, jm, jp, pm, pp, batch = whisper
    frames = batch["inputs"]["frames"]
    _close(pm.encode(pp, _t(frames)).numpy(), jm.encode(jp, jnp.asarray(frames)), 1e-5)


def test_decode_chain_matches_jax_and_the_forward(whisper):
    cfg, jm, jp, pm, pp, batch = whisper
    frames, toks = batch["inputs"]["frames"], batch["inputs"]["tokens"]
    jcache = jm.init_serve_cache(jp, BATCH, 8, jnp.float32,
                                 enc_out=jm.encode(jp, jnp.asarray(frames)))
    cache = pm.init_serve_cache(pp, BATCH, 8, torch.float32, enc_out=pm.encode(pp, _t(frames)))
    assert tuple(cache["k"].shape) == (2, BATCH, 448, 4, 16)  # [L, N, max_dec, H, dh]
    assert tuple(cache["ck"].shape) == (2, BATCH, FRAMES, 4, 16)
    full = pm.call(pp, _x(batch))
    for t in range(toks.shape[1]):
        jlogits, jcache = jm.serve_step(jp, jcache, jnp.asarray(toks[:, t]), t)
        logits, cache = pm.serve_step(pp, cache, _t(toks[:, t]), t)
        _close(logits.numpy(), jlogits, 1e-5, f"step {t} vs JAX")
        _close(logits.numpy(), full[:, t].numpy(), CHAIN_TOL, f"step {t} vs the forward")


def test_init_serve_cache_leaves_cross_kv_empty_without_encoder(whisper):
    cfg, jm, jp, pm, pp, batch = whisper
    cache = pm.init_serve_cache(pp, BATCH, 8, torch.float32)
    assert cache["ck"] is None and cache["cv"] is None
    assert int(cache["pos"].max()) == -1


def test_generate_whisper_matches_jax(whisper):
    cfg, jm, jp, pm, pp, batch = whisper
    frames = batch["inputs"]["frames"]
    want = np.asarray(jax_generate_whisper(jm, jp, jnp.asarray(frames), JServeConfig(max_len=12)))
    got = generate_whisper(pm, pp, _t(frames), ServeConfig(max_len=12))
    assert got.dtype == torch.int32 and tuple(got.shape) == (BATCH, 12)
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.fixture(scope="module")
def runs(whisper):
    """JAX's run and the port's with the ten extensions, once for the module
    (JAX's takes ≈ 40 s here): MC with JAX's draws."""
    cfg, jm, jp, pm, pp, batch = whisper
    rng = jax.random.PRNGKey(3)
    want = _jax_run(jm, jp, _jx(batch), jnp.asarray(batch["labels"]), TEN, rng=rng,
                    mc_samples=1)
    draws = _jax_draws(jnp.asarray(want[2]), jnp.asarray(batch["labels"]), rng, 1)
    got = _port_run(pm, pp, _x(batch), batch["labels"], TEN, draws=draws, mc_samples=1)
    return got, want


def test_run_loss_logits_grads_match_jax(runs):
    got, (jloss, jgrads, jlogits, jext) = runs
    np.testing.assert_allclose(got.loss.numpy(), jloss, rtol=1e-5)
    _close(got.logits.numpy(), jlogits, TOL)
    for a, b in zip(tree_leaves(got.grads), jax.tree.leaves(jgrads), strict=True):
        _close(a.numpy(), b, TOL, "grads")
    assert set(got.ext) == set(TEN)


@pytest.mark.parametrize("name", TEN)
def test_run_extension_matches_jax(runs, name):
    got, want = runs
    port, ref_ = tree_leaves(got.ext[name]), jax.tree.leaves(want[3][name])
    assert len(port) == len(ref_) and ref_, name
    for a, b in zip(port, ref_):
        assert tuple(a.shape) == b.shape, name
        _close(a.numpy(), b, TOL, name)


def test_run_grads_match_autograd(whisper, runs):
    cfg, jm, jp, pm, pp, batch = whisper
    tracked = tree_map(lambda p: p.detach().clone().requires_grad_(True), pp)
    lv = CrossEntropyLoss().value(pm.call(tracked, _x(batch)), _t(batch["labels"]))
    auto = torch.autograd.grad(lv, tree_leaves(tracked))
    for a, b in zip(tree_leaves(runs[0].grads), auto, strict=True):
        _close(a.numpy(), b.numpy(), TOL)
    # Σ_n batch_grad is the gradient, the stacks' leaves [N, L, ...]
    for bg, g in zip(tree_leaves(runs[0].ext["batch_grad"]), tree_leaves(runs[0].grads)):
        _close(bg.sum(0).numpy(), g.numpy(), TOL)
    assert tuple(runs[0].ext["batch_grad"]["dec"]["ck"]["w"].shape) == (BATCH, 2, 64, 64)


@pytest.mark.parametrize("name", ["kfra", "diag_hessian"])
def test_kfra_and_diag_hessian_raise(whisper, name):
    cfg, jm, jp, pm, pp, batch = whisper
    with pytest.raises(JUnsupportedSweep, match="WhisperModel"):
        _jax_run(jm, jp, _jx(batch), jnp.asarray(batch["labels"]), (name,))
    with pytest.raises(UnsupportedSweep, match="WhisperModel"):
        _port_run(pm, pp, _x(batch), batch["labels"], (name,))


@pytest.mark.parametrize("name", ["adamw", "diag_ggn_mc"])
def test_fit_step_matches_jax(whisper, monkeypatch, name):
    """One ``fit`` step from the same weights (JAX's ``init`` patched to
    return them) on JAX's batch (both loops' ``batch_for`` patched) and, for
    the MC step, JAX's draws."""
    from test_torch_loop import _jax_fit, _leaf_errs, _optimizers

    from repro.train import loop as jloop

    cfg, jm, jp, pm, pp, batch = whisper
    (jopt, jexts, jext_cfg, _), (opt, exts, ext_cfg, _) = _optimizers(name, jm, pm)
    monkeypatch.setattr(jloop, "batch_for", lambda *a, **k: jax.tree.map(jnp.asarray, batch))
    monkeypatch.setattr(jm, "init", lambda key: jp)
    s = dict(jmodel=jm, jcfg=jax_get_config(ARCH).reduced(), jshape=_shape(JSHAPES))
    (jparams, _, jhist, _), draws = _jax_fit(s, monkeypatch, jopt, jexts, jext_cfg, None,
                                             steps=1)
    monkeypatch.setattr(loop, "batch_for", lambda *a, **k: jax.tree.map(torch.from_numpy,
                                                                         batch))
    if jexts:
        monkeypatch.setattr(loop, "step_rng",
                            lambda seed, step, device: torch.from_numpy(draws[step]).long())
    got, _, hist, _ = loop.fit(pm, cfg, _shape(SHAPES), opt,
                               loop.LoopConfig(steps=1, log_every=100), extensions=exts,
                               ext_cfg=ext_cfg, log_fn=lambda *_: None,
                               params=tree_map(torch.clone, pp))
    np.testing.assert_allclose(hist[0]["loss"], jhist[0]["loss"], rtol=1e-5)
    assert max(_leaf_errs(got, jparams, whole_tree=name == "adamw")) <= 1e-4


def test_launcher_trains_whisper():
    """Each optimizer the card runs; the plain step's microbatch slices take
    the frames and the tokens alike."""
    for opt, extra in (("adamw", ["--microbatch-size", "1"]),
                       ("diag_ggn_mc", ["--track-variance"])):
        run = train.main(["--arch", ARCH, "--seq", "16", "--batch", "2", "--steps", "2",
                          "--optimizer", opt, "--device", "cpu"] + extra)
        assert run["cfg"].kind == "encdec" and isinstance(run["model"], WhisperModel)
        assert all(np.isfinite(h["loss"]) for h in run["history"])
        if opt != "adamw":
            assert all(np.isfinite(h["variance_mean"]) for h in run["history"])


def test_serve_launcher_serves_whisper(capsys):
    serve.main(["--arch", ARCH, "--batch", "2", "--max-len", "12", "--device", "cpu"])
    assert "generated (2, 12) tokens" in capsys.readouterr().out
    with pytest.raises(SystemExit, match="decoder-only"):
        serve.main(["--arch", ARCH, "--uncertainty", "--device", "cpu"])


def test_serving_example_runs_on_cpu():
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    proc = subprocess.run([sys.executable, "-m", "repro_torch.examples.serving", "--device",
                           "cpu"], env=env, cwd=ROOT, capture_output=True, text=True,
                          timeout=120)
    assert proc.returncode == 0, proc.stderr
    for arch in ("stablelm-1.6b", "rwkv6-3b", "whisper-tiny"):
        assert arch in proc.stdout
    assert "generated (4, 16)" in proc.stdout


def test_full_config_matches_jax_size_and_asks_for_the_card():
    cfg = get_config(ARCH)
    assert cfg.param_count() == jax_get_config(ARCH).param_count()
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA device"):
            build_model(cfg)


# ---------------------------------------------------------------------------
# the Wired repair: a block that carries a tuple, in a stack inside a Wired
# ---------------------------------------------------------------------------


class _Carry(Wired):
    """(y, e) → (y + a(tanh y) · b(e), e): e passes through and is read."""

    def __init__(self, d, device):
        super().__init__()
        gen = torch.Generator().manual_seed(5)
        self.set_children({"a": Dense(d, d, device=device, generator=gen),
                           "b": Dense(d, d, use_bias=False, device=device, generator=gen)})

    def wire(self, call, params, x):
        y, e = x
        return (y + call("a", torch.tanh(y)) * call("b", e), e)


class _Root(Wired):
    """u → e = in(u); (y, _) = stack((u, e)); out(y): the stack is a child
    whose own graph the root's does not see."""

    def __init__(self, d, device="cpu"):
        super().__init__()
        self.set_children({"inp": Dense(d, d, device=device,
                                        generator=torch.Generator().manual_seed(6)),
                           "stack": ScanStack(lambda dev: _Carry(d, dev), 2, device=device),
                           "out": Dense(d, 3, device=device,
                                        generator=torch.Generator().manual_seed(7))})

    def wire(self, call, params, x):
        y, _ = call("stack", (x, call("inp", x)))
        return call("out", y)


def test_wired_tuple_carry_against_autograd():
    gen = torch.Generator().manual_seed(0)
    root = _Root(6)
    params = tree_map(lambda p: p + 0.3 * torch.randn(p.shape, generator=gen), root.params())
    x = torch.randn(2, 5, 6, generator=gen)
    z, tape = root.forward_tape(params, x)
    torch.testing.assert_close(z, root.call(params, x))
    g = torch.randn(z.shape, generator=gen)
    g_x, grads, stats = root.backward(params, tape, g, (by_name("batch_grad"),),
                                      ExtensionConfig())
    tracked = tree_map(lambda p: p.clone().requires_grad_(True), params)
    xa = x.clone().requires_grad_(True)
    auto = torch.autograd.grad((root.call(tracked, xa) * g).sum(),
                               [xa] + tree_leaves(tracked))
    torch.testing.assert_close(g_x, auto[0])
    for a, b in zip(tree_leaves(grads), auto[1:], strict=True):
        torch.testing.assert_close(a, b)
    for bg, gr in zip(tree_leaves(stats["batch_grad"]), tree_leaves(grads), strict=True):
        torch.testing.assert_close(bg.sum(0), gr)
    # rows of cotangents: jac_t_mat and curv_backward's input factor
    M = torch.randn((3,) + tuple(z.shape), generator=gen)
    rows = root.jac_t_mat(params, tape, M)
    S_x, _ = root.curv_backward(params, tape, M, (), ExtensionConfig(), "exact")
    for c in range(3):
        want = torch.autograd.grad((root.call(params, xa) * M[c]).sum(), xa)[0]
        torch.testing.assert_close(rows[c], want)
        torch.testing.assert_close(S_x[c], want)
    # the stack alone takes and returns the tuple cotangent
    stack = root.children_map["stack"]
    e = torch.randn(2, 5, 6, generator=gen)
    (y, e_out), st_tape = stack.forward_tape(params["stack"], (x, e))
    assert torch.equal(e_out, e)
    gy, ge = torch.randn(y.shape, generator=gen), torch.randn(e.shape, generator=gen)
    (gx_y, gx_e), _, _ = stack.backward(params["stack"], st_tape, (gy, ge), (),
                                        ExtensionConfig())
    ya, ea = x.clone().requires_grad_(True), e.clone().requires_grad_(True)
    yo, eo = stack.call(params["stack"], (ya, ea))
    want = torch.autograd.grad((yo * gy).sum() + (eo * ge).sum(), (ya, ea))
    torch.testing.assert_close(gx_y, want[0])
    torch.testing.assert_close(gx_e, want[1])
