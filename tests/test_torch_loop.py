"""The training loop (``repro_torch.train.loop``) against the JAX package.

On the reduced StableLM-2 (LayerNorm, partial RoPE, qkv biases; its two
layers a ``ScanStack``), 2 sequences of 8 tokens, 3 steps: JAX's ``fit``
runs first from its own ``init``; the port's ``fit`` starts from the same
parameters (``bridge.params_from_numpy``) and is fed JAX's batches (the
loop's ``batch_for`` monkeypatched: JAX's threefry stream cannot be drawn in
torch).  The MC optimizers take JAX's own draws: a wrapper of JAX's step
records the categorical draws each step makes from its logits and
``fold_in(PRNGKey(seed + 1), step)``, and the port's per-step generator
(``loop.step_rng``) hands them over.  Losses per step within 1e-5 relative,
parameters after 3 steps within 1e-4 of each leaf's largest entry (float32,
sums in another order; KFAC's float32 inverses).  KFAC runs without the
running average of its factors and ``cg_ngd`` at damping 1 (see
``_optimizers``).

The rest of the loop is the port's own: checkpoint and resume repeat the
uninterrupted run bit for bit (the plain and the MC step), as does
``fit_with_restarts`` after an injected failure; its ``ValueError`` without
a ``ckpt_dir``; the plain step's microbatch split and JAX's log line; the
marglik callback's evidence and prior against JAX's on the same batch,
parameters and draws, and its disabling on an unsupported model; ``remat``
(``build_model(remat=True)``): the same loss and gradients as without it
and as JAX's ``build_model(remat=True)``, and JAX's rule for which stacks
take it.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _torch_threads import one_torch_thread  # noqa: F401 (autouse)

from repro.configs import SHAPES as JSHAPES
from repro.configs import get_config as jax_get_config
from repro.core import KFAC as JKFAC
from repro.core import CrossEntropyLoss as JCrossEntropy
from repro.core import DiagGGNMC as JDiagGGNMC
from repro.core import ExtensionConfig as JConfig
from repro.data import synthetic as jsyn
from repro.nn.models import build_model as jax_build_model
from repro.optim import adamw as jadamw
from repro.optim import curvature_optimizer as jcurv
from repro.optim import make_cg_ngd_step as jcg
from repro.optim import momentum_sgd as jmomentum
from repro.train import loop as jloop
from repro_torch.bridge import params_from_numpy
from repro_torch.configs import SHAPES, get_config
from repro_torch.core import KFAC, CrossEntropyLoss, DiagGGNMC, ExtensionConfig
from repro_torch.core.module import Activation, Dense, Sequential
from repro_torch.core.tree import tree_leaves
from repro_torch.nn.models import build_model
from repro_torch.optim import adamw, curvature_optimizer, make_cg_ngd_step, momentum_sgd
from repro_torch.train import loop
from repro_torch.train.fault import FailureInjector
from repro_torch.train.step import _value_and_grad, make_loss_fn

ARCH, SEQ, BATCH, STEPS = "stablelm-1.6b", 8, 2, 3
LOSS_RTOL, PARAM_TOL = 1e-5, 1e-4


def _silent(*_):
    pass


def _draws(logits, labels, rng):
    """JAX's CE MC draws [1, N, T], as ``sqrt_hessian_mc`` makes them."""
    keys = jax.vmap(jax.random.fold_in, in_axes=(None, 0))(rng, jnp.arange(logits.shape[0]))
    draw = jax.vmap(lambda key, zn, yn: jax.random.categorical(
        key, zn, axis=-1, shape=(1,) + yn.shape))
    return jnp.moveaxis(draw(keys, logits.astype(jnp.float32), labels), 1, 0)


@pytest.fixture(scope="module")
def setup():
    jcfg, cfg = jax_get_config(ARCH).reduced(), get_config(ARCH).reduced()
    jmodel = jax_build_model(jcfg)
    np_params = jax.tree.map(np.asarray, jmodel.init(jax.random.PRNGKey(0)))
    jshape = dataclasses.replace(JSHAPES["train_4k"], seq_len=SEQ, global_batch=BATCH)
    shape = dataclasses.replace(SHAPES["train_4k"], seq_len=SEQ, global_batch=BATCH)
    batches = [jax.tree.map(np.asarray, jsyn.batch_for(jcfg, jshape, s)) for s in range(STEPS)]
    model = build_model(cfg, device="cpu", generator=torch.Generator().manual_seed(0))
    return dict(jcfg=jcfg, cfg=cfg, jmodel=jmodel, np_params=np_params, jshape=jshape,
                shape=shape, batches=batches, model=model)


def _optimizers(name, jmodel, model):
    """(JAX opt, extensions, cfg, step_fn), (port ...): the launcher's defaults."""
    if name == "adamw":
        # eps 1e-6, not 1e-8: a gradient that is zero but for rounding (the
        # key bias's unrotated dims: the softmax ignores a shift shared by all
        # keys) would take ±lr from either side's rounding at 1e-8
        return (jadamw(1e-3, eps=1e-6), (), None, None), (adamw(1e-3, eps=1e-6), (), None, None)
    if name == "momentum":
        return (jmomentum(1e-2), (), None, None), (momentum_sgd(1e-2), (), None, None)
    if name == "diag_ggn_mc":
        return ((jcurv(0.2, 1e-1, "diag_ggn_mc"), (JDiagGGNMC,),
                 JConfig(mc_samples=1, use_kernels=False), None),
                (curvature_optimizer(0.2, 1e-1, "diag_ggn_mc"), (DiagGGNMC,),
                 ExtensionConfig(mc_samples=1, use_kernels=True), None))
    if name == "kfac":
        # stat_decay 0, not the launcher's 0.9: JAX's extended step returns
        # the optimizer state it was given (src/repro/train/step.py:135), so
        # its factors' running average never starts; the port's step returns
        # the new state (test_kfac_step_carries_its_running_average)
        return ((jcurv(0.3, 1e-1, "kfac"), (JKFAC,),
                 JConfig(mc_samples=1, use_kernels=False), None),
                (curvature_optimizer(0.3, 1e-1, "kfac"), (KFAC,),
                 ExtensionConfig(mc_samples=1, use_kernels=True), None))
    # damping 1, not the launcher's 0.1: at 0.1 on this batch CG's residual
    # grows (0.41, 0.48, 1.39 after 10 iterations) and the steps amplify
    # float32 rounding a thousandfold on either side; 3 iterations a step
    jopt, jstep = jcg(jmodel, JCrossEntropy(), lr=0.3, damping=1.0, cg_iters=3)
    opt, step = make_cg_ngd_step(model, CrossEntropyLoss(), lr=0.3, damping=1.0, cg_iters=3)
    return (jopt, (), None, jstep), (opt, (), None, step)


def _jax_fit(s, monkeypatch, jopt, exts, jcfg_ext, step_fn, steps=STEPS):
    """JAX's fit, recording the MC draws each extended step makes."""
    draws = {}
    make = jloop.make_extended_train_step

    def recording(model, loss, opt, extensions, cfg=None, **kw):
        inner = make(model, loss, opt, extensions, cfg, **kw)

        def step(params, opt_state, batch, step_idx, rng):
            d = _draws(s["jmodel"].apply(params, batch["inputs"]), batch["labels"], rng)
            jax.debug.callback(lambda d_, i: draws.__setitem__(int(i), np.asarray(d_)), d,
                               step_idx)
            return inner(params, opt_state, batch, step_idx, rng)

        return step

    monkeypatch.setattr(jloop, "make_extended_train_step", recording)
    out = jloop.fit(s["jmodel"], s["jcfg"], s["jshape"], jopt,
                    jloop.LoopConfig(steps=steps, log_every=100), extensions=exts,
                    ext_cfg=jcfg_ext, log_fn=_silent, step_fn=step_fn)
    jax.effects_barrier()
    return out, draws


def _feed(monkeypatch, s, draws=None):
    """The port's loop fed JAX's batches (and draws)."""
    monkeypatch.setattr(loop, "batch_for", lambda cfg, shape, step, seed=0, batch=None,
                        device="cuda": jax.tree.map(torch.from_numpy, s["batches"][step]))
    if draws is not None:
        monkeypatch.setattr(loop, "step_rng", lambda seed, step, device: torch.from_numpy(
            draws[step]).long())


def _leaf_errs(port, want, whole_tree=False):
    """max |port − want| / max |want| a leaf (``whole_tree``: over the whole
    tree's largest entry)."""
    want = [np.asarray(b, np.float64) for b in jax.tree.leaves(want)]
    top = max(np.abs(b).max() for b in want)
    return [float(np.abs(np.asarray(a, np.float64) - b).max()
                  / (top if whole_tree else max(np.abs(b).max(), 1e-30)))
            for a, b in zip(tree_leaves(port), want, strict=True)]


@pytest.mark.parametrize("name", ["adamw", "momentum", "diag_ggn_mc", "kfac", "cg_ngd"])
def test_fit_matches_jax(setup, monkeypatch, name):
    s = setup
    (jopt, jexts, jext_cfg, jstep), (opt, exts, ext_cfg, step) = _optimizers(
        name, s["jmodel"], s["model"])
    (jparams, _, jhist, _), draws = _jax_fit(s, monkeypatch, jopt, jexts, jext_cfg, jstep)
    assert (len(draws) == STEPS) == bool(jexts)
    _feed(monkeypatch, s, draws if jexts else None)
    params = params_from_numpy(s["model"], s["np_params"], "cpu")
    got, _, hist, wd = loop.fit(s["model"], s["cfg"], s["shape"], opt,
                                loop.LoopConfig(steps=STEPS, log_every=100), extensions=exts,
                                ext_cfg=ext_cfg, log_fn=_silent, step_fn=step, params=params)
    np.testing.assert_allclose([h["loss"] for h in hist], [h["loss"] for h in jhist],
                               rtol=LOSS_RTOL)
    assert [h["step"] for h in hist] == [h["step"] for h in jhist] == [1, 2, 3]
    for h in hist:
        assert set(h) >= {"loss", "step", "dur_s", "stalled", "straggler"}
        assert h["stalled"] == 0.0 and h["straggler"] == 0.0 and h["dur_s"] > 0
    if name == "cg_ngd":
        assert [h["cg_iters"] for h in hist] == [h["cg_iters"] for h in jhist]
    # AdamW normalizes each entry by its own gradient: one that is zero but
    # for rounding (the key bias's unrotated dims, which the softmax ignores)
    # moves by lr·g/(|g| + eps) on either side, so its leaf is read against
    # the whole tree's scale
    assert max(_leaf_errs(got, jparams, whole_tree=name == "adamw")) <= PARAM_TOL
    assert len(wd.durations) == STEPS


def test_kfac_step_carries_its_running_average(setup):
    """The port's extended step returns the optimizer's new state: KFAC's
    factors after the first step, then their running average (JAX's step
    returns the state it was given)."""
    s = setup
    opt = curvature_optimizer(0.3, 1e-1, "kfac", stat_decay=0.9)
    states = []
    step = loop.make_extended_train_step(s["model"], CrossEntropyLoss(), opt, (KFAC,),
                                         ExtensionConfig(mc_samples=1))
    params, state = s["model"].params(), opt.init(s["model"].params())
    for i in range(2):
        batch = loop.batch_for(s["cfg"], s["shape"], i, device="cpu")
        params, state, _ = step(params, state, batch, i, loop.step_rng(1, i, "cpu"))
        states.append(state)
    assert states[0]["t"] == 1 and states[1]["t"] == 2
    a0, a1 = states[0]["stats"][-1]["w"]["A"], states[1]["stats"][-1]["w"]["A"]
    assert a0.shape == a1.shape and not torch.equal(a0, a1)


def _port_fit(s, ckpt_dir=None, steps=4, resume=False, name="adamw", injector=None,
              restarts=None, every=2, log_fn=_silent):
    opt, exts, ext_cfg = {"adamw": (adamw(1e-3), (), None),
                          "diag_ggn_mc": (curvature_optimizer(0.2, 1e-1, "diag_ggn_mc"),
                                          (DiagGGNMC,), ExtensionConfig(mc_samples=1)),
                          "kfac": (curvature_optimizer(0.3, 1e-1, "kfac", stat_decay=0.9),
                                   (KFAC,), ExtensionConfig(mc_samples=1))}[name]
    cfg = loop.LoopConfig(steps=steps, ckpt_dir=ckpt_dir, ckpt_every=every, log_every=100)
    kw = dict(extensions=exts, ext_cfg=ext_cfg, log_fn=log_fn, injector=injector)
    if restarts is not None:
        return loop.fit_with_restarts(s["model"], s["cfg"], s["shape"], opt, cfg,
                                      max_restarts=restarts, **kw)
    return loop.fit(s["model"], s["cfg"], s["shape"], opt, cfg, resume=resume, **kw)


@pytest.mark.parametrize("name", ["adamw", "diag_ggn_mc", "kfac"])
def test_resume_repeats_the_uninterrupted_run(setup, tmp_path, name):
    """Stop after 2 steps, resume to 4 from the checkpoint: the same losses
    and parameters bit for bit (the data and the MC generator are functions
    of the step; KFAC's running average, None in its initial state, restores
    in the checkpoint's structure)."""
    params, _, hist, _ = _port_fit(setup, str(tmp_path / "a"), name=name)
    _port_fit(setup, str(tmp_path / "b"), steps=2, name=name)
    log = []
    resumed_params, _, resumed, _ = _port_fit(setup, str(tmp_path / "b"), resume=True,
                                              name=name, log_fn=log.append)
    assert log[0] == "[resume] step 2"
    assert [h["loss"] for h in resumed] == [h["loss"] for h in hist[2:]]
    for a, b in zip(tree_leaves(resumed_params), tree_leaves(params), strict=True):
        assert torch.equal(a, b)
    assert sorted(p.name for p in (tmp_path / "a").iterdir()) == [
        "step_00000002", "step_00000004"]


def test_fit_with_restarts_resumes_after_a_failure(setup, tmp_path):
    _, _, hist, _ = _port_fit(setup, str(tmp_path / "a"))
    (_, _, resumed, _), restarts = _port_fit(
        setup, str(tmp_path / "b"), injector=FailureInjector(fail_at_step=3), restarts=1)
    assert restarts == 1
    assert [h["loss"] for h in resumed] == [h["loss"] for h in hist[2:]]
    with pytest.raises(ValueError, match="needs loop.ckpt_dir"):
        _port_fit(setup, None, restarts=1)


def test_plain_step_microbatches_and_jax_log_line(setup, monkeypatch):
    """No even split of 5 rows into slices of ≤ 2: five microbatches of 1,
    said in JAX's words; the accumulated step's loss is the whole batch's."""
    s = setup
    jlog, log = [], []
    jloop.fit(s["jmodel"], s["jcfg"], s["jshape"], jadamw(1e-3),
              jloop.LoopConfig(steps=0, batch_override=5), ext_cfg=JConfig(microbatch_size=2),
              log_fn=jlog.append)
    losses = {}
    for size in (None, 2):
        _, _, hist, _ = loop.fit(s["model"], s["cfg"], s["shape"], adamw(1e-3),
                                 loop.LoopConfig(steps=1, batch_override=5),
                                 ext_cfg=ExtensionConfig(microbatch_size=size),
                                 log_fn=log.append)
        losses[size] = hist[0]["loss"]
    assert jlog == [m for m in log if m.startswith("[accumulate]")] == [
        "[accumulate] batch 5 has no even split into ≤2-sample slices; using 5 microbatches "
        "of 1"]
    np.testing.assert_allclose(losses[2], losses[None], rtol=1e-6)


def _draws_into_fits(monkeypatch, draws):
    """Every Laplace fit's MC sweep takes ``draws`` (JAX's) in place of its
    ``mc_seed`` generator."""
    from repro_torch import laplace

    fit = laplace.fit_posterior
    monkeypatch.setattr(laplace, "fit_posterior", lambda *a, options, **kw: fit(
        *a, options=dataclasses.replace(options, rng=torch.from_numpy(draws).long()), **kw))


def test_marglik_callback_matches_jax(setup, monkeypatch):
    """A last-layer KFAC Laplace fit on a batch, 5 evidence-ascent steps:
    the log-evidence and prior precision JAX's (its draws from
    ``PRNGKey(loop.seed + step)`` passed in)."""
    s = setup
    batch = s["batches"][1]
    jparams = jax.tree.map(jnp.asarray, s["np_params"])
    jmetrics, metrics = {}, {}
    lc = jloop.LoopConfig(seed=0, marglik_steps=5)
    assert jloop._marglik_callback(s["jmodel"], jparams, jax.tree.map(jnp.asarray, batch),
                                   JCrossEntropy(), lc, 1, jmetrics, _silent)
    draws = _draws(s["jmodel"].apply(jparams, batch["inputs"]), batch["labels"],
                   jax.random.PRNGKey(lc.seed + 1))
    params = params_from_numpy(s["model"], s["np_params"], "cpu")
    _draws_into_fits(monkeypatch, np.asarray(draws))
    assert loop._marglik_callback(s["model"], params, jax.tree.map(torch.from_numpy, batch),
                                  CrossEntropyLoss(), loop.LoopConfig(seed=0, marglik_steps=5),
                                  1, metrics,
                                  _silent)
    np.testing.assert_allclose(metrics["marglik"], jmetrics["marglik"], rtol=1e-4)
    np.testing.assert_allclose(metrics["prior_prec"], jmetrics["prior_prec"], rtol=1e-4)


def test_marglik_callback_in_fit_and_its_disabling(setup):
    s = setup
    _, _, hist, _ = loop.fit(s["model"], s["cfg"], s["shape"], adamw(1e-3),
                             loop.LoopConfig(steps=2, marglik_every=2, marglik_steps=3),
                             log_fn=_silent)
    assert "marglik" not in hist[0] and np.isfinite(hist[1]["marglik"])
    assert hist[1]["prior_prec"] > 0
    log = []
    gen = torch.Generator().manual_seed(0)
    model = Sequential([Dense(4, 3, device="cpu", generator=gen), Activation("relu")])
    batch = {"inputs": torch.randn(5, 4, generator=gen), "labels": torch.tensor([0, 1, 2, 0, 1])}
    assert not loop._marglik_callback(model, model.params(), batch, CrossEntropyLoss(),
                                      loop.LoopConfig(), 0, {}, log.append)
    assert log and log[0].startswith("[marglik] disabled: LastLayerLaplace needs the final")


def test_remat_gives_the_same_loss_and_gradients(setup):
    """``build_model(remat=True)``: each stacked layer under
    ``torch.utils.checkpoint`` — the loss and gradients of the model without
    it (the same operations, recomputed) and of JAX's remat model."""
    s = setup
    batch = s["batches"][0]
    x, y = torch.from_numpy(batch["inputs"]), torch.from_numpy(batch["labels"])
    out = {}
    for flag in (False, True):
        model = build_model(s["cfg"], remat=flag, device="cpu")
        params = params_from_numpy(model, s["np_params"], "cpu")
        assert [getattr(m, "remat", None) for m in model.stacks] == [flag]
        out[flag] = _value_and_grad(make_loss_fn(model, CrossEntropyLoss()), params, x, y)
    assert torch.equal(out[True][0], out[False][0])
    for a, b in zip(tree_leaves(out[True][1]), tree_leaves(out[False][1]), strict=True):
        torch.testing.assert_close(a, b, rtol=1e-6, atol=1e-7)
    jmodel = jax_build_model(s["jcfg"], remat=True)
    jl, jg = jax.value_and_grad(lambda p: JCrossEntropy().value(
        jmodel.apply(p, batch["inputs"]), batch["labels"]))(
            jax.tree.map(jnp.asarray, s["np_params"]))
    np.testing.assert_allclose(out[True][0].item(), float(jl), rtol=1e-5)
    assert max(_leaf_errs(out[True][1], jg)) <= PARAM_TOL


@pytest.mark.parametrize("segments,repeat,want", [
    ([(None, 2)], 2, (True, True)),          # one segment: the repeat stack recomputes too
    ([(8, 1), (None, 2)], 2, (False, True)),  # several: only the segment's stack
    ([(None, 4)], 1, (None, True)),
])
def test_remat_goes_to_the_stacks_as_in_jax(segments, repeat, want):
    """(the repeat stack's remat, the segment stack's) — JAX's ``make_stacks``."""
    kw = dict(n_layers=sum(c for _, c in segments) * repeat, window_segments=segments,
              pattern_repeat=repeat)
    cfg = dataclasses.replace(get_config(ARCH).reduced(), **kw)
    jcfg = dataclasses.replace(jax_get_config(ARCH).reduced(), **kw)

    def flags(stack, seg_of):
        if repeat > 1:
            return stack.remat, seg_of(stack)
        return None, stack.remat

    (stack,) = build_model(cfg, remat=True, device="meta").stacks
    got = flags(stack, lambda st: (st.block.mods[-1] if len(segments) > 1 else st.block).remat)
    (jstack,) = jax_build_model(jcfg, remat=True).stacks
    jwant = flags(jstack, lambda st: (st.block.mods[-1] if len(segments) > 1
                                      else st.block).remat)
    assert got == jwant == want
