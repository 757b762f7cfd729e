"""Training loop: a step function + synthetic data + checkpoint + watchdog.

Small enough to run on the CPU for examples and tests, structured like the
real thing: deterministic step-indexed data (resume needs no iterator
state), periodic atomic checkpoints, a straggler watchdog, a failure
injection hook, and :mod:`.fault`'s restart loop (``run_with_restarts``).

Port of ``src/repro/train/loop.py`` (``LoopConfig``, ``fit``,
``fit_with_restarts``, ``_marglik_callback``), in the port's own form in two
places:

* a torch module holds its weights, so ``fit`` starts from ``params``
  (default: ``model.params()``) where JAX's re-initialises them from
  ``loop.seed``;
* the MC sweep of step ``s`` draws from a generator seeded from
  (``loop.seed + 1``, ``s``) on the parameters' device (JAX:
  ``fold_in(PRNGKey(loop.seed + 1), s)``), a pure function of the step, so a
  resumed run repeats the uninterrupted one.

Each step is a ``train/step`` span of :mod:`repro_torch.obs` (its ``float``
of the metrics waits for the card, so the span covers the step's device
work), counted in ``train.steps``, and a straggler the watchdog flags in
``train.watchdog.straggler``, as in JAX.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Callable, Optional, Sequence

import numpy as np
import torch

from repro_torch import obs
from repro_torch.core import CrossEntropyLoss, ExtensionConfig
from repro_torch.core.engine import refuse_mesh
from repro_torch.core.tree import tree_leaves, tree_map
from repro_torch.data.synthetic import batch_for
from repro_torch.train import checkpoint as ckpt
from repro_torch.train.fault import FailureInjector, Watchdog, run_with_restarts
from repro_torch.train.step import make_extended_train_step, make_train_step


@dataclasses.dataclass
class LoopConfig:
    steps: int = 100
    ckpt_dir: Optional[str] = None
    ckpt_every: int = 50
    ckpt_keep: int = 3      # newest checkpoints retained (must be >= 1)
    log_every: int = 10
    seed: int = 0
    batch_override: Optional[int] = None
    # Online marginal-likelihood callback (repro_torch.laplace): every
    # ``marglik_every`` steps, fit a last-layer Laplace posterior on the
    # current batch (MC curvature — LM vocabularies rule out the exact
    # factor) and tune the prior precision by evidence ascent.  The
    # evidence and tuned prior land in that step's metrics/history.
    marglik_every: Optional[int] = None
    marglik_structure: str = "kron"   # 'diag' | 'kron'
    marglik_steps: int = 20           # evidence-ascent steps per callback


def step_rng(seed: int, step: int, device) -> torch.Generator:
    """The MC sweep's generator of step ``step``: seeded from
    (``seed``, ``step``) alone, on ``device``."""
    state = np.random.SeedSequence([int(seed), int(step)]).generate_state(2)
    return torch.Generator(device=device).manual_seed(int(state[0]) << 32 | int(state[1]))


def _microbatches(nb, size, log_fn):
    """The plain step's microbatch count: the fewest even slices of at most
    ``size`` samples, said when none is ⌈nb / size⌉."""
    k = max(1, -(-nb // size))
    microbatch = k
    while nb % microbatch:  # make_train_step needs even slices
        microbatch += 1
    if microbatch != k:
        # e.g. prime nb: the only even split ≥ k may be far finer than asked —
        # stay memory-safe but say so (the extended path handles uneven
        # slices exactly; this one reshapes).
        log_fn(f"[accumulate] batch {nb} has no even split into "
               f"≤{size}-sample slices; using "
               f"{microbatch} microbatches of {nb // microbatch}")
    return microbatch


def fit(model, cfg, shape, opt, loop: LoopConfig,
        extensions: Sequence = (), ext_cfg: Optional[ExtensionConfig] = None,
        injector: Optional[FailureInjector] = None, resume: bool = False,
        log_fn: Callable = print, track: Sequence[str] = (),
        mesh=None, shard_axes=("data",), step_fn: Optional[Callable] = None,
        params=None):
    """Train ``model`` (built from arch config ``cfg``) on synthetic data
    from ``params`` (default: ``model.params()``), on their device.

    With ``ext_cfg=ExtensionConfig(microbatch_size=...)`` the step streams
    each batch through the accumulated lane: the extended step folds every
    extension's sequential reducer along, and the plain step accumulates its
    gradient over even slices — either way the loop serves effective batches
    beyond device memory.  A ``mesh`` (the sharded lane) raises, ROADMAP
    queue A item 12.

    A ``step_fn`` replaces ``make_train_step`` / ``make_extended_train_step``:
    a prebuilt extended-signature step ``(params, opt_state, batch,
    step_idx, rng)`` —
    how whole-step optimizers plug in (``optim.make_cg_ngd_step``, whose
    implicit solve needs the batch, not just the gradient); ``opt.init``
    still builds the state.

    Returns ``(params, opt_state, history, watchdog)``; ``history`` holds a
    step's metrics as floats, with ``dur_s``, ``stalled`` and ``straggler``.
    """
    refuse_mesh("fit", mesh, shard_axes)
    loss = CrossEntropyLoss()
    params = model.params() if params is None else params
    device = tree_leaves(params)[0].device
    opt_state = opt.init(params)
    start_step = 0
    if resume and loop.ckpt_dir:
        last = ckpt.latest_step(loop.ckpt_dir)
        if last is not None:
            params, opt_state, manifest = ckpt.restore(loop.ckpt_dir, last, params, opt_state)
            params, opt_state = tree_map(
                lambda a: a.to(device) if isinstance(a, torch.Tensor) else a,
                (params, opt_state))
            start_step = manifest["step"]
            log_fn(f"[resume] step {start_step}")

    prebuilt = step_fn is not None
    if not prebuilt and extensions:
        step_fn = make_extended_train_step(model, loss, opt, extensions, ext_cfg, track=track)
    elif not prebuilt:
        microbatch = 1
        if ext_cfg is not None and ext_cfg.microbatch_size:
            microbatch = _microbatches(loop.batch_override or shape.global_batch,
                                       ext_cfg.microbatch_size, log_fn)
        step_fn = make_train_step(model, loss, opt, microbatch=microbatch)

    wd = Watchdog()
    history = []
    marglik_ok = True  # flips off after the first unsupported-model error
    for step in range(start_step, loop.steps):
        if injector is not None:
            injector.check(step)
        batch = batch_for(cfg, shape, step, seed=loop.seed, batch=loop.batch_override,
                          device=device)
        # perf_counter is the one wall clock for durations (monotonic, highest
        # resolution); reading the metrics as floats waits for the device
        t0 = time.perf_counter()
        with obs.span("train/step", step=step):
            if extensions or prebuilt:
                params, opt_state, metrics = step_fn(params, opt_state, batch, step,
                                                     step_rng(loop.seed + 1, step, device))
            else:
                params, opt_state, metrics = step_fn(params, opt_state, batch, step)
            metrics = {k: float(v) for k, v in metrics.items()}
        dur = time.perf_counter() - t0
        stalled = wd.stalled()  # gap since the previous beat, pre-beat
        ok = wd.beat(step, dur)
        # per-step duration + watchdog state ride the history so post-hoc
        # analysis needs no log scraping
        metrics["dur_s"] = dur
        metrics["stalled"] = float(stalled)
        metrics["straggler"] = float(not ok)
        obs.count("train.steps")
        if not ok:
            obs.count("train.watchdog.straggler")
        if (loop.marglik_every and marglik_ok
                and (step + 1) % loop.marglik_every == 0):
            marglik_ok = _marglik_callback(model, params, batch, loss, loop, step, metrics,
                                           log_fn)
        history.append(metrics)
        if step % loop.log_every == 0:
            log_fn(f"step {step:5d} loss {metrics['loss']:.4f} ({dur*1e3:.0f} ms)")
        if loop.ckpt_dir and (step + 1) % loop.ckpt_every == 0:
            ckpt.save(loop.ckpt_dir, step + 1, params, opt_state, keep=loop.ckpt_keep)
    if loop.ckpt_dir:
        ckpt.save(loop.ckpt_dir, loop.steps, params, opt_state, keep=loop.ckpt_keep)
    return params, opt_state, history, wd


def fit_with_restarts(model, cfg, shape, opt, loop: LoopConfig,
                      max_restarts: int = 3, on_restart=None, **kw):
    """:func:`fit` under ``run_with_restarts``: any fault (injected or real)
    triggers restore-from-latest-checkpoint + retry, up to
    ``max_restarts``.  ``loop.ckpt_dir`` must be set — without it a restart
    would silently retrain from scratch.  Returns
    ``((params, opt_state, history, watchdog), restarts)``."""
    if not loop.ckpt_dir:
        raise ValueError("fit_with_restarts needs loop.ckpt_dir — a "
                         "restart without checkpoints retrains from "
                         "scratch")

    def make_and_run(resume):
        return fit(model, cfg, shape, opt, loop, resume=resume is not None, **kw)

    return run_with_restarts(make_and_run, max_restarts=max_restarts,
                             on_restart=on_restart)


def _marglik_callback(model, params, batch, loss, loop: LoopConfig, step,
                      metrics, log_fn) -> bool:
    """Fit + tune a last-layer Laplace posterior on the current batch and
    record the evidence; returns False (disabling the callback) when the
    model structure is unsupported."""
    from repro_torch import laplace

    try:
        post = laplace.fit_posterior(
            model, params, batch["inputs"], batch["labels"], loss,
            structure=loop.marglik_structure, last_layer=True,
            options=laplace.FitOptions(
                mc=True, cfg=ExtensionConfig(mc_seed=loop.seed + step)))
    except laplace.LaplaceStructureError as e:
        log_fn(f"[marglik] disabled: {e}")
        return False
    post, res = laplace.optimize_marglik(post, n_steps=loop.marglik_steps)
    metrics["marglik"] = float(laplace.log_marglik(post))
    metrics["prior_prec"] = res.prior_prec
    log_fn(f"[marglik] step {step:5d} log-evidence {metrics['marglik']:.1f} "
           f"prior_prec {res.prior_prec:.3g}")
    return True
