"""Training launcher.

    PYTHONPATH=src python -m repro_torch.launch.train --arch stablelm-1.6b \
        --steps 200 --seq 64 --batch 8 --optimizer kfac --ckpt ckpt/ [--device cpu]

Trains the arch's ``reduced()`` config (``--full``: the config as
published) on the synthetic token stream (:mod:`repro_torch.data`), on the
card unless ``--device cpu`` is given, from random weights drawn from a
generator seeded 0 on that device.  The optimizers: ``adamw``, ``momentum``,
the paper's curvature-preconditioned step with ``diag_ggn_mc`` or ``kfac``
(Eq. 7), and the matrix-free natural gradient ``cg_ngd``.  ``main``
returns the run: its config, shape, model, trained parameters, history (a
dict of floats a step) and watchdog.

``--trace-jsonl FILE`` records the :mod:`repro_torch.obs` trace (render it
with ``python -m repro_torch.obs.reporting FILE``), ``--metrics-report``
prints the measured span tree and counters after training, and
``--profile-dir DIR`` writes a ``torch.profiler`` trace of the training
(host and card) to ``DIR/trace.json``, with each span a named range.

Port of ``src/repro/launch/train.py``: ``--shard-sweep`` (the sharded lane)
is ROADMAP queue A item 12 and raises.
"""
from __future__ import annotations

import argparse
import dataclasses
import os
import time

import torch

from repro_torch import obs
from repro_torch.configs import SHAPES, get_config
from repro_torch.core import KFAC, CrossEntropyLoss, DiagGGNMC, ExtensionConfig, Variance
from repro_torch.core.module import resolve_device
from repro_torch.nn.models import build_model
from repro_torch.obs.profile import TRACE_FILE
from repro_torch.optim import adamw, curvature_optimizer, make_cg_ngd_step, momentum_sgd
from repro_torch.train.fault import FailureInjector
from repro_torch.train.loop import LoopConfig, fit, fit_with_restarts


def make_optimizer(name, model, *, lr=None, damping=1e-1, cg_iters=10,
                   track_variance=False, microbatch_size=None):
    """The launcher's ``--optimizer name`` with its defaults, as ``fit``'s
    arguments: ``dict(opt=, extensions=, ext_cfg=, track=, step_fn=)``."""
    extensions, ext_cfg, track, step_fn = (), None, (), None
    if name == "adamw":
        opt = adamw(lr or 1e-3)
    elif name == "momentum":
        opt = momentum_sgd(lr or 1e-2)
    elif name == "diag_ggn_mc":
        opt = curvature_optimizer(lr or 0.2, damping, "diag_ggn_mc")
        extensions, ext_cfg = (DiagGGNMC,), ExtensionConfig(mc_samples=1)
    elif name == "kfac":
        opt = curvature_optimizer(lr or 0.3, damping, "kfac", stat_decay=0.9)
        extensions, ext_cfg = (KFAC,), ExtensionConfig(mc_samples=1)
    elif name != "cg_ngd":
        raise ValueError(f"unknown optimizer {name!r}")
    if track_variance:
        extensions = tuple(extensions) + (Variance,)
        track = ("variance",)
    if microbatch_size:
        ext_cfg = dataclasses.replace(ext_cfg or ExtensionConfig(),
                                      microbatch_size=microbatch_size)
    if name == "cg_ngd":  # a whole-step optimizer: fit drives its step
        opt, step_fn = make_cg_ngd_step(model, CrossEntropyLoss(), lr=lr or 0.3,
                                        damping=damping, cg_iters=cg_iters, ext_cfg=ext_cfg)
    return dict(opt=opt, extensions=extensions, ext_cfg=ext_cfg, track=track, step_fn=step_fn)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--lr", type=float, default=None)
    ap.add_argument("--optimizer", default="adamw",
                    choices=["adamw", "momentum", "diag_ggn_mc", "kfac", "cg_ngd"])
    ap.add_argument("--damping", type=float, default=1e-1)
    ap.add_argument("--cg-iters", type=int, default=10,
                    help="cg_ngd: CG iterations per step (each costs ~2 "
                         "gradient sweeps; the implicit solve never "
                         "materializes a factor, so LM heads whose KFAC "
                         "factors exceed device memory still train)")
    ap.add_argument("--ckpt", default=None)
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--ckpt-keep", type=int, default=3,
                    help="newest checkpoints retained in --ckpt (>= 1)")
    ap.add_argument("--max-restarts", type=int, default=0,
                    help="run under the restart loop: any fault restores "
                         "the latest checkpoint and retries, up to this "
                         "many times (needs --ckpt)")
    ap.add_argument("--fail-at-step", type=int, default=None,
                    help="inject a failure at this step (exercises the "
                         "checkpoint/restart path end-to-end; pair with "
                         "--max-restarts)")
    ap.add_argument("--full", action="store_true",
                    help="the config as published (for the card)")
    ap.add_argument("--track-variance", action="store_true")
    ap.add_argument("--shard-sweep", action="store_true",
                    help="run extension sweeps batch-sharded over all local devices")
    ap.add_argument("--microbatch-size", type=int, default=None,
                    help="stream each batch through the accumulated sweep "
                         "lane in slices of at most this many samples — "
                         "identical numbers, activation memory bounded by "
                         "the microbatch")
    ap.add_argument("--trace-jsonl", default=None,
                    help="record an observability trace (spans / counters / gauges, one "
                         "JSON object per line) to this file; render it with "
                         "'python -m repro_torch.obs.reporting FILE'")
    ap.add_argument("--metrics-report", action="store_true",
                    help="print the measured span tree + counters after training "
                         "(obs.report())")
    ap.add_argument("--profile-dir", default=None,
                    help="capture a torch.profiler trace of the training (host and "
                         "card) into DIR/trace.json (view with Perfetto)")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    if args.shard_sweep:
        raise NotImplementedError("--shard-sweep (the sharded lane) is still to port: "
                                  "ROADMAP queue A item 12")
    recording = bool(args.trace_jsonl or args.metrics_report or args.profile_dir)
    if recording:
        obs.enable(trace_jsonl=args.trace_jsonl)
    try:
        run = _train(args)
    finally:
        if recording:
            obs.disable()  # close the sink so the trace file is complete
    if args.trace_jsonl:
        print(f"[obs] trace written to {args.trace_jsonl} — render with "
              f"'python -m repro_torch.obs.reporting {args.trace_jsonl}'")
    return run


def _train(args):
    device = resolve_device(args.device)
    cfg = get_config(args.arch)
    if not args.full:
        cfg = cfg.reduced()
    model = build_model(cfg, device=device,
                        generator=torch.Generator(device=device).manual_seed(0))
    shape = dataclasses.replace(SHAPES["train_4k"], seq_len=args.seq,
                                global_batch=args.batch)

    run = make_optimizer(args.optimizer, model, lr=args.lr, damping=args.damping,
                         cg_iters=args.cg_iters, track_variance=args.track_variance,
                         microbatch_size=args.microbatch_size)
    if args.microbatch_size:
        print(f"[accumulate] microbatch_size={args.microbatch_size} "
              f"({-(-args.batch // args.microbatch_size)} microbatches per step)")
    if args.optimizer == "cg_ngd":
        print(f"[cg_ngd] matrix-free natural gradient: {args.cg_iters} CG "
              f"iterations/step, damping {args.damping:g} — no explicit "
              f"curvature factors")

    loop = LoopConfig(steps=args.steps, ckpt_dir=args.ckpt, log_every=10,
                      ckpt_keep=args.ckpt_keep)
    injector = None
    if args.fail_at_step is not None:
        injector = FailureInjector(fail_at_step=args.fail_at_step)
        print(f"[fault] injecting failure at step {args.fail_at_step}")
    opt = run.pop("opt")
    kw = dict(run, injector=injector)
    t0 = time.perf_counter()
    with obs.profile(args.profile_dir, cuda=device.type == "cuda"):
        if args.max_restarts > 0:
            (params, _, hist, wd), restarts = fit_with_restarts(
                model, cfg, shape, opt, loop, max_restarts=args.max_restarts,
                on_restart=lambda i, e: print(f"[restart {i}] after: {e}"), **kw)
            print(f"[fault] completed with {restarts} restart(s)")
        else:
            params, _, hist, wd = fit(model, cfg, shape, opt, loop, resume=args.resume, **kw)
    print(f"final loss {hist[-1]['loss']:.4f} "
          f"(stragglers flagged: {len(wd.straggler_steps)}; {cfg.name}, "
          f"{cfg.n_layers} layers, {cfg.dtype}, on {device}, "
          f"{time.perf_counter() - t0:.1f} s)")
    if args.profile_dir:
        print(f"[obs] torch.profiler trace in {os.path.join(args.profile_dir, TRACE_FILE)}")
    if args.metrics_report:
        print(obs.report())
    return dict(cfg=cfg, shape=shape, model=model, params=params, history=hist, watchdog=wd)


if __name__ == "__main__":
    main()
