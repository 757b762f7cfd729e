"""Train a ~100M-parameter transformer with the paper's preconditioned
update (Eq. 7): KFAC and DiagGGN-MC against an AdamW baseline.

    PYTHONPATH=src python -m repro_torch.examples.curvature_training \
        [--steps 100] [--seq 64] [--batch 8] [--device cpu]

Model: 12 layers, d 768, 12 heads, d_ff 3072, vocabulary 8192, float32 ≈ 98M
parameters, on the synthetic token stream (:mod:`repro_torch.data`),
through :func:`repro_torch.train.loop.fit`; the three runs start from the
same weights (a generator seeded 0).  Runs on the card; ``--device cpu``
runs it on the CPU (``--steps 20 --seq 32 --batch 4`` there).  Port of
``examples/curvature_training.py``; returns the three histories.
"""
from __future__ import annotations

import argparse
import dataclasses
import time

import torch

from repro_torch.configs import SHAPES
from repro_torch.configs.base import ModelConfig
from repro_torch.core import KFAC, DiagGGNMC, ExtensionConfig
from repro_torch.core.module import resolve_device
from repro_torch.nn.models import build_model
from repro_torch.optim import adamw, curvature_optimizer
from repro_torch.train.loop import LoopConfig, fit

CFG_100M = ModelConfig(
    name="demo-100m", kind="dense", family="dense",
    n_layers=12, d_model=768, n_heads=12, kv_heads=12, d_ff=3072,
    vocab=8192, act="gelu", norm="rmsnorm", glu=False, dtype="float32",
)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    cfg = CFG_100M
    device = resolve_device(args.device)
    model = build_model(cfg, device=device, generator=torch.Generator().manual_seed(0))
    print(f"model: {cfg.param_count(model)/1e6:.1f}M params on {device}")
    shape = dataclasses.replace(SHAPES["train_4k"], seq_len=args.seq, global_batch=args.batch)
    loop = LoopConfig(steps=args.steps, log_every=20)

    t0 = time.perf_counter()
    print("\n=== AdamW baseline ===")
    _, _, hist_adam, _ = fit(model, cfg, shape, adamw(3e-4), loop)

    print("\n=== KFAC-preconditioned (paper Eq. 7) ===")
    opt = curvature_optimizer(0.1, damping=0.3, curvature="kfac", stat_decay=0.95)
    _, _, hist_kfac, _ = fit(model, cfg, shape, opt, loop, extensions=(KFAC,),
                             ext_cfg=ExtensionConfig(mc_samples=1))

    print("\n=== DiagGGN-MC-preconditioned ===")
    opt = curvature_optimizer(0.05, damping=0.3, curvature="diag_ggn_mc")
    _, _, hist_dg, _ = fit(model, cfg, shape, opt, loop, extensions=(DiagGGNMC,),
                           ext_cfg=ExtensionConfig(mc_samples=1))

    print(f"\nfinal losses after {args.steps} steps "
          f"({time.perf_counter() - t0:.0f}s total):")
    print(f"  adamw        {hist_adam[-1]['loss']:.4f}")
    print(f"  kfac         {hist_kfac[-1]['loss']:.4f}")
    print(f"  diag_ggn_mc  {hist_dg[-1]['loss']:.4f}")
    return {"adamw": hist_adam, "kfac": hist_kfac, "diag_ggn_mc": hist_dg}


if __name__ == "__main__":
    main()
