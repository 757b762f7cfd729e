"""Laplace uncertainty end to end: train → fit posterior → tune prior via
marginal likelihood → calibrated next-token predictions.

    PYTHONPATH=src python -m repro_torch.examples.laplace_uncertainty \
        [--steps 60] [--device cpu]

Trains a small transformer LM on the deterministic synthetic token stream
(:mod:`repro_torch.data`) with the online-marglik callback watching the
evidence, then fits a last-layer Kronecker Laplace posterior around the
trained weights, tunes the prior precision by evidence ascent (no
validation set), and serves calibrated next-token predictions: GLM mean ±
predictive std at the final position (the closed form of a Dense head,
which needs no Jacobian), with MacKay's probit-corrected probabilities next
to the raw softmax.  Runs on the card; ``--device cpu`` runs it on the CPU.
Port of ``examples/laplace_uncertainty.py``; returns (mean, var).
"""
from __future__ import annotations

import argparse
import dataclasses

import torch

from repro_torch import laplace
from repro_torch.configs import SHAPES
from repro_torch.configs.base import ModelConfig
from repro_torch.core import CrossEntropyLoss, ExtensionConfig
from repro_torch.core.module import resolve_device
from repro_torch.data.synthetic import DataConfig, lm_batch
from repro_torch.laplace.posterior import split_last_dense
from repro_torch.nn.models import build_model
from repro_torch.optim import adamw
from repro_torch.train.loop import LoopConfig, fit

CFG = ModelConfig(
    name="laplace-demo", kind="dense", family="dense",
    n_layers=2, d_model=128, n_heads=4, kv_heads=4, d_ff=256,
    vocab=256, act="gelu", norm="rmsnorm", glu=False, dtype="float32",
)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--steps", type=int, default=60)
    ap.add_argument("--seq", type=int, default=32)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    cfg = CFG
    device = resolve_device(args.device)
    model = build_model(cfg, device=device, generator=torch.Generator().manual_seed(0))
    shape = dataclasses.replace(SHAPES["train_4k"], seq_len=args.seq, global_batch=args.batch)

    print("=== train (online marglik every 20 steps) ===")
    params, _, hist, _ = fit(model, cfg, shape, adamw(3e-4),
                             LoopConfig(steps=args.steps, log_every=20, marglik_every=20))

    print("\n=== fit last-layer Kronecker Laplace + tune prior ===")
    loss = CrossEntropyLoss()
    dc = DataConfig(vocab=cfg.vocab, seq_len=args.seq, global_batch=args.batch)
    batch = lm_batch(dc, step=0, device=device)
    post = laplace.fit_posterior(
        model, params, batch["inputs"], batch["labels"], loss,
        structure="kron", last_layer=True,
        options=laplace.FitOptions(mc=True, cfg=ExtensionConfig(mc_seed=0)))
    before = float(laplace.log_marglik(post))
    post, res = laplace.optimize_marglik(post, n_steps=100, lr=0.1)
    print(f"log-evidence {before:.1f} → {float(laplace.log_marglik(post)):.1f}"
          f"  (prior_prec {res.prior_prec:.3g})")

    print("\n=== calibrated next-token predictions ===")
    feats, head, f_params, h_params = split_last_dense(model, params)
    with torch.no_grad():
        phi = feats.call(f_params, batch["inputs"])          # [N, T, d]
    mean, var = laplace.glm_predictive(head, h_params, post.inner, phi[:, -1])  # [N, V]
    probs_map = torch.softmax(mean.float(), dim=-1)
    probs_cal = laplace.probit_predictive(mean, var)
    for n in range(min(3, mean.shape[0])):
        t = int(torch.argmax(mean[n]))
        print(f"  prompt {n}: top tok{t} logit "
              f"{float(mean[n, t]):.2f}±{float(var[n, t].sqrt()):.2f}  "
              f"p_map {float(probs_map[n, t]):.3f} → "
              f"p_laplace {float(probs_cal[n, t]):.3f}")
    shrink = float((probs_cal.max(-1).values / probs_map.max(-1).values).mean())
    print(f"mean top-1 confidence shrink under uncertainty: {shrink:.3f}")
    return mean, var


if __name__ == "__main__":
    main()
