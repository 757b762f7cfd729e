"""Gradient-noise-scale telemetry from the Variance extension — the
adaptive-batch-size signal of Balles et al. (2017) (paper §1), computed
during training at marginal cost.

    PYTHONPATH=src python -m repro_torch.examples.noise_scale [--device cpu]

AdamW on the reduced StableLM-2 config, 30 steps of 16 sequences of 32
tokens from the synthetic stream; each step's ``run`` with Variance gives
the gradient and tr(Σ), and the simple noise scale tr(Σ) / ‖g‖² (the
critical batch size) is printed every 5 steps.  Runs on the card;
``--device cpu`` runs it on the CPU.  Port of ``examples/noise_scale.py``;
returns the (step, loss, noise scale) rows.
"""
from __future__ import annotations

import argparse
import dataclasses

import torch

from repro_torch.configs import SHAPES, get_config
from repro_torch.core import CrossEntropyLoss, Variance, run
from repro_torch.core.module import resolve_device
from repro_torch.core.tree import tree_leaves
from repro_torch.data.synthetic import batch_for
from repro_torch.nn.models import build_model
from repro_torch.optim import adamw
from repro_torch.optim.optimizers import apply_updates

CFG = get_config("stablelm-1.6b").reduced()
STEPS = 30


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    device = resolve_device(ap.parse_args(argv).device)
    cfg = CFG
    model = build_model(cfg, device=device, generator=torch.Generator().manual_seed(0))
    params = model.params()
    shape = dataclasses.replace(SHAPES["train_4k"], seq_len=32, global_batch=16)
    loss = CrossEntropyLoss()
    opt = adamw(1e-3)
    opt_state = opt.init(params)

    def step(params, opt_state, batch):
        res = run(model, params, batch["inputs"], batch["labels"], loss,
                  extensions=(Variance,))
        # simple gradient noise scale:  tr(Σ) / ‖g‖²   (critical batch size)
        tr_sigma = sum(v.float().sum() for v in tree_leaves(res["variance"]))
        g_sq = sum((g.float() ** 2).sum() for g in tree_leaves(res.grads))
        noise_scale = tr_sigma / (g_sq + 1e-12)
        ups, opt_state = opt.update(res.grads, opt_state, params)
        return apply_updates(params, ups), opt_state, res.loss, noise_scale

    print(f"{'step':>5s} {'loss':>8s} {'noise_scale':>12s}  (critical batch ~ noise scale)")
    rows = []
    for i in range(STEPS):
        batch = batch_for(cfg, shape, i, device=device)
        params, opt_state, lv, ns = step(params, opt_state, batch)
        rows.append((i, float(lv), float(ns)))
        if i % 5 == 0:
            print(f"{i:5d} {rows[-1][1]:8.4f} {rows[-1][2]:12.1f}")
    print("\nRising noise scale => larger batches pay off (Balles et al. 2017).")
    return rows


if __name__ == "__main__":
    main()
