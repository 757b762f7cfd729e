"""DP-SGD-style per-sample gradient clipping — the classic BackPACK
application: clip each sample's gradient to a norm bound, with the norms
from BatchL2 (no per-sample gradients needed for them).  Runs on the card;
``--device cpu`` runs it on the CPU:

    PYTHONPATH=src python -m repro_torch.examples.per_sample_clipping [--device cpu]
"""
from __future__ import annotations

import argparse

import torch

from repro_torch.core import (
    Activation,
    BatchGrad,
    BatchL2,
    CrossEntropyLoss,
    Dense,
    Sequential,
    run,
)
from repro_torch.core.tree import tree_leaves, tree_map

CLIP = 0.05


def clipped_grad(model, params, X, y, loss):
    """(loss, per-sample gradient norms [N], the clipped mean gradient)."""
    res = run(model, params, X, y, loss, extensions=(BatchGrad, BatchL2))
    # total per-sample norms across all parameters, from the L2 extension
    total_sq = sum(tree_leaves(res["batch_l2"]))
    norms = total_sq.sqrt()
    scale = (CLIP / (norms + 1e-12)).clamp(max=1.0)  # [N]
    clipped = tree_map(lambda bg: torch.einsum("n,n...->...", scale, bg), res["batch_grad"])
    return res.loss, norms, clipped


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    device = ap.parse_args(argv).device
    gen = torch.Generator().manual_seed(0)
    model = Sequential([Dense(64, 64, device=device, generator=gen), Activation("tanh"),
                        Dense(64, 10, device=device, generator=gen)])
    X = (torch.randn(16, 64, generator=gen) * 3.0).to(device)
    y = torch.randint(0, 10, (16,), generator=gen).to(device)

    lv, norms, g = clipped_grad(model, model.params(), X, y, CrossEntropyLoss())
    print(f"loss {lv.item():.4f}")
    print("per-sample grad norms:", norms.cpu().numpy().round(4))
    print(f"clipped fraction: {(norms > CLIP).float().mean().item():.2f}")
    print("clipped-gradient norm per leaf:")
    for i, leaf in enumerate(tree_leaves(g)):
        print(f"  leaf {i}: {leaf.norm().item():.5f}")


if __name__ == "__main__":
    main()
