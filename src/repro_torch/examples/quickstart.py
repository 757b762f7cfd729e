"""Quickstart — the paper's Fig. 1 workflow in this framework.

BackPACK (PyTorch):                     repro_torch:
    model = extend(Sequential(...))         model = Sequential([...])
    with backpack(Variance()):              res = run(model, model.params(), X, y,
        loss.backward()                               loss, extensions=(Variance,))
    param.grad / param.var                  res.grads / res["variance"]

One generalized backward pass returns the batch gradient AND the requested
extension quantities.  Runs on the card; ``--device cpu`` runs it on the CPU
(the kernels' plain versions):

    PYTHONPATH=src python -m repro_torch.examples.quickstart [--device cpu]
"""
from __future__ import annotations

import argparse

import torch

from repro_torch.core import (
    KFAC,
    Activation,
    BatchGrad,
    BatchL2,
    CrossEntropyLoss,
    Dense,
    DiagGGNMC,
    Sequential,
    Variance,
    run,
)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    device = ap.parse_args(argv).device
    gen = torch.Generator().manual_seed(0)
    # a small classifier (the paper's MNIST logistic-regression example, widened)
    model = Sequential([Dense(784, 128, device=device, generator=gen), Activation("relu"),
                        Dense(128, 10, device=device, generator=gen)])
    X = torch.randn(32, 784, generator=gen).to(device)
    y = torch.randint(0, 10, (32,), generator=gen).to(device)

    res = run(model, model.params(), X, y, CrossEntropyLoss(),
              extensions=(BatchGrad, BatchL2, Variance, DiagGGNMC, KFAC),
              rng=torch.Generator(device=device).manual_seed(3))

    print(f"loss                      : {res.loss.item():.4f}")
    print(f"grad (layer-0 W)          : shape {tuple(res.grads[0]['w'].shape)}")
    print(f"per-sample grads          : shape {tuple(res['batch_grad'][0]['w'].shape)}")
    print(f"per-sample L2 norms       : {res['batch_l2'][0]['w'][:5].cpu().numpy().round(6)}")
    print(f"gradient variance (mean)  : {res['variance'][0]['w'].mean().item():.3e}")
    print(f"DiagGGN-MC (layer-0, mean): {res['diag_ggn_mc'][0]['w'].mean().item():.3e}")
    kf = res["kfac"][0]["w"]
    print(f"KFAC factors (layer 0)    : A {tuple(kf['A'].shape)}  B {tuple(kf['B'].shape)}")
    print("\nAll of the above came out of ONE extended backward pass.")


if __name__ == "__main__":
    main()
