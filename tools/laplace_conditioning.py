#!/usr/bin/env python3
"""How well conditioned ``chip_smoke.py``'s Laplace card-vs-CPU check is:
the diagonal posterior's ``glm_predictive`` on the card against the CPU, on
3C3D batches drawn from several seeds.

    python3 tools/laplace_conditioning.py [--seeds 0 1 2 ...]

Needs one CUDA card and nvcc.  For each seed it draws a batch of 128
CIFAR-10-shaped inputs and labels (and a held-out batch) from a CUDA
generator with that seed, trains 3C3D (weights from seed 0) ten KFAC steps
as ``chip_smoke.py`` does, fits the diagonal Laplace posterior on the card
and on the CPU, and prints one JSON line: the last training loss, the
largest |logit|, and max |card − CPU| / max |CPU| of the posterior
precision (over its leaves), of ``glm_predictive``'s mean and of its var
through the kernels (``use_kernels=True``, what ``chip_smoke.py`` limits
with ``TOL``) and through the plain einsum (``use_kernels=False``), and the
two routes against each other on the card.
"""
import argparse
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))


def main() -> int:
    import torch

    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--seeds", type=int, nargs="+", default=[0, 1, 2, 3, 4, 5])
    cli = parser.parse_args()
    if not torch.cuda.is_available():
        print("FAILED: no CUDA card", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from chip_smoke import N, TRAIN, TRAIN_STEPS
    from repro_torch.configs import papernets
    from repro_torch.core import CrossEntropyLoss, by_name
    from repro_torch.core.tree import tree_leaves, tree_map
    from repro_torch.laplace import fit_posterior, glm_predictive
    from repro_torch.optim import curvature_optimizer
    from repro_torch.train import make_extended_train_step

    def rel(a, b):
        return ((a.cpu() - b).abs().max() / b.abs().max()).item()

    loss = CrossEntropyLoss()
    model = papernets.c3d3(device="cuda", generator=torch.Generator().manual_seed(0))
    curvature, names, lr, damping = TRAIN[0]  # KFAC, as chip_smoke.py trains the MAP
    for seed in cli.seeds:
        gen = torch.Generator(device="cuda").manual_seed(seed)
        x = torch.randn(N, 32, 32, 3, device="cuda", generator=gen)
        y = torch.randint(0, 10, (N,), device="cuda", generator=gen)
        x_out = torch.randn(N, 32, 32, 3, device="cuda", generator=gen)
        opt = curvature_optimizer(lr, damping=damping, curvature=curvature)
        step = make_extended_train_step(model, loss, opt, tuple(by_name(n) for n in names))
        p = model.params()
        state = opt.init(p)
        rng = torch.Generator(device="cuda").manual_seed(3)
        for i in range(TRAIN_STEPS):
            p, state, m = step(p, state, {"inputs": x, "labels": y}, i, rng)
        cpu_p = tree_map(lambda t: t.cpu(), p)
        post = fit_posterior(model, p, x, y, loss, structure="diag")
        cpu_post = fit_posterior(model, cpu_p, x.cpu(), y.cpu(), loss, structure="diag")
        mean, var = glm_predictive(model, p, post, x_out)
        _, var_plain = glm_predictive(model, p, post, x_out, use_kernels=False)
        cpu_mean, cpu_var = glm_predictive(model, cpu_p, cpu_post, x_out.cpu())
        prec = max(rel(a, b) for a, b in zip(tree_leaves(post.precision()),
                                             tree_leaves(cpu_post.precision())))
        print(json.dumps(dict(seed=seed, final_loss=m["loss"].item(),
                              max_abs_logit=mean.abs().max().item(), precision=prec,
                              mean=rel(mean, cpu_mean), var=rel(var, cpu_var),
                              var_plain_route=rel(var_plain, cpu_var),
                              routes_on_card=rel(var, var_plain.cpu()))), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
