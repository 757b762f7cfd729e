#!/usr/bin/env python3
"""How well conditioned ``chip_smoke.py``'s Laplace card-vs-CPU check is:
the diagonal posterior's ``glm_predictive`` on the card against the CPU, on
3C3D batches drawn from several seeds.

    python3 tools/laplace_conditioning.py [--seeds 0 1 2 ...]

Needs one CUDA card and nvcc.  For each seed it draws a batch of 128
CIFAR-10-shaped inputs and labels (and a held-out batch) from a CUDA
generator with that seed, trains 3C3D (weights from seed 0) ten KFAC steps
as ``chip_smoke.py`` does, fits the diagonal Laplace posterior on the card
(float32) and on the CPU in float64 (the MAP, the batch and the held-out
batch cast; ``chip_smoke.py``'s reference) and in float32, and prints one
JSON line: the last training loss, the largest |logit|, and max |card −
CPU| / max |CPU| against float64 of the posterior precision (over its
leaves), of ``glm_predictive``'s mean and of its var through the kernels
(``use_kernels=True``, what ``chip_smoke.py`` limits with ``TOL``) and
through the plain einsum (``use_kernels=False``); the same three against
the CPU's float32 (``*_f32``: the check before its reference was float64);
the two routes against each other on the card; which leaf the precision
reading comes from (``precision_leaf``: its index among the parameter
leaves and its shape); and ``pool_index_flips``, the max-pool indices the
card's float32 forward on the batch chooses differently from the CPU's
float64 one (``_f32``: from the CPU's float32 one; ``_held_out``: on the
held-out batch the predictive reads): a flip routes a sample's
backpropagated factor to another input of the pool.
"""
import argparse
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))


def index_flips(a, b) -> int:
    """Entries that differ between the integer tensors (max-pool indices) of
    two forward tapes of one model."""
    import torch

    if isinstance(a, torch.Tensor):
        if a.dtype.is_floating_point:
            return 0
        return int((a.cpu() != b.cpu()).sum())
    if isinstance(a, dict):
        return sum(index_flips(a[k], b[k]) for k in a)
    if isinstance(a, (list, tuple)):
        return sum(index_flips(u, v) for u, v in zip(a, b, strict=True))
    if hasattr(a, "__dict__"):
        return index_flips(vars(a), vars(b))
    return 0


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
        return ((a.cpu().to(b.dtype) - b).abs().max() / b.abs().max()).item()

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
        post = fit_posterior(model, p, x, y, loss, structure="diag")
        mean, var = glm_predictive(model, p, post, x_out)
        _, var_plain = glm_predictive(model, p, post, x_out, use_kernels=False)
        line = dict(seed=seed, final_loss=m["loss"].item(), max_abs_logit=mean.abs().max().item())
        for dtype, tag in ((torch.float64, ""), (torch.float32, "_f32")):
            cpu_p = tree_map(lambda t: t.cpu().to(dtype), p)
            cpu_post = fit_posterior(model, cpu_p, x.cpu().to(dtype), y.cpu(), loss,
                                     structure="diag")
            cpu_mean, cpu_var = glm_predictive(model, cpu_p, cpu_post, x_out.cpu().to(dtype))
            if dtype == torch.float64:
                cpu64 = cpu_post
            line.update({
                f"precision{tag}": max(rel(a, b) for a, b in zip(
                    tree_leaves(post.precision()), tree_leaves(cpu_post.precision()))),
                f"mean{tag}": rel(mean, cpu_mean), f"var{tag}": rel(var, cpu_var),
                f"var_plain_route{tag}": rel(var_plain, cpu_var)})
        line["routes_on_card"] = rel(var, var_plain.cpu())
        worst = max(enumerate(zip(tree_leaves(post.precision()), tree_leaves(cpu64.precision()))),
                    key=lambda e: rel(*e[1]))
        line["precision_leaf"] = [worst[0], list(worst[1][0].shape)]
        for batch, where in ((x, ""), (x_out, "_held_out")):
            card_tape = model.forward_tape(p, batch)[1]
            for dtype, tag in ((torch.float64, ""), (torch.float32, "_f32")):
                cpu_tape = model.forward_tape(tree_map(lambda t: t.cpu().to(dtype), p),
                                              batch.cpu().to(dtype))[1]
                line[f"pool_index_flips{where}{tag}"] = index_flips(card_tape, cpu_tape)
        print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
