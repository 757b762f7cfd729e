#!/usr/bin/env python3
"""How often ``chip_smoke.py``'s 3C3D card-vs-CPU check meets a max-pool
tie: the ten extensions' ``run`` on the card against the CPU, on batches
drawn from several seeds.

    python3 tools/c3d3_pool_ties.py [--seeds 0 1 2 ...]

Needs one CUDA card and nvcc.  For each seed it draws a batch of 128
CIFAR-10-shaped inputs and labels from a CUDA generator with that seed
(3C3D's weights from CPU seed 0 and the MC draws from CPU seed 1, as
``chip_smoke.py``), runs ``run`` with the ten extensions on the fused
route on the card and on the CPU, and prints one JSON line: max |card −
CPU| / max |CPU| of the logits, the gradient and each extension (over its
leaves; what ``chip_smoke.py`` limits with ``TOL``), BatchGrad's error
sample by sample (the worst sample and the median), and each max-pool
window whose argmax the card's forward chooses differently from the CPU's
(layer, sample, and the gap between the window's two largest inputs over
the largest): a flip routes that sample's gradient to another input of the
pool.  Then the same seed's batch goes through ``chip_smoke.py``'s
card-against-CPU check (``card_vs_cpu``: the flipped samples named and left
out of the per-sample outputs, the batch-summed ones read on the sub-batch
without them), whose line is printed as ``check``; the script exits 1 if the
check fails on any seed.
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
    parser.add_argument("--seeds", type=int, nargs="+", default=list(range(8)))
    cli = parser.parse_args()
    if not torch.cuda.is_available():
        print("FAILED: no CUDA card", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from chip_smoke import EXACT, FIRST, MC, N, card_vs_cpu
    from repro_torch.configs import papernets
    from repro_torch.core import CrossEntropyLoss, ExtensionConfig, by_name, run
    from repro_torch.core.tree import tree_leaves, tree_map
    from repro_torch.nn.layers import MaxPool2d

    def rel(got, want):
        return max(((a.cpu() - b).abs().max() / b.abs().max()).item()
                   for a, b in zip(tree_leaves(got), tree_leaves(want), strict=True))

    loss = CrossEntropyLoss()
    model = papernets.c3d3(device="cuda", generator=torch.Generator().manual_seed(0))
    params = model.params()
    cpu_params = tree_map(lambda t: t.cpu(), params)
    exts = tuple(by_name(n) for n in FIRST + EXACT + MC)
    cfg = ExtensionConfig(use_kernels=True, use_fused=True)
    draws = torch.randint(0, 10, (1, N), generator=torch.Generator().manual_seed(1))
    failed = []
    for seed in cli.seeds:
        gen = torch.Generator(device="cuda").manual_seed(seed)
        x = torch.randn(N, 32, 32, 3, device="cuda", generator=gen)
        y = torch.randint(0, 10, (N,), device="cuda", generator=gen)
        card = run(model, params, x, y, loss, extensions=exts, cfg=cfg, rng=draws)
        cpu = run(model, cpu_params, x.cpu(), y.cpu(), loss, extensions=exts, cfg=cfg, rng=draws)
        line = dict(seed=seed, logits=rel(card.logits, cpu.logits), grads=rel(card.grads, cpu.grads))
        line.update({e.name: rel(card.ext[e.name], cpu.ext[e.name]) for e in exts})
        per_sample = torch.stack([
            (a.cpu() - b).abs().flatten(1).max(1).values / b.abs().max()
            for a, b in zip(tree_leaves(card.ext["batch_grad"]),
                            tree_leaves(cpu.ext["batch_grad"]))]).max(0).values
        line.update(worst_sample=int(per_sample.argmax()), worst_sample_err=per_sample.max().item(),
                    median_sample_err=per_sample.median().item(), flips=[])
        hc, hp = x, x.cpu()
        for i, (m, p, pc) in enumerate(zip(model.mods, params, cpu_params)):
            if isinstance(m, MaxPool2d):
                flipped = (m._pool(hc)[1].cpu() != m._pool(hp)[1])  # [N, C, H', W']
                n, h, w, c = hp.shape
                win = hp.reshape(n, h // 2, 2, w // 2, 2, c).permute(0, 5, 1, 3, 2, 4)
                top2 = win.reshape(n, c, h // 2, w // 2, 4).topk(2, dim=-1).values
                gap = (top2[..., 0] - top2[..., 1]) / top2[..., 0].abs().clamp_min(1e-30)
                for s, gp in zip(flipped.nonzero()[:, 0].tolist(), gap[flipped].tolist()):
                    line["flips"].append(dict(layer=i, sample=s, gap=gp,
                                              sample_err=per_sample[s].item()))
            hc, hp = m.call(p, hc), m.call(pc, hp)
        del card, cpu
        check = card_vs_cpu(torch, run, model, params, x, y, loss, exts, draws, cfg)
        line["check"] = check
        if check["bad"] or check["reflipped"]:
            failed.append(seed)
        print(json.dumps(line), flush=True)
    print(json.dumps({"seeds": cli.seeds, "check_failed": failed}), flush=True)
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
