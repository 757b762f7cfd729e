"""Serving launcher: batched generation with KV caches.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch hymba-1.5b \
        --batch 4 --prompt-len 8 --max-len 64 [--full] [--device cpu]

Port of ``src/repro/launch/serve.py`` for the decoder-only archs the port
builds (the dense ones, e.g. ``--arch stablelm-1.6b``, and Hymba).  Without
``--full`` the arch's ``reduced()`` config is served; weights are random,
drawn from ``--seed``.  It runs on the card unless ``--device cpu`` is given.
``--uncertainty`` (a last-layer Laplace endpoint on synthetic calibration
data) waits for ROADMAP queue A item 13.7.
"""
from __future__ import annotations

import argparse
import time

import torch

from repro_torch.configs import get_config
from repro_torch.core.module import resolve_device
from repro_torch.nn.models import build_model
from repro_torch.serve.engine import ServeConfig, generate


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=8)
    ap.add_argument("--max-len", type=int, default=64)
    ap.add_argument("--temperature", type=float, default=0.0)
    ap.add_argument("--full", action="store_true")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--uncertainty", action="store_true",
                    help="next-token mean + Laplace predictive variance "
                         "instead of sampled tokens")
    args = ap.parse_args(argv)

    if args.uncertainty:
        raise NotImplementedError("--uncertainty (LastLayerLaplace on an LM head with "
                                  "data/synthetic) is still to port: ROADMAP queue A item 13.7")
    cfg = get_config(args.arch)
    if not args.full:
        cfg = cfg.reduced()
    device = resolve_device(args.device)
    model = build_model(cfg, device=device,
                        generator=torch.Generator().manual_seed(args.seed))
    params = model.params()
    sc = ServeConfig(max_len=args.max_len, temperature=args.temperature)
    prompts = torch.randint(0, cfg.vocab, (args.batch, args.prompt_len),
                            generator=torch.Generator().manual_seed(args.seed + 1))
    t0 = time.perf_counter()
    toks = generate(model, params, prompts.to(device), sc,
                    rng=torch.Generator(device=device).manual_seed(args.seed + 2))
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    dt = time.perf_counter() - t0
    print(f"generated {tuple(toks.shape)} tokens on {device} in {dt:.2f} s "
          f"({cfg.name}, {cfg.n_layers} layers, {cfg.dtype})")
    for row in toks[: min(2, args.batch)].tolist():
        print(" ", " ".join(str(t) for t in row[:24]), "...")


if __name__ == "__main__":
    main()
