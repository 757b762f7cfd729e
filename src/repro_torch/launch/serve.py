"""Serving launcher: batched generation with KV caches, plus an
uncertainty-aware endpoint backed by a last-layer Laplace posterior.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch hymba-1.5b \
        --batch 4 --prompt-len 8 --max-len 64 [--full] [--device cpu]

    # next-token mean + predictive variance instead of sampled tokens:
    PYTHONPATH=src python -m repro_torch.launch.serve --arch stablelm-1.6b \
        --batch 4 --prompt-len 8 --uncertainty [--device cpu]

Port of ``src/repro/launch/serve.py`` for the archs the port builds: the
decoder-only ones (the dense ones, e.g. ``--arch stablelm-1.6b``, Hymba,
RWKV6 and the mixture of experts ``--arch granite-moe-1b-a400m``) and
Whisper (``--arch whisper-tiny``: ``--batch`` sets of 64 random frames
drawn on the device, encoded once, then greedy decode; it has no
``--uncertainty``).  Without
``--full`` the arch's ``reduced()`` config is served; weights are random,
drawn from a generator seeded ``--seed`` on the device (the card's draws 1.6
billion weights in a fraction of the CPU's time).  It runs on the card unless
``--device cpu`` is given.
"""
from __future__ import annotations

import argparse
import time

import torch

from repro_torch.configs import get_config
from repro_torch.core.module import resolve_device
from repro_torch.nn.models import build_model
from repro_torch.serve.engine import ServeConfig, generate, generate_whisper


def serve_uncertainty(cfg, model, params, prompts, *, marglik_steps=25, seed=0, top_k=5,
                      log_fn=print):
    """Uncertainty-aware endpoint: next-token logit mean + variance.

    Fits a last-layer **diagonal** Laplace posterior on one deterministic
    calibration batch (``lm_batch(..., 0)`` on the prompts' device) — the
    only structure that scales to LM heads: its state is O(d·V) where the
    Kronecker B factor would be a dense [V, V] (plus an O(V³)
    eigendecomposition), and the MC sweep (DiagGGNMC, from a generator
    seeded ``seed``) keeps the curvature pass at one gradient-like sweep.
    Prior precision is tuned by evidence ascent; predictions use the rank-1
    closed-form GLM for the final prompt position (no Jacobian seed
    materialized — see ``laplace.predictive._dense_glm_closed_form``).
    """
    from repro_torch import laplace
    from repro_torch.core import CrossEntropyLoss, ExtensionConfig
    from repro_torch.data.synthetic import DataConfig, lm_batch
    from repro_torch.laplace.posterior import split_last_dense

    loss = CrossEntropyLoss()
    dc = DataConfig(vocab=cfg.vocab, seq_len=prompts.shape[1],
                    global_batch=prompts.shape[0], seed=seed)
    calib = lm_batch(dc, 0, device=prompts.device)
    post = laplace.fit_posterior(
        model, params, calib["inputs"], calib["labels"], loss,
        structure="diag", last_layer=True,
        options=laplace.FitOptions(mc=True, cfg=ExtensionConfig(mc_seed=seed)))
    post, res = laplace.optimize_marglik(post, n_steps=marglik_steps)
    log_fn(f"[laplace] log-evidence {float(laplace.log_marglik(post)):.1f} "
           f"prior_prec {res.prior_prec:.3g}")

    feats, head, f_params, h_params = split_last_dense(model, params)
    with torch.no_grad():
        phi = feats.call(f_params, prompts)       # [N, T, d]
    mean, var = laplace.glm_predictive(head, h_params, post.inner,
                                       phi[:, -1])  # final position: [N, V]
    probs = laplace.probit_predictive(mean, var)
    for n in range(min(2, mean.shape[0])):
        order = torch.argsort(-mean[n])[:top_k].tolist()
        row = " ".join(f"tok{t}:{float(mean[n, t]):.2f}±{float(var[n, t].sqrt()):.2f}"
                       for t in order)
        log_fn(f"  prompt {n}: {row}")
    return mean, var, probs


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

    cfg = get_config(args.arch)
    if not args.full:
        cfg = cfg.reduced()
    if args.uncertainty and cfg.kind == "encdec":
        raise SystemExit("--uncertainty supports decoder-only archs")
    device = resolve_device(args.device)
    model = build_model(cfg, device=device,
                        generator=torch.Generator(device=device).manual_seed(args.seed))
    params = model.params()
    sc = ServeConfig(max_len=args.max_len, temperature=args.temperature)
    prompts = torch.randint(0, cfg.vocab, (args.batch, args.prompt_len),
                            generator=torch.Generator().manual_seed(args.seed + 1))
    t0 = time.perf_counter()
    if args.uncertainty:
        mean, var, _ = serve_uncertainty(cfg, model, params, prompts.to(device))
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        print(f"served mean+variance for {tuple(mean.shape)} next-token logits "
              f"(mean var {float(var.float().mean()):.4f}, min var {float(var.min()):.3g}) "
              f"on {device} in {time.perf_counter() - t0:.2f} s "
              f"({cfg.name}, {cfg.n_layers} layers, {cfg.dtype})")
        return mean, var
    if cfg.kind == "encdec":
        frames = torch.randn((args.batch, 64, cfg.d_model), device=device,
                             generator=torch.Generator(device=device).manual_seed(args.seed + 1))
        toks = generate_whisper(model, params, frames.to(getattr(torch, cfg.dtype)), sc)
    else:
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
