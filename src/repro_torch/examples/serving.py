"""Batched serving demo: prefill + KV-cache decode on three architecture
families (GQA transformer, RWKV6 recurrent state, Whisper encoder-decoder).

    PYTHONPATH=src python -m repro_torch.examples.serving [--device cpu]

The reduced StableLM-2 and RWKV6 configs sample 4 continuations of 6-token
prompts to 24 tokens at temperature 0.8; the reduced Whisper encodes 4 sets
of 32 random frames and decodes 16 tokens greedily.  Weights are random,
from a generator seeded 0.  Runs on the card; ``--device cpu`` runs it on
the CPU.  Port of ``examples/serving.py``; returns each arch's tokens.
"""
from __future__ import annotations

import argparse
import time

import torch

from repro_torch.configs import get_config
from repro_torch.core.module import resolve_device
from repro_torch.nn.models import build_model
from repro_torch.serve import ServeConfig, generate, generate_whisper

ARCHS = ("stablelm-1.6b", "rwkv6-3b", "whisper-tiny")


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    device = resolve_device(ap.parse_args(argv).device)
    out = {}
    for arch in ARCHS:
        cfg = get_config(arch).reduced()
        model = build_model(cfg, device=device, generator=torch.Generator().manual_seed(0))
        params = model.params()
        inputs = torch.Generator().manual_seed(1)
        t0 = time.perf_counter()
        if cfg.kind == "encdec":
            frames = torch.randn((4, 32, cfg.d_model), generator=inputs).to(device)
            toks = generate_whisper(model, params, frames, ServeConfig(max_len=16))
        else:
            prompts = torch.randint(0, cfg.vocab, (4, 6), generator=inputs).to(device)
            toks = generate(model, params, prompts, ServeConfig(max_len=24, temperature=0.8),
                            rng=torch.Generator(device=device).manual_seed(2))
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        dt = time.perf_counter() - t0
        print(f"{arch:16s} generated {tuple(toks.shape)} in {dt:.1f}s on {device}; "
              f"first row: {toks[0, :10].tolist()}")
        out[arch] = toks
    return out


if __name__ == "__main__":
    main()
