"""Batched serving engine: prefill → decode with KV caches + sampling.

Port of ``src/repro/serve/engine.py``.  ``generate`` runs a static-batch
decode loop with greedy/temperature sampling and per-sequence EOS tracking
(finished slots keep decoding token 0: the static-shape analogue of
continuous batching's slot reuse).  Where JAX scans, the port loops in
Python, one ``serve_step`` a position.  ``generate_whisper`` serves the
encoder-decoder: the frames encoded once, then greedy decode.

``generate`` records JAX's :mod:`repro_torch.obs` spans ``serve/prefill``
and ``serve/decode``; with the registry enabled it waits for the card at the
end of the decode (JAX's ``block_until_ready``), so the span and the
``serve.decode.s_per_token`` gauge measure the decode's completion, and
counts ``serve.requests`` and ``serve.tokens``.  Disabled, ``generate``
adds no synchronization.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Optional

import torch

from repro_torch import obs


@dataclasses.dataclass
class ServeConfig:
    max_len: int = 256
    temperature: float = 0.0  # 0 = greedy
    eos_id: int = -1          # -1: never stop early
    cache_dtype: str = "float32"


def _vocab_of(model):
    head = model.mods[-1] if hasattr(model, "mods") else model.children_map["head"]
    return head.d_out


def prefill(model, params, caches, prompts, prompt_len):
    """Feed prompt tokens one position at a time (cache-filling).

    prompts: [N, P] int.  Returns (caches, last_logits).
    """
    logits = torch.zeros((prompts.shape[0], _vocab_of(model)), dtype=torch.float32,
                         device=prompts.device)
    for t in range(prompt_len):
        logits, caches = model.serve_step(params, caches, prompts[:, t], t)
    return caches, logits


def generate(model, params, prompts, cfg: ServeConfig,
             rng: Optional[torch.Generator] = None):
    """prompts: [N, P] → tokens [N, max_len] (prompt + continuation), int32.

    ``rng`` (a ``torch.Generator`` on the prompts' device, seeded 0 if None)
    draws the temperature samples; greedy decoding draws nothing.
    """
    n, p = prompts.shape
    prompts = prompts.to(torch.int32)
    caches = model.init_serve_cache(params, n, cfg.max_len, getattr(torch, cfg.cache_dtype))
    with obs.span("serve/prefill", n=n, tokens=int(p)):
        caches, logits = prefill(model, params, caches, prompts, p)
    if rng is None:
        rng = torch.Generator(device=prompts.device).manual_seed(0)

    def sample(logits):
        if cfg.temperature <= 0.0:
            return torch.argmax(logits, dim=-1).to(torch.int32)
        probs = torch.softmax((logits / cfg.temperature).float(), dim=-1)
        return torch.multinomial(probs, 1, generator=rng)[:, 0].to(torch.int32)

    done = torch.zeros((n,), dtype=torch.bool, device=prompts.device)
    toks = []
    n_decode = cfg.max_len - p
    reg = obs.get()
    with obs.span("serve/decode", n=n, tokens=int(n_decode)):
        t0 = time.perf_counter() if reg.enabled else 0.0
        for t in range(p, cfg.max_len):
            tok = sample(logits)
            tok = torch.where(done, torch.zeros_like(tok), tok)
            done = done | (tok == cfg.eos_id)
            logits, caches = model.serve_step(params, caches, tok, t)
            toks.append(tok)
        if reg.enabled:
            # wait for the decode, so the span and the gauge measure its
            # completion and not its dispatch (the serving latency)
            if prompts.is_cuda:
                torch.cuda.synchronize(prompts.device)
            dt = time.perf_counter() - t0
            reg.count("serve.requests", n)
            reg.count("serve.tokens", n * int(n_decode))
            reg.gauge("serve.decode.s_per_token", dt / max(int(n_decode), 1))
    if not toks:
        return prompts
    return torch.cat([prompts, torch.stack(toks, dim=1)], dim=1)


def generate_whisper(model, params, frames, cfg: ServeConfig, bos=0):
    """Whisper: encode ``frames`` [N, S, d] once, fill each decoder layer's
    cross K/V from the encoder output, then decode greedily from ``bos`` for
    ``min(cfg.max_len, model.max_dec)`` steps → tokens [N, steps], int32."""
    n = frames.shape[0]
    enc_out = model.encode(params, frames)
    caches = model.init_serve_cache(params, n, model.max_dec, getattr(torch, cfg.cache_dtype),
                                    enc_out=enc_out)
    tok = torch.full((n,), bos, dtype=torch.int32, device=frames.device)
    toks = []
    for t in range(min(cfg.max_len, model.max_dec)):
        logits, caches = model.serve_step(params, caches, tok, t)
        tok = torch.argmax(logits, dim=-1).to(torch.int32)
        toks.append(tok)
    return torch.stack(toks, dim=1)
