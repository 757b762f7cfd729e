"""Deterministic synthetic data pipeline.

Every batch is a pure function of (seed, step, host slice): resuming after a
failure (or on a different host layout) regenerates the exact stream with no
iterator state to checkpoint — the data-side half of fault tolerance.

The token stream is a structured Markov-ish mixture (not uniform noise) so
losses move visibly and curvature statistics are non-degenerate: with
probability 0.7 a token is the previous one plus ``offset = step % 17 + 1``
(mod V), else a fresh uniform token.

Port of ``src/repro/data/synthetic.py``: the same construction and the same
salts (``host_id·3 + 1…4``), drawn from CPU ``torch.Generator``\\ s seeded
from (seed, step, salt) through numpy's ``SeedSequence`` — JAX's threefry
stream cannot be reproduced, so the tokens differ from JAX's while their
shapes, dtypes, masks and statistics agree.  A batch is drawn on the CPU and
moved to ``device`` (the card unless the caller asks for the CPU).
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.core.module import resolve_device


@dataclasses.dataclass(frozen=True)
class DataConfig:
    vocab: int
    seq_len: int
    global_batch: int
    seed: int = 0
    n_hosts: int = 1
    host_id: int = 0


def _fold(seed, step, salt) -> torch.Generator:
    """A CPU generator that is a pure function of (seed, step, salt)."""
    state = np.random.SeedSequence([int(seed), int(step), int(salt)]).generate_state(2)
    return torch.Generator().manual_seed(int(state[0]) << 32 | int(state[1]))


def _lm_cpu(dc: DataConfig, step: int):
    b_host = dc.global_batch // dc.n_hosts
    g1 = _fold(dc.seed, step, dc.host_id * 3 + 1)
    g2 = _fold(dc.seed, step, dc.host_id * 3 + 2)
    base = torch.randint(0, dc.vocab, (b_host, dc.seq_len + 1), generator=g1,
                         dtype=torch.int32)
    # structured component: token_{t+1} = token_t + offset (mod V) w.p. 0.7
    offset = (step % 17) + 1
    shifted = (base[:, :-1] + offset) % dc.vocab
    gate = torch.rand(shifted.shape, generator=g2) < 0.7
    seq = torch.where(gate, shifted, base[:, 1:])
    tokens = torch.cat([base[:, :1], seq], dim=1)
    return {"inputs": tokens[:, :-1], "labels": tokens[:, 1:]}


def _normal(dc: DataConfig, step: int, salt: int, shape, dtype):
    return (0.02 * torch.randn(shape, generator=_fold(dc.seed, step, dc.host_id * 3 + salt))
            ).to(dtype)


def _to(batch, device):
    if isinstance(batch, dict):
        return {k: _to(v, device) for k, v in batch.items()}
    return batch.to(device)


def lm_batch(dc: DataConfig, step: int, device="cuda"):
    """→ {'inputs': tokens [B_host, T], 'labels': [B_host, T]} int32."""
    return _to(_lm_cpu(dc, step), resolve_device(device))


def vlm_batch(dc: DataConfig, step: int, n_prefix: int, d_model: int,
              dtype=torch.float32, device="cuda"):
    """→ {'inputs': {'tokens': [B_host, T − P], 'prefix': [B_host, P, d]},
    'labels': [B_host, T]}, the P prefix positions' labels −1."""
    b_host = dc.global_batch // dc.n_hosts
    lm = _lm_cpu(dataclasses.replace(dc, seq_len=dc.seq_len - n_prefix), step)
    prefix = _normal(dc, step, 3, (b_host, n_prefix, d_model), dtype)
    labels = torch.cat([-torch.ones((b_host, n_prefix), dtype=torch.int32), lm["labels"]],
                       dim=1)
    return _to({"inputs": {"tokens": lm["inputs"], "prefix": prefix}, "labels": labels},
               resolve_device(device))


def audio_batch(dc: DataConfig, step: int, dec_len: int, d_model: int,
                dtype=torch.float32, device="cuda"):
    """→ {'inputs': {'frames': [B_host, T, d], 'tokens': [B_host, dec_len]},
    'labels': [B_host, dec_len]}."""
    b_host = dc.global_batch // dc.n_hosts
    frames = _normal(dc, step, 4, (b_host, dc.seq_len, d_model), dtype)
    lm = _lm_cpu(dataclasses.replace(dc, seq_len=dec_len), step)
    return _to({"inputs": {"frames": frames, "tokens": lm["inputs"]}, "labels": lm["labels"]},
               resolve_device(device))


def batch_for(cfg, shape_or_dc, step, seed=0, batch=None, device="cuda"):
    """Arch-aware batch from a ModelConfig + Shape (or DataConfig)."""
    seq = shape_or_dc.seq_len
    b = batch or shape_or_dc.global_batch
    dc = DataConfig(vocab=cfg.vocab, seq_len=seq, global_batch=b, seed=seed)
    dt = getattr(torch, cfg.dtype)
    if cfg.kind == "encdec":
        return audio_batch(dc, step, cfg.dec_len, cfg.d_model, dt, device=device)
    if cfg.frontend == "vision":
        return vlm_batch(dc, step, cfg.n_prefix, cfg.d_model, dt, device=device)
    return lm_batch(dc, step, device=device)
