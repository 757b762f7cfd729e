"""LR schedules as step → multiplier functions.

Port of ``src/repro/optim/schedule.py``; the multipliers are Python floats
(PyTorch runs eagerly, so nothing needs tracing).
"""
from __future__ import annotations

import math


def constant():
    return lambda step: 1.0


def linear_warmup(warmup_steps):
    def f(step):
        return min(1.0, (step + 1) / max(warmup_steps, 1))

    return f


def cosine(total_steps, warmup_steps=0, final=0.1):
    def f(step):
        warm = min(1.0, (step + 1) / max(warmup_steps, 1))
        frac = min(max((step - warmup_steps) / max(total_steps - warmup_steps, 1), 0.0), 1.0)
        return warm * (final + (1 - final) * 0.5 * (1 + math.cos(math.pi * frac)))

    return f
