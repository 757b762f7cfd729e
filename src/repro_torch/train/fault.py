"""Fault tolerance: failure injection, a watchdog, and restart-with-resume
drivers.

Port of ``src/repro/train/fault.py``.  The watchdog records stragglers and
stalls; the restart drivers rerun their job from its last checkpoint after
any exception, so the restart path can be exercised end to end in tests.
Each fault caught counts ``fault.restarts`` (``fault.sweep_restarts`` for a
sweep) in :mod:`repro_torch.obs`.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Callable, Optional

from repro_torch import obs


class SimulatedFailure(RuntimeError):
    pass


@dataclasses.dataclass
class FailureInjector:
    """Raise :class:`SimulatedFailure` at a given step (or work unit)."""

    fail_at_step: Optional[int] = None
    fail_once: bool = True
    _fired: bool = False

    def check(self, step: int):
        if (self.fail_at_step is not None and step == self.fail_at_step
                and not (self.fail_once and self._fired)):
            self._fired = True
            raise SimulatedFailure(f"injected failure at step {step}")


class Watchdog:
    """Track step durations; flag stragglers (> ``straggler_factor`` × the
    running median) and stalls (no heartbeat for ``stall_s``)."""

    def __init__(self, straggler_factor=3.0, stall_s=600.0, window=64):
        self.factor = straggler_factor
        self.stall_s = stall_s
        self.window = window
        self.durations = []
        self.straggler_steps = []
        self.last_beat = time.perf_counter()

    def beat(self, step: int, duration_s: float):
        self.last_beat = time.perf_counter()
        self.durations.append(duration_s)
        if len(self.durations) > self.window:
            self.durations.pop(0)
        med = sorted(self.durations)[len(self.durations) // 2]
        if len(self.durations) >= 8 and duration_s > self.factor * med:
            self.straggler_steps.append(step)
            return False
        return True

    def stalled(self):
        return (time.perf_counter() - self.last_beat) > self.stall_s


def run_with_restarts(make_and_run: Callable[[Optional[int]], int],
                      max_restarts: int = 3, on_restart=None):
    """Drive ``make_and_run(resume_step)`` to completion across failures.

    ``make_and_run`` restores from its checkpoint directory when
    ``resume_step`` is not None, runs, and returns the final step.  Any
    exception triggers a retry from the latest checkpoint (``resume_step``
    -1), up to ``max_restarts``.  Returns ``(final step, restarts)``.
    """
    restarts = 0
    resume = None
    while True:
        try:
            return make_and_run(resume), restarts
        except Exception as e:  # noqa: BLE001 — any fault triggers restart
            restarts += 1
            obs.count("fault.restarts")
            if restarts > max_restarts:
                raise
            if on_restart is not None:
                on_restart(restarts, e)
            resume = -1  # sentinel: restore from latest


def run_sweep_with_restarts(plan, model, params, inputs, targets, loss,
                            checkpointer, *, cfg=None, rng=None,
                            checkpoint_every: int = 1,
                            max_restarts: int = 3, injector=None,
                            on_restart=None):
    """Drive a checkpointed accumulated sweep to completion across failures.

    Each attempt calls ``plan.run_checkpointed(..., resume=True)``: the first
    is a cold start, every retry restores the latest snapshot from
    ``checkpointer`` and continues at the interrupted work unit, so the
    results equal an uninterrupted sweep's.

    Parameters
    ----------
    plan : repro_torch.core.AccumulatedSweepPlan
        The accumulated sweep to run.
    checkpointer : repro_torch.train.checkpoint.SweepCheckpointer
        Snapshot store shared by every attempt.
    injector : FailureInjector, optional
        A deterministic kill mid-stream (checked per work unit).
    on_restart : callable, optional
        ``on_restart(restart_index, exception)`` before each retry.

    Returns
    -------
    (Results, int)
        The finished results and the number of restarts taken.
    """
    restarts = 0
    while True:
        try:
            res = plan.run_checkpointed(
                model, params, inputs, targets, loss, cfg=cfg, rng=rng,
                checkpointer=checkpointer, checkpoint_every=checkpoint_every,
                injector=injector, resume=True)
            return res, restarts
        except Exception as e:  # noqa: BLE001 — any fault triggers restart
            restarts += 1
            obs.count("fault.sweep_restarts")
            if restarts > max_restarts:
                raise
            if on_restart is not None:
                on_restart(restarts, e)
