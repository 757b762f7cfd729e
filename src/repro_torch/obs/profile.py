"""``torch.profiler`` integration.

``obs.profile(dir)`` records a ``torch.profiler`` trace of a region and
writes it as one Chrome trace, ``<dir>/trace.json`` (open it in Perfetto or
``chrome://tracing``); a falsy ``dir`` makes it a no-op.  While the window
is open every ``obs.span`` also opens a ``torch.profiler.record_function``
range of its name, so the device timeline lines up with the spans (the
counterpart of the ``jax.named_scope`` annotations of JAX's sweeps).

Port of ``src/repro/obs/profile.py`` (``jax.profiler``).  Profiler windows
cannot nest: ``profile`` raises when another ``torch.profiler`` window is
open.
"""
from __future__ import annotations

import os
from contextlib import contextmanager
from typing import Iterator, Optional

import torch

from repro_torch.obs import registry as _reg

__all__ = ["profile", "TRACE_FILE"]

TRACE_FILE = "trace.json"


@contextmanager
def profile(trace_dir: Optional[str], cuda: Optional[bool] = None) -> Iterator[None]:
    """Record a ``torch.profiler`` trace of the body into
    ``<trace_dir>/trace.json``.

    ``cuda`` asks for the card's activity beside the host's: None asks for
    it wherever a card is present, True requires it (``RuntimeError`` where
    the profiler cannot record CUDA activity: no host-only trace stands in
    for a device trace), False records the host alone.  The ``obs/profile``
    span is recorded around the window, so the obs trace shows which wall
    clock window the device trace covers.
    """
    if not trace_dir:
        yield
        return
    if cuda is None:
        cuda = torch.cuda.is_available()
    activities = [torch.profiler.ProfilerActivity.CPU]
    if cuda:
        if not (torch.cuda.is_available()
                and torch.profiler.ProfilerActivity.CUDA in torch.profiler.supported_activities()):
            raise RuntimeError("obs.profile: CUDA activity was asked for, but this process "
                               "has no card the profiler can trace")
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    if torch.autograd._profiler_enabled():
        raise RuntimeError("obs.profile: another torch.profiler window is open; "
                           "profiler windows cannot nest")
    os.makedirs(trace_dir, exist_ok=True)
    prof = torch.profiler.profile(activities=activities)
    prof.start()
    _reg._RANGE = torch.profiler.record_function
    try:
        with _reg.span("obs/profile", dir=str(trace_dir)):
            yield
    finally:
        _reg._RANGE = None
        if cuda:
            torch.cuda.synchronize()
        prof.stop()
        prof.export_chrome_trace(os.path.join(trace_dir, TRACE_FILE))
