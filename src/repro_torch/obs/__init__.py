"""repro_torch.obs — near-zero-overhead observability for every runtime layer.

Public surface::

    from repro_torch import obs

    reg = obs.enable(trace_jsonl="trace.jsonl")   # start recording
    with obs.span("my/phase", n=64):              # perf_counter timer
        ...
    obs.count("my.counter")                       # monotonic counter
    obs.gauge("my.gauge", 0.5)                    # last-value sample
    print(obs.report())                           # measured span tree
    obs.disable()                                 # back to the no-op registry

    with obs.profile("prof"):                     # torch.profiler trace
        ...

    python -m repro_torch.obs.reporting trace.jsonl   # the table, offline

Disabled (the default) every call is a no-op on a shared
:class:`~repro_torch.obs.registry.NullRegistry`.  Spans are host wall
clock: on the card they measure what their body waits for (see
:mod:`~repro_torch.obs.registry`).  Port of ``src/repro/obs``, with the
same call surface and JSONL schema; it imports no JAX.
"""
from repro_torch.obs.profile import profile
from repro_torch.obs.registry import (
    NullRegistry,
    ObsRegistry,
    Span,
    count,
    disable,
    enable,
    enabled,
    gauge,
    get,
    report,
    snapshot,
    span,
    use,
)

__all__ = [
    "ObsRegistry",
    "NullRegistry",
    "Span",
    "enable",
    "disable",
    "get",
    "use",
    "span",
    "count",
    "gauge",
    "enabled",
    "report",
    "snapshot",
    "profile",
    "load_jsonl",
    "render",
]


def __getattr__(name):
    # The renderer loads on first use, so ``python -m
    # repro_torch.obs.reporting`` runs a module the package has not imported.
    if name in ("load_jsonl", "render"):
        from repro_torch.obs import reporting

        return getattr(reporting, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
