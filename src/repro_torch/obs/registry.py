"""Trace/metrics registry: spans, counters, gauges, pluggable sinks.

The registry is the single recording surface for the whole runtime.  Three
primitives cover every instrumentation site:

* ``span(name, **attrs)`` — a context-manager wall-clock timer on
  ``time.perf_counter``.  Spans nest: each records its *path* (the stack of
  enclosing span names), so ``report()`` renders the measured tree.
* ``count(name, value=1)`` — a monotonic counter (kernel calls, restarts,
  checkpoint saves).
* ``gauge(name, value)`` — a last-value-wins sample (stream cursor, seconds
  a token).

Two sinks: the in-memory event list (always on when enabled) and an
optional JSONL file, one event per line, written as events occur so a
preempted run still leaves a readable trace.

Off-by-default-cheap: the module-level registry starts as
:class:`NullRegistry`, whose ``span`` returns a shared no-op context
manager and whose recorders are ``pass`` — a disabled call site costs one
attribute lookup and one no-op call, and allocates nothing.

Spans are host wall clock.  CUDA work is asynchronous, so on the card a
span around work that does not wait for its result measures the dispatch
of that work, not its run: ``train/step`` waits through its ``float`` of
the metrics, ``serve/decode`` synchronizes the card when the registry is
enabled, and nothing else adds a synchronization.  Attr values are host
scalars: a call site never passes a card tensor (reading one would wait
for the card), and ``_clean`` describes one without reading it.

While :func:`repro_torch.obs.profile` is active each span also opens a
``torch.profiler.record_function`` range of its name, so the device
timeline lines up with the spans; with no profile active that costs one
test of a module attribute.

Port of ``src/repro/obs/registry.py``: the same surface and the same JSONL
schema (``kind``, ``name``, ``path``, ``t``, ``dur_s``, ``attrs``,
``value``), key for key.
"""
from __future__ import annotations

import json
import sys
import time
from contextlib import contextmanager
from typing import IO, Any, Callable, Dict, Iterator, List, Optional, Tuple

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
]

_JSON_SCALARS = (bool, int, float, str, type(None))

# ``torch.profiler.record_function`` while an ``obs.profile`` window is open
# (set and cleared by :mod:`repro_torch.obs.profile`), else None.
_RANGE: Optional[Callable[[str], Any]] = None


def _clean(value: Any) -> Any:
    """Coerce an attr value to a JSON-serialisable scalar: a 0-d tensor on
    the host (or a numpy scalar) to its Python value; a tensor on the card
    is described, not read (reading it would wait for the card)."""
    if isinstance(value, _JSON_SCALARS):
        return value
    torch = sys.modules.get("torch")
    if torch is not None and isinstance(value, torch.Tensor):
        if value.device.type == "cpu" and value.dim() == 0:
            return value.item()
        return f"tensor(shape={list(value.shape)}, dtype={value.dtype}, device={value.device})"
    try:  # 0-d numpy scalars
        return float(value)
    except Exception:
        return str(value)


class _NullSpan:
    """Shared no-op span: context manager with a dead ``set``."""

    __slots__ = ()
    dur_s = 0.0

    def __enter__(self) -> "_NullSpan":
        return self

    def __exit__(self, *exc: Any) -> bool:
        return False

    def set(self, **attrs: Any) -> "_NullSpan":
        return self


_NULL_SPAN = _NullSpan()


class NullRegistry:
    """Disabled registry: every recorder is a no-op, ``span`` allocates
    nothing (always returns the same shared null span)."""

    enabled = False
    trace_path: Optional[str] = None

    @property
    def events(self) -> Tuple[Any, ...]:
        return ()

    @property
    def counters(self) -> Dict[str, float]:
        return {}

    @property
    def gauges(self) -> Dict[str, float]:
        return {}

    def span(self, name: str, /, **attrs: Any) -> _NullSpan:
        return _NULL_SPAN

    def count(self, name: str, value: float = 1) -> None:
        pass

    def gauge(self, name: str, value: float) -> None:
        pass

    def report(self) -> str:
        return "observability disabled — call obs.enable() to record"

    def snapshot(self) -> Dict[str, Any]:
        return {"enabled": False, "counters": {}, "gauges": {}, "events": 0}

    def close(self) -> None:
        pass


class Span:
    """A live span.  Created by :meth:`ObsRegistry.span`; use as a context
    manager.  ``set(**attrs)`` attaches attrs any time before exit (e.g. a
    byte count known only mid-body).  After exit, ``dur_s`` holds the
    measured duration."""

    __slots__ = ("_reg", "name", "attrs", "path", "t0", "dur_s", "_range")

    def __init__(self, reg: "ObsRegistry", name: str, attrs: Dict[str, Any]):
        self._reg = reg
        self.name = name
        self.attrs = attrs
        self.path: Tuple[str, ...] = ()
        self.t0 = 0.0
        self.dur_s = 0.0
        self._range = None

    def set(self, **attrs: Any) -> "Span":
        self.attrs.update({k: _clean(v) for k, v in attrs.items()})
        return self

    def __enter__(self) -> "Span":
        stack = self._reg._stack
        self.path = (stack[-1].path if stack else ()) + (self.name,)
        stack.append(self)
        if _RANGE is not None:
            self._range = _RANGE(self.name)
            self._range.__enter__()
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc: Any) -> bool:
        end = time.perf_counter()
        self.dur_s = end - self.t0
        if self._range is not None:
            self._range.__exit__(*exc)
            self._range = None
        stack = self._reg._stack
        if stack and stack[-1] is self:
            stack.pop()
        self._reg._record_span(self, end)
        return False


class ObsRegistry:
    """Recording registry: in-memory event list plus optional JSONL sink.

    Parameters
    ----------
    trace_jsonl : str, optional
        Path of a JSONL trace file.  Every event (span end, counter bump,
        gauge sample) is appended as one JSON object per line, flushed
        immediately — a preempted run keeps its partial trace.
    """

    enabled = True

    def __init__(self, trace_jsonl: Optional[str] = None):
        self.events: List[Dict[str, Any]] = []
        self.counters: Dict[str, float] = {}
        self.gauges: Dict[str, float] = {}
        self._stack: List[Span] = []
        self._t_origin = time.perf_counter()
        self.trace_path = trace_jsonl
        self._sink: Optional[IO[str]] = open(trace_jsonl, "w") if trace_jsonl else None

    # -- recording ---------------------------------------------------------
    def span(self, name: str, /, **attrs: Any) -> Span:
        return Span(self, name, {k: _clean(v) for k, v in attrs.items()})

    def count(self, name: str, value: float = 1) -> None:
        value = _clean(value)
        self.counters[name] = self.counters.get(name, 0) + value
        self._emit({"kind": "count", "name": name, "value": value})

    def gauge(self, name: str, value: float) -> None:
        value = _clean(value)
        self.gauges[name] = value
        self._emit({"kind": "gauge", "name": name, "value": value})

    def _record_span(self, sp: Span, end: float) -> None:
        self._emit({
            "kind": "span",
            "name": sp.name,
            "path": list(sp.path),
            "t": round(end - sp.dur_s - self._t_origin, 6),
            "dur_s": round(sp.dur_s, 9),
            "attrs": sp.attrs,
        })

    def _emit(self, event: Dict[str, Any]) -> None:
        self.events.append(event)
        if self._sink is not None:
            json.dump(event, self._sink)
            self._sink.write("\n")
            self._sink.flush()

    # -- introspection -----------------------------------------------------
    def report(self) -> str:
        from repro_torch.obs.reporting import render

        return render(self.events)

    def snapshot(self) -> Dict[str, Any]:
        return {
            "enabled": True,
            "counters": dict(self.counters),
            "gauges": dict(self.gauges),
            "events": len(self.events),
        }

    def close(self) -> None:
        if self._sink is not None:
            self._sink.close()
            self._sink = None


# -- module-level current registry ----------------------------------------
_REGISTRY: Any = NullRegistry()


def get() -> Any:
    """The current registry (NullRegistry when disabled)."""
    return _REGISTRY


def enabled() -> bool:
    return _REGISTRY.enabled


def enable(trace_jsonl: Optional[str] = None) -> ObsRegistry:
    """Install (and return) a fresh recording registry, optionally with a
    JSONL trace sink."""
    global _REGISTRY
    _REGISTRY = ObsRegistry(trace_jsonl=trace_jsonl)
    return _REGISTRY


def disable() -> None:
    """Close any sink and restore the no-op registry."""
    global _REGISTRY
    _REGISTRY.close()
    _REGISTRY = NullRegistry()


@contextmanager
def use(reg: Any) -> Iterator[Any]:
    """Temporarily swap in ``reg`` as the current registry (benchmark /
    test scoping without touching global state on exit paths)."""
    global _REGISTRY
    prev = _REGISTRY
    _REGISTRY = reg
    try:
        yield reg
    finally:
        _REGISTRY = prev


# -- convenience forwarders (the instrumentation call surface) -------------
def span(name: str, /, **attrs: Any):
    return _REGISTRY.span(name, **attrs)


def count(name: str, value: float = 1) -> None:
    _REGISTRY.count(name, value)


def gauge(name: str, value: float) -> None:
    _REGISTRY.gauge(name, value)


def report() -> str:
    return _REGISTRY.report()


def snapshot() -> Dict[str, Any]:
    return _REGISTRY.snapshot()
