"""Render recorded events into the human per-phase summary table.

``render`` is the one rendering path: the registry's ``report()`` feeds it
the in-memory event list, and the command line below feeds it a JSONL
trace loaded with ``load_jsonl``.  Spans aggregate by their *path* (the
nesting stack of span names), so the output mirrors the planned sweep tree
— but with measured wall time, call counts, and summed numeric attrs
(bytes, rows) instead of the planned schedule.

    python -m repro_torch.obs.reporting trace.jsonl

prints the table of a trace written by ``obs.enable(trace_jsonl=...)``
(e.g. ``repro_torch.launch.train --trace-jsonl``); a truncated final line
(a run killed mid-write) is tolerated.

Port of ``src/repro/obs/reporting.py`` (and of ``tools/obs_report.py``, its
command line): the same text for the same events.
"""
from __future__ import annotations

import argparse
import json
import sys
from typing import Any, Dict, List, Tuple

__all__ = ["load_jsonl", "render"]

# attr keys with additive semantics — the only ones worth summing across
# a span's calls (summing identifiers like `step` or `t` reads as garbage)
_SUM_KEYS = frozenset({"bytes", "rows", "tokens", "arrays", "n"})


def load_jsonl(path: str) -> List[Dict[str, Any]]:
    """Load a JSONL trace file back into an event list.

    Tolerates a truncated final line (preempted run mid-write)."""
    events: List[Dict[str, Any]] = []
    with open(path) as fh:
        for line in fh:
            line = line.strip()
            if not line:
                continue
            try:
                events.append(json.loads(line))
            except json.JSONDecodeError:
                break  # torn tail write — keep everything before it
    return events


def _fmt_s(seconds: float) -> str:
    if seconds >= 1.0:
        return f"{seconds:.3f} s"
    if seconds >= 1e-3:
        return f"{seconds * 1e3:.2f} ms"
    return f"{seconds * 1e6:.1f} us"


def render(events: List[Dict[str, Any]]) -> str:
    """Aggregate events into the span tree + counters + gauges tables."""
    # path-tuple -> [calls, total_s, {attr: sum}]
    agg: Dict[Tuple[str, ...], List[Any]] = {}
    order: List[Tuple[str, ...]] = []  # first-seen order, parents first
    counters: Dict[str, float] = {}
    gauges: Dict[str, float] = {}
    for ev in events:
        kind = ev.get("kind")
        if kind == "span":
            path = tuple(ev.get("path") or [ev.get("name", "?")])
            # register ancestors so a child seen before its parent closed
            # still renders under it
            for i in range(1, len(path) + 1):
                prefix = path[:i]
                if prefix not in agg:
                    agg[prefix] = [0, 0.0, {}]
                    order.append(prefix)
            row = agg[path]
            row[0] += 1
            row[1] += float(ev.get("dur_s", 0.0))
            for k, v in (ev.get("attrs") or {}).items():
                if (k in _SUM_KEYS and isinstance(v, (int, float))
                        and not isinstance(v, bool)):
                    row[2][k] = row[2].get(k, 0) + v
        elif kind == "count":
            counters[ev["name"]] = counters.get(ev["name"], 0) + ev.get("value", 1)
        elif kind == "gauge":
            gauges[ev["name"]] = ev.get("value")

    lines: List[str] = []
    if agg:
        # render depth-first so children sit under their parents
        first_seen = {p: i for i, p in enumerate(order)}
        order.sort(
            key=lambda p: tuple(first_seen[p[: i + 1]] for i in range(len(p)))
        )
        name_w = max(
            [2 + 2 * (len(p) - 1) + len(p[-1]) for p in order] + [len("span")]
        )
        lines.append(
            f"{'span':<{name_w}}  {'calls':>6}  {'total':>10}  {'mean':>10}"
        )
        for path in order:
            calls, total, attrs = agg[path]
            indent = "  " * (len(path) - 1)
            label = f"{indent}{path[-1]}"
            if calls == 0:  # ancestor never closed (still open / crashed)
                lines.append(f"{label:<{name_w}}  {'-':>6}  {'-':>10}  {'-':>10}")
                continue
            mean = total / calls
            row = (
                f"{label:<{name_w}}  {calls:>6d}  {_fmt_s(total):>10}  "
                f"{_fmt_s(mean):>10}"
            )
            extras = "  ".join(
                f"{k}={attrs[k]:g}" for k in sorted(attrs)
            )
            lines.append(row + ("  " + extras if extras else ""))
    if counters:
        lines.append("")
        lines.append("counters")
        for name in sorted(counters):
            lines.append(f"  {name} = {counters[name]:g}")
    if gauges:
        lines.append("")
        lines.append("gauges")
        for name in sorted(gauges):
            lines.append(f"  {name} = {gauges[name]:g}")
    if not lines:
        return "no events recorded"
    return "\n".join(lines)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        description="render a JSONL obs trace as a per-phase summary table")
    ap.add_argument("trace", help="JSONL trace file written by "
                                  "obs.enable(trace_jsonl=...)")
    args = ap.parse_args(argv)
    events = load_jsonl(args.trace)
    if not events:
        print(f"{args.trace}: no events", file=sys.stderr)
        return 1
    print(render(events))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
