#!/usr/bin/env python3
"""This checkout's ``wkv`` kernel against an older one, on the wkv rows of
``chip_smoke.py``: whether they give the same bits, and their times in turns.

    python3 tools/wkv_against.py --csrc DIR

Needs one CUDA card and nvcc.  ``DIR`` holds the older ``wkv.cu`` (for
example the ``src/repro_torch/kernels/csrc`` of an older commit, unpacked
with ``git archive``); it is built under ``build/against/wkv/``, this
checkout's ``csrc/wkv.cu`` under ``build/kernels/``.  The rows are
``chip_smoke.wkv_cases`` in bfloat16 and float32 (Hymba-1.5B's SSD in
prefill of 4×2048 and in decode, T = 1; RWKV6-3B's widths), on inputs drawn
from seed 0.  For each row it prints one JSON line: whether y and the state
of the two builds are equal to the bit (``torch.equal``); each build's event
ms a launch (100 launches after 2), taken in three rounds of turns (older,
this, this, older), with the median of its six readings; and, after every
row's event times, each build's device ms a launch from a profiler window
of 10 launches.  Both builds are called through the same wrapper,
``wkv.wkv_cuda``, so the host's share of an event time is the same for
both.  Exits non-zero if a row's bits differ.
"""
import argparse
import json
import sys
from pathlib import Path
from statistics import median

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))


def main() -> int:
    import torch

    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--csrc", type=Path, required=True,
                        help="the directory holding the older wkv.cu")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("FAILED: no CUDA card", file=sys.stderr)
        return 1
    from chip_smoke import BF16_TOL, PEAK_BF16, PEAK_FLOPS, TOL, device_per_call, wkv_cases
    from repro_torch.kernels import _build
    from repro_torch.kernels import wkv as wkv_mod

    def load(src, lib_dir):
        """wkv's library built from ``src`` into ``lib_dir``, declared as
        the wrapper declares it."""
        saved = _build.CSRC, _build.BUILD_DIR
        _build.CSRC, _build.BUILD_DIR = src, lib_dir
        wkv_mod._lib.cache_clear()
        try:
            return wkv_mod._lib()
        finally:
            _build.CSRC, _build.BUILD_DIR = saved
            wkv_mod._lib.cache_clear()

    libs = {"older": load(args.csrc.resolve(), ROOT / "build" / "against" / "wkv"),
            "this": load(_build.CSRC, _build.BUILD_DIR)}
    cached_lib = wkv_mod._lib

    def call(which, xs, kw):
        wkv_mod._lib = lambda: libs[which]
        try:
            return wkv_mod.wkv_cuda(*xs, **kw)
        finally:
            wkv_mod._lib = cached_lib

    def timed(fn, iters=100):
        for _ in range(2):
            fn()
        start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(iters):
            fn()
        stop.record()
        torch.cuda.synchronize()
        return start.elapsed_time(stop) / iters

    gen = torch.Generator(device="cuda").manual_seed(0)

    def randn(*shape):
        return torch.randn(*shape, device="cuda", generator=gen)

    rows = []
    for dtype, tag, tol, peak in ((torch.bfloat16, "bf16", BF16_TOL, PEAK_BF16),
                                  (torch.float32, "fp32", TOL, PEAK_FLOPS)):
        for _, label, _, _, xs, kw, *_ in wkv_cases(torch, randn, dtype, tag, tol, peak):
            outs = {w: call(w, xs, kw) for w in libs}
            torch.cuda.synchronize()
            same = all(torch.equal(a, b) for a, b in zip(outs["older"], outs["this"]))
            turns = [(w, timed(lambda w=w: call(w, xs, kw)))
                     for _ in range(3) for w in ("older", "this", "this", "older")]
            rows.append(dict(shape=label, same_bits=same, turns_ms=turns, xs=xs, kw=kw,
                             **{f"{w}_ms": median([t for v, t in turns if v == w])
                                for w in libs}))
    ok = True
    for row in rows:
        xs, kw = row.pop("xs"), row.pop("kw")
        for w in libs:
            row[f"{w}_device_ms"] = device_per_call(torch, lambda w=w: call(w, xs, kw))[0]
        row["this_over_older"] = row["this_ms"] / row["older_ms"]
        print(json.dumps(row), flush=True)
        ok &= row["same_bits"]
    print(json.dumps({"ok": ok, "older": str(args.csrc / "wkv.cu")}))
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
