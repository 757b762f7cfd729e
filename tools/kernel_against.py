#!/usr/bin/env python3
"""This checkout's build of one kernel against an older source's, on that
kernel's rows of ``chip_smoke.py``: whether they give the same bits, and
their times in turns.

    python3 tools/kernel_against.py --kernel NAME --csrc DIR [--bits] [--iters K]
                                    [--rows PREFIX ...]

Needs one CUDA card and nvcc.  ``NAME`` is ``wkv``, ``flash_attention``,
``sq_matmul``, ``cross_dot``, ``fused_second_order``, ``fused_first_order``,
``per_sample_moment``, ``predictive_var``, ``batch_l2`` or ``ggn_diag``.  ``DIR`` holds the older
``NAME.cu`` and its headers (for example the ``src/repro_torch/kernels/csrc``
of an older commit, unpacked with ``git archive``); it is built under
``build/against/NAME/``, this checkout's source under ``build/kernels/``.  The
rows are ``chip_smoke.wkv_cases`` in bfloat16 and float32 for wkv
(Hymba-1.5B's SSD in prefill of 4×2048 and in decode, T = 1; RWKV6-3B's
widths), ``chip_smoke.lm_kernel_cases``' flash_attention rows (Hymba-1.5B's
prefill and decode, CodeQwen1.5-7B's dh 128, the wide heads) and
``chip_smoke.backpack_cases``' rows of the kernel for the others (3C3D at
batch 128), on inputs drawn from seed 0 as in ``chip_smoke.py``; ``--rows``
keeps the rows whose label starts with one of the prefixes (for example
``decode``, ``"prefill bf16"``, ``"wide prefill"``).
For each row it prints one JSON line: whether every output of the two
builds is equal to the bit (``torch.equal``); each build's event ms a launch
(``--iters`` launches after 2, default 100), taken in three rounds of turns
(older, this, this, older), with the median of its six readings; each build's device memory
a call needs beyond its inputs and outputs' (``peak_bytes``: outputs and
scratch, from ``max_memory_allocated``); and, after every row's event
times, each build's device ms a launch from a profiler window of 10
launches, in all and by kernel name.  An older source whose scratch query
lacks the row count R (fused_first_order and per_sample_moment before
their 3xTF32 designs; ggn_diag before it, the class count C too) is called
without them.  An older flash_attention whose "wgmma" launch takes no dv
(dh = dv then) is called without it.  Both builds are called through the same wrapper
(``NAME_cuda``), so the host's share of an event time is the same for both.
With ``--bits`` (a source whose arithmetic was not meant to change) it exits
non-zero if a row's bits differ.
"""
import argparse
import importlib
import json
import re
import sys
from pathlib import Path
from statistics import median

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))

KERNELS = ("wkv", "flash_attention", "sq_matmul", "cross_dot", "fused_second_order",
           "fused_first_order", "per_sample_moment", "predictive_var", "batch_l2", "ggn_diag")
# The C entries that gained arguments: (function, the parameter whose absence
# marks the older source, where the new arguments stand in the call).
JOINED = {"fused_first_order": ("fused_first_order_scratch_floats", "int R", (2,)),
          "per_sample_moment": ("per_sample_moment_scratch_floats", "int R", (1,)),
          "ggn_diag": ("ggn_diag_scratch_floats", "int R", (0, 2)),
          "flash_attention": ("flash_attention_tc_launch", "int dv", (10,))}


def as_called(lib, src: Path, name: str):
    """``lib`` as this checkout's wrapper calls it: where the older source's
    entry lacks arguments this checkout's passes, they are dropped from the
    call."""
    if name not in JOINED:
        return lib
    fn, marker, at = JOINED[name]
    params = re.search(rf"{fn}\(([^)]*)\)", (src / f"{name}.cu").read_text())
    if marker in params.group(1):
        return lib
    entry = getattr(lib, fn)
    entry.argtypes = [t for i, t in enumerate(entry.argtypes) if i not in at]

    class Older:
        def __getattr__(self, attr):
            if attr == fn:
                return lambda *a: entry(*(x for i, x in enumerate(a) if i not in at))
            return getattr(lib, attr)

    return Older()


def outputs(out):
    """A wrapper's result as a list of tensors."""
    if isinstance(out, dict):
        return [out[k] for k in sorted(out)]
    return list(out) if isinstance(out, tuple) else [out]


def main() -> int:
    import torch

    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--kernel", choices=KERNELS, required=True)
    parser.add_argument("--csrc", type=Path, required=True,
                        help="the directory holding the older source")
    parser.add_argument("--bits", action="store_true",
                        help="exit non-zero unless every row's bits are equal")
    parser.add_argument("--iters", type=int, default=100)
    parser.add_argument("--rows", nargs="*", default=[""],
                        help="keep the rows whose label starts with one of these")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("FAILED: no CUDA card", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    from chip_smoke import (BF16_TOL, PEAK_BF16, PEAK_FLOPS, TOL, backpack_cases,
                            device_per_call, lm_kernel_cases, wkv_cases)
    from repro_torch.kernels import _build
    from repro_torch.kernels import batch_l2 as l2_mod

    name = args.kernel
    mod = importlib.import_module(f"repro_torch.kernels.{name}")
    wrapper = getattr(mod, f"{name}_cuda")
    if name == "fused_first_order":  # chip_smoke's rows are [N, R, a]: one group
        cuda = wrapper

        def wrapper(A, B, **kw):
            return {k: v[0] for k, v in cuda(A[None], B[None], **kw).items()}

    def load(src, lib_dir):
        """The kernel's library built from ``src`` into ``lib_dir``, declared
        as the wrapper declares it."""
        saved = _build.CSRC, _build.BUILD_DIR
        _build.CSRC, _build.BUILD_DIR = src, lib_dir
        mod._lib.cache_clear()
        try:
            return as_called(mod._lib(), src, name)
        finally:
            _build.CSRC, _build.BUILD_DIR = saved
            mod._lib.cache_clear()

    libs = {"older": load(args.csrc.resolve(), ROOT / "build" / "against" / name),
            "this": load(_build.CSRC, _build.BUILD_DIR)}
    cached_lib = mod._lib

    def call(which, xs, kw):
        mod._lib = lambda: libs[which]
        try:
            return wrapper(*xs, **kw)
        finally:
            mod._lib = cached_lib

    def timed(fn):
        for _ in range(2):
            fn()
        start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(args.iters):
            fn()
        stop.record()
        torch.cuda.synchronize()
        return start.elapsed_time(stop) / args.iters

    gen = torch.Generator(device="cuda").manual_seed(0)

    def randn(*shape):
        return torch.randn(*shape, device="cuda", generator=gen)

    if name == "wkv":
        cases = [c for dtype, tag, tol, peak in ((torch.bfloat16, "bf16", BF16_TOL, PEAK_BF16),
                                                 (torch.float32, "fp32", TOL, PEAK_FLOPS))
                 for c in wkv_cases(torch, randn, dtype, tag, tol, peak)]
    elif name == "flash_attention":
        cases = [c for c in lm_kernel_cases(torch, randn, gen) if c[0] == name]
    else:
        cases = [c for c in backpack_cases(torch, randn, gen, l2_mod) if c[0] == name]
    cases = [c for c in cases if c[1].startswith(tuple(args.rows))]
    rows = []
    for _, label, _, _, xs, kw, *_ in cases:
        outs = {w: outputs(call(w, xs, kw)) for w in libs}
        torch.cuda.synchronize()
        same = all(torch.equal(a, b) for a, b in zip(outs["older"], outs["this"], strict=True))
        diff = max(((a - b).abs().max() / b.abs().max()).item()
                   for a, b in zip(outs["older"], outs["this"]))
        turns = [(w, timed(lambda w=w: call(w, xs, kw)))
                 for _ in range(3) for w in ("older", "this", "this", "older")]
        peak = {}
        for w in libs:
            del outs[w]
            torch.cuda.synchronize()
            base = torch.cuda.memory_allocated()
            torch.cuda.reset_peak_memory_stats()
            call(w, xs, kw)
            torch.cuda.synchronize()
            peak[f"{w}_peak_bytes"] = torch.cuda.max_memory_allocated() - base
        rows.append(dict(shape=label, same_bits=same, rel_diff=diff, turns_ms=turns, xs=xs,
                         kw=kw, **peak, **{f"{w}_ms": median([t for v, t in turns if v == w])
                                           for w in libs}))
    ok = True
    for row in rows:
        xs, kw = row.pop("xs"), row.pop("kw")
        for w in libs:
            row[f"{w}_device_ms"], by_name = device_per_call(torch, lambda w=w: call(w, xs, kw))
            row[f"{w}_device_by_kernel"] = {k: round(v, 5) for k, v in by_name.items()}
        row["this_over_older"] = row["this_ms"] / row["older_ms"]
        print(json.dumps(row), flush=True)
        ok &= row["same_bits"] or not args.bits
    print(json.dumps({"ok": ok, "kernel": name, "older": str(args.csrc / f"{name}.cu"),
                      "bits_required": args.bits}))
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
