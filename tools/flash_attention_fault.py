#!/usr/bin/env python3
"""How much the bf16 attention checks of ``chip_smoke.py`` can see: plant
faults in flash_attention's "wgmma" kernel and read both checks.

    python3 tools/flash_attention_fault.py

Needs one CUDA card and nvcc.  Builds ``csrc/flash_attention.cu`` as it is
and two copies with a fault planted in the "wgmma" design, under
``build/fault/<name>/`` (the checkout's sources are not touched):

* ``skip_tile``: keys 1536–1599 are masked for every row, one 64-key tile
  skipped;
* ``row_sum``: the softmax's row sum leaves out the weights of keys
  1536–1599 while O += P·V keeps them, so the rows that see those keys come
  out a few percent too large.

Each build runs flash_attention at Hymba-1.5B's bf16 prefill shapes (q
[4,2048,25,64], k/v [4,2048,5,64], no window and a window of 1024) and at
CodeQwen1.5-7B's dh 128 ([4,2048,32,128]), on standard normal inputs from
seed 0, and prints one JSON line a (build, shape) with the two readings
``chip_smoke.py`` limits: ``rel`` (max |kernel − plain| / max |plain|,
limit ``BF16_TOL``) and ``row_rel`` (the same within each output row, limit
``ROW_TOL``), and whether each limit holds.  Exits non-zero if the
unchanged kernel fails a limit or a planted fault passes ``ROW_TOL``.
"""
import json
import shutil
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))

# (anchor in flash_attention.cu, replacement); each anchor occurs once.
FAULTS = {
    "skip_tile": (
        ("if (!inside) {", "if (true) {"),
        ("const bool seen = s < S &&", "const bool seen = (s < 1536 || s >= 1600) && s < S &&"),
    ),
    "row_sum": (
        ("        l[i] += p[e];",
         "        if (s0 + 16 * kk + 8 * (e / 4) + 2 * quad + e % 2 < 1536 ||\n"
         "            s0 + 16 * kk + 8 * (e / 4) + 2 * quad + e % 2 >= 1600)\n"
         "          l[i] += p[e];"),
    ),
}
SHAPES = {  # (N, T, H, KV, dh, window)
    "hymba global": (4, 2048, 25, 5, 64, None),
    "hymba window 1024": (4, 2048, 25, 5, 64, 1024),
    "codeqwen dh128": (4, 2048, 32, 32, 128, None),
}


def planted(build_root: Path, csrc: Path, name: str) -> Path:
    """A copy of ``csrc`` with fault ``name`` planted in flash_attention.cu."""
    src = (csrc / "flash_attention.cu").read_text()
    for old, new in FAULTS[name]:
        if src.count(old) != 1:
            sys.exit(f"{name}: the anchor {old!r} occurs {src.count(old)} times")
        src = src.replace(old, new)
    out = build_root / name / "csrc"
    out.mkdir(parents=True, exist_ok=True)
    for header in csrc.glob("*.cuh"):
        shutil.copy(header, out / header.name)
    (out / "flash_attention.cu").write_text(src)
    return out


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("FAILED: no CUDA card", file=sys.stderr)
        return 1
    from chip_smoke import BF16_TOL, ROW_TOL, row_rel_err
    from repro_torch.kernels import _build, ref
    from repro_torch.kernels import flash_attention as fa

    gen = torch.Generator(device="cuda").manual_seed(0)
    inputs = {}
    for label, (n, t, h, kv, dh, window) in SHAPES.items():
        q, k, v = (torch.randn(n, t, x, dh, device="cuda", generator=gen).bfloat16()
                   for x in (h, kv, kv))
        inputs[label] = (q, k, v, window, ref.flash_attention(q, k, v, window=window))

    csrc, build_dir = _build.CSRC, _build.BUILD_DIR
    builds = {"unchanged": (csrc, build_dir)}
    for name in FAULTS:
        fault_csrc = planted(ROOT / "build" / "fault", csrc, name)
        builds[name] = (fault_csrc, fault_csrc.parent / "kernels")
    ok = True
    for name, (src_dir, lib_dir) in builds.items():
        _build.CSRC, _build.BUILD_DIR = src_dir, lib_dir
        fa._lib.cache_clear()
        for label, (q, k, v, window, want) in inputs.items():
            assert fa.design(q, k, v, window) == "wgmma"
            got = fa.flash_attention_cuda(q, k, v, window=window)
            torch.cuda.synchronize()
            d = (got.float() - want.float()).abs()
            rel = (d.max() / want.float().abs().max()).item()
            row = row_rel_err(got, want)
            line = dict(build=name, shape=label, rel=rel, rel_passes=rel <= BF16_TOL,
                        row_rel=row, row_passes=row <= ROW_TOL)
            print(json.dumps(line), flush=True)
            if name == "unchanged":
                ok &= line["rel_passes"] and line["row_passes"]
            else:
                ok &= not line["row_passes"]
    _build.CSRC, _build.BUILD_DIR = csrc, build_dir
    fa._lib.cache_clear()
    print(json.dumps({"ok": ok, "BF16_TOL": BF16_TOL, "ROW_TOL": ROW_TOL}))
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
