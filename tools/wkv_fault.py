#!/usr/bin/env python3
"""How much the bf16 WKV checks of ``chip_smoke.py`` can see: plant faults
in the ``wkv`` kernel and read both checks.

    python3 tools/wkv_fault.py [--csrc DIR]

Needs one CUDA card and nvcc.  Builds ``csrc/wkv.cu`` as it is (or the one
in ``--csrc DIR``, for example an older checkout's) and two copies with a
fault planted, under ``build/fault/wkv/<name>/`` (the sources themselves
are not touched):

* ``skip_update``: the state update leaves out one chunk's k_endᵀv, the
  chunk that starts three quarters into the sequence;
* ``drop_state``: the r̃·S term of y is left out for the first row of every
  chunk (a later row's r̃ carries the chunk's decay so far, e^-10 by its
  last row at these inputs: below a bf16 step of y, so a fault there
  changes nothing either check could see).

Each build runs wkv at Hymba-1.5B's bf16 prefill shape (r, k
[4,2048,25,16], v [4,2048,25,64], a float32 decay per head, state0, chunk
16) and at RWKV6-3B's ([4,2048,40,64], a decay per channel, u, chunk 16),
on standard normal inputs from seed 0, and prints one JSON line a (build,
shape) with the two readings ``chip_smoke.py`` limits on y: ``rel`` (max
|kernel − plain| / max |plain|, limit ``BF16_TOL``) and ``row_rel`` (the same
within each (n, t, h) row of dv values, limit ``ROW_TOL``), and whether each
limit holds.  Exits non-zero if the unchanged kernel fails a limit or a
planted fault passes ``ROW_TOL``.
"""
import argparse
import json
import shutil
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))

# Each fault: one variant of (anchor, replacement) pairs for each design
# wkv.cu has had (the chunks in parallel; before it, one block a head
# walking the chunks); the first variant whose anchors all occur exactly
# once is planted.
FAULTS = {
    "skip_update": (
        (("        const float ug = slot[L.u + e];",
          "        const float ug = c_lo + g == nchunks * 3 / 4 ? 0.f : slot[L.u + e];"),),
        (("      S[e] = fmaf(dend[d], S[e], a);",
          "      S[e] = fmaf(dend[d], S[e], t0 == T / C * 3 / 4 * C ? 0.f : a);"),),
    ),
    "drop_state": (
        (("          for (int j = 0; j < 8; ++j) yo[j] += b[i][j];",
          "          for (int j = 0; j < 8; ++j) yo[j] += t == 0 ? 0.f : b[i][j];"),),
        (("      st(y, (row0 + (long long)t * H) * dv + c, a + b);",
          "      st(y, (row0 + (long long)t * H) * dv + c, t == 0 ? a : a + b);"),),
    ),
}
SHAPES = {  # (N, T, H, dk, dv, decay per channel, u, state0, chunk)
    "hymba ssd prefill": (4, 2048, 25, 16, 64, False, False, True, 16),
    "rwkv6-3b": (4, 2048, 40, 64, 64, True, True, False, 16),
}


def planted(build_root: Path, csrc: Path, name: str) -> Path:
    """A copy of ``csrc`` with fault ``name`` planted in wkv.cu."""
    src = (csrc / "wkv.cu").read_text()
    variants = [v for v in FAULTS[name] if all(src.count(old) == 1 for old, _ in v)]
    if not variants:
        sys.exit(f"{name}: no variant's anchors match {csrc / 'wkv.cu'}")
    for old, new in variants[0]:
        src = src.replace(old, new)
    out = build_root / name / "csrc"
    out.mkdir(parents=True, exist_ok=True)
    for header in csrc.glob("*.cuh"):
        shutil.copy(header, out / header.name)
    (out / "wkv.cu").write_text(src)
    return out


def main() -> int:
    import torch

    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--csrc", type=Path, default=None,
                        help="the directory holding wkv.cu (default: this checkout's)")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("FAILED: no CUDA card", file=sys.stderr)
        return 1
    from chip_smoke import BF16_TOL, ROW_TOL, row_rel_err
    from repro_torch.kernels import _build, ref
    from repro_torch.kernels import wkv as wkv_mod

    gen = torch.Generator(device="cuda").manual_seed(0)

    def randn(*shape):
        return torch.randn(*shape, device="cuda", generator=gen)

    inputs = {}
    for label, (n, t, h, dk, dv, per_channel, has_u, has_s0, chunk) in SHAPES.items():
        r, k = randn(n, t, h, dk).bfloat16(), randn(n, t, h, dk).bfloat16()
        v = randn(n, t, h, dv).bfloat16()
        lw = -torch.nn.functional.softplus(randn(n, t, h, dk if per_channel else 1))
        u = randn(h, dk) if has_u else None
        s0 = randn(n, h, dk, dv) if has_s0 else None
        xs = (r, k, v, lw, u, s0, chunk)
        inputs[label] = (xs, ref.wkv(*xs)[0])

    csrc, build_dir = _build.CSRC, _build.BUILD_DIR
    fault_root = ROOT / "build" / "fault" / "wkv"
    src_dir = csrc if args.csrc is None else args.csrc.resolve()
    builds = {"unchanged": (src_dir, build_dir if args.csrc is None
                            else fault_root / "unchanged" / "kernels")}
    for name in FAULTS:
        fault_csrc = planted(fault_root, src_dir, name)
        builds[name] = (fault_csrc, fault_csrc.parent / "kernels")
    ok = True
    for name, (src, lib_dir) in builds.items():
        _build.CSRC, _build.BUILD_DIR = src, lib_dir
        wkv_mod._lib.cache_clear()
        for label, (xs, want) in inputs.items():
            got = wkv_mod.wkv_cuda(*xs)[0]
            torch.cuda.synchronize()
            rel = ((got.float() - want.float()).abs().max() / want.float().abs().max()).item()
            row = row_rel_err(got, want)
            line = dict(build=name, source=str(src / "wkv.cu"), shape=label, rel=rel,
                        rel_passes=rel <= BF16_TOL, row_rel=row, row_passes=row <= ROW_TOL)
            print(json.dumps(line), flush=True)
            if name == "unchanged":
                ok &= line["rel_passes"] and line["row_passes"]
            else:
                ok &= not line["row_passes"]
    _build.CSRC, _build.BUILD_DIR = csrc, build_dir
    wkv_mod._lib.cache_clear()
    print(json.dumps({"ok": ok, "BF16_TOL": BF16_TOL, "ROW_TOL": ROW_TOL}))
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
