#!/usr/bin/env python3
"""How much the bf16 attention checks of ``chip_smoke.py`` can see: plant
faults in flash_attention's "wgmma" and "split" kernels and read both checks.

    python3 tools/flash_attention_fault.py

Needs one CUDA card and nvcc.  Builds ``csrc/flash_attention.cu`` as it is
and a copy for each fault, planted in one design, under
``build/fault/<name>/`` (the checkout's sources are not touched), one nvcc
each, all at once:

* ``skip_tile`` ("wgmma"): keys 1536–1599 are masked for every row, one
  64-key tile skipped;
* ``row_sum`` ("wgmma"): the softmax's row sum leaves out the weights of
  keys 1536–1599 while O += P·V keeps them, so the rows that see those keys
  come out a few percent too large;
* ``pad_unzeroed`` ("wgmma", the wide heads): Q's 16-byte chunks past dh
  are read from memory (the next head's values) instead of written as zeros
  (a row's last chunk stays zero where it would read past q's end).  TMA
  fills K's columns past dh with zeros, so the padding meets zeros in every
  logit: the fault is expected to give the unchanged kernel's bits at dh
  120, and MLA's 192 has no padding;
* ``dv_stride`` ("wgmma", the wide heads): the output rows are strided by
  the instance's DK instead of dv (stores past the output's end dropped);
* ``split_dropped`` ("split"): the last block's merge leaves out the
  partial of the middle split (splits / 2), from both its sums;
* ``split_max_unapplied`` ("split"): the merge adds the middle split's
  partial without rescaling it by e^(m_split − M), as if its max were the
  row's.

Each "wgmma" build runs flash_attention at Hymba-1.5B's bf16 prefill shapes
(q [4,2048,25,64], k/v [4,2048,5,64], no window and a window of 1024), at
CodeQwen1.5-7B's dh 128 ([4,2048,32,128]) and at ``chip_smoke.py``'s wide
prefill rows (h2o-danube3-4b's dh 120, 32 heads over 8, window 8192;
deepseek-v2-lite's MLA, dh 192, dv 128, 16 heads; gemma3-12b's dh 240, 16
heads over 8, window 1024), ``pad_unzeroed`` and ``dv_stride`` at the dh
120 and MLA rows alone; each "split" build at Hymba's
decode rows of ``chip_smoke.py`` (bf16 q [4,1,25,64] at position 1500
against float32 caches: a ring of 1024 that wrapped, window 1024, and a
global cache of 2048 with the slots past 1500 empty); the unchanged build
at all of them.  Inputs are standard normal from seed 0.  It prints one JSON
line a (build, shape) with the two readings
``chip_smoke.py`` limits: ``rel`` (max |kernel − plain| / max |plain|,
limit ``BF16_TOL``) and ``row_rel`` (the same within each output row, limit
``ROW_TOL``), whether each limit holds, and whether the bits equal the
unchanged build's.  Exits non-zero if the unchanged kernel fails a limit, a
planted fault passes ``ROW_TOL``, or ``pad_unzeroed`` changes a bit.
"""
import json
import shutil
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))

# name: (design, ((anchor in flash_attention.cu, replacement), ...)); each
# anchor occurs once.
WIDE = ("h2o-danube3 dh120", "deepseek-v2-lite mla")  # the shapes of the padding faults
NEUTRAL = ("pad_unzeroed",)  # faults the design makes harmless: the bits must not change
FAULTS = {
    "skip_tile": ("wgmma", (
        ("if (!inside) {", "if (true) {"),
        ("const bool seen = s < S &&", "const bool seen = (s < 1536 || s >= 1600) && s < S &&"),
    )),
    "row_sum": ("wgmma", (
        ("        l[i] += p[e];",
         "        if (s0 + 16 * kk + 8 * (e / 4) + 2 * quad + e % 2 < 1536 ||\n"
         "            s0 + 16 * kk + 8 * (e / 4) + 2 * quad + e % 2 >= 1600)\n"
         "          l[i] += p[e];"),
    )),
    "pad_unzeroed": ("wgmma", (
        ("    if (row < rows && 8 * c < dh) {",
         "    if (row < rows && (8 * c < dh || row + 1 < rows)) {"),
    )),
    "dv_stride": ("wgmma", (
        ("(((long long)n * T + t) * H + (long long)kvh * g + j) * dv;",
         "(((long long)n * T + t) * H + (long long)kvh * g + j) * DK;"),
        ("        if (col < dv)\n",
         "        if (col < dv && dst + col < out + (long long)(gridDim.y / KV) * T * H * dv)\n"),
    )),
    "split_dropped": ("split", (
        ("      const float w = mlx.x == -INFINITY ? 0.f : expf(mlx.x - mn);",
         "      const float w = mlx.x == -INFINITY || x == splits / 2 ? 0.f : expf(mlx.x - mn);"),
    )),
    "split_max_unapplied": ("split", (
        ("      const float w = mlx.x == -INFINITY ? 0.f : expf(mlx.x - mn);",
         "      const float w = mlx.x == -INFINITY ? 0.f : x == splits / 2 ? 1.f : expf(mlx.x - mn);"),
    )),
}
SHAPES = {  # design: {label: (N, T, H, KV, dh, dv, window, cache)}
    "wgmma": {"hymba global": (4, 2048, 25, 5, 64, 64, None, None),
              "hymba window 1024": (4, 2048, 25, 5, 64, 64, 1024, None),
              "codeqwen dh128": (4, 2048, 32, 32, 128, 128, None, None),
              "h2o-danube3 dh120": (4, 2048, 32, 8, 120, 120, 8192, None),
              "deepseek-v2-lite mla": (4, 2048, 16, 16, 192, 128, None, None),
              "gemma3 dh240": (4, 2048, 16, 8, 240, 240, 1024, None)},
    # decode at position 1500, bf16 queries against float32 caches
    "split": {"hymba decode ring 1024": (4, 1, 25, 5, 64, 64, 1024, ("ring", 1024)),
              "hymba decode global 2048": (4, 1, 25, 5, 64, 64, None, ("global", 2048))},
}
POSITION = 1500


def planted(build_root: Path, csrc: Path, name: str) -> Path:
    """A copy of ``csrc`` with fault ``name`` planted in flash_attention.cu."""
    src = (csrc / "flash_attention.cu").read_text()
    for old, new in FAULTS[name][1]:
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
    i32 = dict(device="cuda", dtype=torch.int32)
    inputs = {}  # label: (design, q, k, v, kwargs, plain output)
    for which, shapes in SHAPES.items():
        for label, (n, t, h, kv, dh, dv, window, cache) in shapes.items():
            if cache is None:
                q, k, v = (torch.randn(n, t, x, d, device="cuda", generator=gen).bfloat16()
                           for x, d in ((h, dh), (kv, dh), (kv, dv)))
                kw = dict(window=window)
            else:  # the float32 cache of chip_smoke.py's decode rows
                kind, s = cache
                q = torch.randn(n, 1, h, dh, device="cuda", generator=gen).bfloat16()
                k, v = (torch.randn(n, s, kv, dh, device="cuda", generator=gen) for _ in "kv")
                kp = torch.arange(s, **i32)
                if kind == "ring":
                    kp = torch.where(kp <= POSITION % s, kp + s, kp)
                else:
                    kp[POSITION + 1:] = -1
                kw = dict(window=window, q_positions=torch.tensor([POSITION], **i32),
                          k_positions=kp)
            assert fa.design(q, k, v, window, kw.get("q_positions"),
                             kw.get("k_positions")) == which
            inputs[label] = (which, q, k, v, kw, ref.flash_attention(q, k, v, **kw))

    csrc, build_dir = _build.CSRC, _build.BUILD_DIR
    builds = {"unchanged": (None, csrc, build_dir)}
    for name, (which, _) in FAULTS.items():
        fault_csrc = planted(ROOT / "build" / "fault", csrc, name)
        builds[name] = (which, fault_csrc, fault_csrc.parent / "kernels")
    _build.build_jobs(("flash_attention", src, lib) for _, src, lib in builds.values())
    ok = True
    unchanged = {}  # label: the unchanged build's output
    for name, (only, src_dir, lib_dir) in builds.items():
        _build.CSRC, _build.BUILD_DIR = src_dir, lib_dir
        fa._lib.cache_clear()
        for label, (which, q, k, v, kw, want) in inputs.items():
            if only not in (None, which) or (
                    name in ("pad_unzeroed", "dv_stride") and label not in WIDE):
                continue
            got = fa.flash_attention_cuda(q, k, v, **kw)
            torch.cuda.synchronize()
            d = (got.float() - want.float()).abs()
            rel = (d.max() / want.float().abs().max()).item()
            row = row_rel_err(got, want)
            if name == "unchanged":
                unchanged[label] = got
            line = dict(build=name, design=which, shape=label, rel=rel,
                        rel_passes=rel <= BF16_TOL, row_rel=row, row_passes=row <= ROW_TOL,
                        same_bits=torch.equal(got, unchanged[label]))
            print(json.dumps(line), flush=True)
            if name == "unchanged":
                ok &= line["rel_passes"] and line["row_passes"]
            elif name in NEUTRAL:
                ok &= line["same_bits"]
            else:
                ok &= not line["row_passes"]
    _build.CSRC, _build.BUILD_DIR = csrc, build_dir
    fa._lib.cache_clear()
    print(json.dumps({"ok": ok, "BF16_TOL": BF16_TOL, "ROW_TOL": ROW_TOL}))
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
