#!/usr/bin/env python3
"""How much the float64 checks of ``chip_smoke.py`` can see in the 3xTF32
kernels: plant faults in ``cross_dot``, ``fused_second_order``,
``fused_first_order``, ``per_sample_moment``, ``predictive_var`` and
``batch_l2`` (and read an older ``sq_matmul``) and read every check.

    python3 tools/cross_dot_fault.py [FAULT ...] [--csrc DIR]

Needs one CUDA card and nvcc.  Builds the sources as they are and a copy
for each fault named (every fault when none is, none when only ``--csrc``
is given), with the fault planted, under
``build/fault/cross_dot/<name>/`` (the sources themselves are not touched),
one nvcc each, all at once:

* ``split_skipped`` (cross_dot): ``split_tf32`` in ``tf32x3.cuh`` leaves
  the lo parts 0, so both stages run in 1xTF32 (hi·hi alone);
* ``partial_dropped`` (cross_dot): the Gram stage's split-K partial in the
  middle of K (split splits / 2) is written as zeros;
* ``unpromoted`` (cross_dot): the Gram stage carries a split's whole sum in
  the tensor cores' accumulator instead of adding each stage into float32
  registers (``tf32x3::promote``'s reason);
* ``fso_split_skipped`` (fused_second_order): the same split fault, in t
  and kron;
* ``ffo_split_skipped``, ``psm_split_skipped`` (fused_first_order,
  per_sample_moment): the same split fault, in the per-sample product (and
  fused_first_order's Gram);
* ``ffo_unpromoted``, ``psm_unpromoted``: ``xty.cuh``'s per-sample product
  carries a sample's whole sum in the tensor cores' accumulator;
* ``ffo_partial_dropped``, ``psm_partial_dropped``: the moment partial of
  the middle z block of each group (the only one where a group has one) is
  written as zeros;
* ``pv_split_skipped`` (predictive_var), ``l2_split_skipped`` (batch_l2):
  the same split fault, in ``rowprod.cuh``'s t kernel and in batch_l2's
  gradient form (its Gram form runs on the CUDA cores and does not change);
* ``pv_unpromoted``: the t kernel carries each class's whole sum for a
  sample in the tensor cores' accumulator;
* ``pv_partial_dropped``: the variance partial of the first warp of the
  middle tile is written as zeros.

``--csrc DIR`` also builds ``DIR``'s ``sq_matmul.cu`` (with its headers;
for example an older commit's ``src/repro_torch/kernels/csrc``, unpacked
with ``git archive``) as the build ``csrc`` and reads it like a fault: the
sq_matmul that carried its whole K in the tensor cores' accumulator, before
it promoted its sums and the float64 check held it.

Each build runs its kernel at ``chip_smoke.backpack_cases``' rows (3C3D at
batch 128, and conv3's widths at 256 and 1024 rows a sample; inputs from
seed 0 as in ``chip_smoke.py``) and prints one JSON
line a (build, row) with the readings ``chip_smoke.py`` limits: ``rel``
(max |kernel − plain float32| / max |plain|, limit ``TOL``), ``rel64``
(against the formula in float64, limit ``F64_TOL``) and ``entry_median``
(entry by entry against float64, limit ``ENTRY_TOL``), and whether each
holds.  A last line counts, for each build, the rows each limit fails.
Exits non-zero if the unchanged kernels fail a limit or a planted fault
(or ``DIR``'s sq_matmul) passes every limit at every row.
"""
import argparse
import json
import shutil
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))

# name: (kernel, [(file, anchor, replacement), ...]); each anchor occurs once.
SPLIT = ("tf32x3.cuh",
         '  asm("cvt.rna.tf32.f32 %0, %1;\\n" : "=r"(lo) : "f"(x - __uint_as_float(hi)));',
         "  lo = 0u;")
XTY_UNPROMOTED = [
    ("xty.cuh", "        float tc[1][NI][4];\n        zero(tc);\n",
     "        float (&tc)[1][NI][4] = reinterpret_cast<float (&)[1][NI][4]>(acc[mi]);\n"),
    ("xty.cuh", "        promote(acc[mi], tc[0]);\n", "")]
PV_UNPROMOTED = [
    ("rowprod.cuh", """        wgmma_n48(tc, al[kq], hopper::sw128_desc(bhi + 32 * kq), kq > 0);
        wgmma_n48(tc, ah[kq], hopper::sw128_desc(blo + 32 * kq), 1);
        wgmma_n48(tc, ah[kq], hopper::sw128_desc(bhi + 32 * kq), 1);""",
     """        wgmma_n48(acc[i], al[kq], hopper::sw128_desc(bhi + 32 * kq), 1);
        wgmma_n48(acc[i], ah[kq], hopper::sw128_desc(blo + 32 * kq), 1);
        wgmma_n48(acc[i], ah[kq], hopper::sw128_desc(bhi + 32 * kq), 1);"""),
    ("rowprod.cuh", """        asm volatile("" : "+f"(tc[x])::"memory");  // no read of tc before the wait
        acc[i][x] += tc[x];""", """        asm volatile("" : "+f"(acc[i][x])::"memory");""")]
PV_DROPPED = [(
    "rowprod.cuh", "          if (lane == 0 && c0 + i < C) o[(long long)(c0 + i) * N] = s;",
    "          if (lane == 0 && c0 + i < C)\n"
    "            o[(long long)(c0 + i) * N] = blockIdx.x == gridDim.x / 2 && w == 0 ? 0.f : s;")]
MOMENT_DROPPED = [(
    "xty.cuh", "    float* o = p.moment + (long long)blockIdx.y * p.M * p.N;\n",
    "    if (blockIdx.y % p.z_blocks == p.z_blocks / 2) zero(mom);\n"
    "    float* o = p.moment + (long long)blockIdx.y * p.M * p.N;\n")]
FAULTS = {
    "split_skipped": ("cross_dot", [SPLIT]),
    "partial_dropped": ("cross_dot", [(
        "gram.cuh", "  float* dst = out + ((long long)e * splits + sp) * N1 * N2;",
        "  if (sp == splits / 2)\n    for (int x = 0; x < 64; ++x) acc[x] = 0.f;\n"
        "  float* dst = out + ((long long)e * splits + sp) * N1 * N2;")]),
    "unpromoted": ("cross_dot", [
        ("gram.cuh", "hopper::sw128_desc(bhi + 32 * kk), kk > 0);",
         "hopper::sw128_desc(bhi + 32 * kk), it > 0 || kk > 0);"),
        ("gram.cuh", "      acc[x] += tc[x];", "      acc[x] = tc[x];")]),
    "fso_split_skipped": ("fused_second_order", [SPLIT]),
    "ffo_split_skipped": ("fused_first_order", [SPLIT]),
    "ffo_unpromoted": ("fused_first_order", XTY_UNPROMOTED),
    "ffo_partial_dropped": ("fused_first_order", MOMENT_DROPPED),
    "psm_split_skipped": ("per_sample_moment", [SPLIT]),
    "psm_unpromoted": ("per_sample_moment", XTY_UNPROMOTED),
    "psm_partial_dropped": ("per_sample_moment", MOMENT_DROPPED),
    "pv_split_skipped": ("predictive_var", [SPLIT]),
    "pv_unpromoted": ("predictive_var", PV_UNPROMOTED),
    "pv_partial_dropped": ("predictive_var", PV_DROPPED),
    "l2_split_skipped": ("batch_l2", [SPLIT]),
}


def planted(csrc: Path, name: str) -> Path:
    """A copy of ``csrc`` with fault ``name`` planted."""
    out = ROOT / "build" / "fault" / "cross_dot" / name / "csrc"
    if out.exists():
        shutil.rmtree(out)
    shutil.copytree(csrc, out)
    for file, old, new in FAULTS[name][1]:
        src = (out / file).read_text()
        if src.count(old) != 1:
            sys.exit(f"{name}: the anchor does not occur once in {csrc / file}: {old}")
        (out / file).write_text(src.replace(old, new))
    return out


def main() -> int:
    import torch

    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("faults", nargs="*", help=f"among {list(FAULTS)}; all by default")
    parser.add_argument("--csrc", type=Path, help="an older csrc/ whose sq_matmul to read")
    cli = parser.parse_args()
    names = cli.faults or ([] if cli.csrc else list(FAULTS))
    unknown = [n for n in names if n not in FAULTS]
    if unknown:
        sys.exit(f"unknown faults {unknown}; the faults are {list(FAULTS)}")
    if not torch.cuda.is_available():
        print("FAILED: no CUDA card", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    from chip_smoke import ENTRY_TOL, F64_TOL, TOL, backpack_cases, f64_readings
    from repro_torch.kernels import _build, ops, ref
    from repro_torch.kernels import batch_l2 as l2_mod
    from repro_torch.kernels import cross_dot as cd_mod
    from repro_torch.kernels import fused_first_order as ffo_mod
    from repro_torch.kernels import fused_second_order as fso_mod
    from repro_torch.kernels import per_sample_moment as psm_mod
    from repro_torch.kernels import predictive_var as pv_mod
    from repro_torch.kernels import sq_matmul as sq_mod

    gen = torch.Generator(device="cuda").manual_seed(0)

    def randn(*shape):
        return torch.randn(*shape, device="cuda", generator=gen)

    def first_order(A, B, **w):  # the rows are [N, R, a]: one group
        out = ffo_mod.fused_first_order_cuda(A[None], B[None], **w)
        return {k: v[0] for k, v in out.items()}

    modules = {"cross_dot": (cd_mod, cd_mod.cross_dot_cuda),
               "fused_second_order": (fso_mod, fso_mod.fused_second_order_cuda),
               "fused_first_order": (ffo_mod, first_order),
               "per_sample_moment": (psm_mod, psm_mod.per_sample_moment_cuda),
               "predictive_var": (pv_mod, pv_mod.predictive_var_cuda),
               "batch_l2": (l2_mod, l2_mod.batch_l2_cuda),
               "sq_matmul": (sq_mod, sq_mod.sq_matmul_cuda)}
    plain = {"cross_dot": lambda A1, B1, A2, B2, **w: ref.cross_dot(
                 ops.full_a_side(A1, B1), B1, ops.full_a_side(A2, B2), B2, **w),
             "fused_second_order": ref.fused_second_order,
             "fused_first_order": lambda A, B, **w: {
                 k: v[0] for k, v in ref.fused_first_order(A[None], B[None], **w).items()},
             "per_sample_moment": ref.per_sample_moment,
             "predictive_var": ref.predictive_var,
             "batch_l2": lambda A, B, form, **w: ref.batch_l2(A, B, **w),
             "sq_matmul": ref.sq_matmul}
    kernels = {FAULTS[n][0] for n in names} | ({"sq_matmul"} if cli.csrc else set())
    rows = []  # (kernel, label, args, kw, plain float32, float64)
    for kernel, label, _, _, args, kw, *_ in backpack_cases(torch, randn, gen, l2_mod):
        if kernel in kernels:
            want, want64 = (plain[kernel](*args, **kw, dtype=d)
                            for d in (torch.float32, torch.float64))
            if not isinstance(want, dict):
                want, want64 = {"out": want}, {"out": want64}
            rows.append((kernel, label, args, kw, want, want64))

    csrc, build_dir = _build.CSRC, _build.BUILD_DIR
    builds = {"unchanged": (None, csrc, build_dir)}
    for name in names:
        kernel = FAULTS[name][0]
        fault_csrc = planted(csrc, name)
        builds[name] = (kernel, fault_csrc, fault_csrc.parent / "kernels")
    if cli.csrc:
        older = ROOT / "build" / "fault" / "cross_dot" / "csrc" / "csrc"
        if older.exists():
            shutil.rmtree(older)
        shutil.copytree(cli.csrc, older)
        builds["csrc"] = ("sq_matmul", older, older.parent / "kernels")
    _build.build_jobs((k, src, lib) for only, src, lib in builds.values()
                      for k in sorted(kernels) if only in (None, k))
    ok, summary = True, {}
    for name, (only, src, lib_dir) in builds.items():
        _build.CSRC, _build.BUILD_DIR = src, lib_dir
        fails = summary[name] = dict(rows=0, tol=0, f64=0, entry=0)
        for kernel, label, args, kw, want, want64 in rows:
            if only not in (None, kernel):
                continue
            mod, wrapper = modules[kernel]
            mod._lib.cache_clear()
            got = wrapper(*args, **kw)
            got = got if isinstance(got, dict) else {"out": got}
            torch.cuda.synchronize()
            rel = max(((got[k] - want[k]).abs().max() / want[k].abs().max()).item()
                      for k in want)
            line = dict(build=name, kernel=kernel, shape=label, rel=rel,
                        **f64_readings(torch, kernel, got, want64))
            line.update(tol_passes=rel <= TOL, f64_passes=line["rel64"] <= F64_TOL,
                        entry_passes=line["entry_median"] <= ENTRY_TOL)
            print(json.dumps(line), flush=True)
            fails["rows"] += 1
            for check in ("tol", "f64", "entry"):
                fails[check] += not line[f"{check}_passes"]
            del got
        if name == "unchanged":
            ok &= fails["tol"] == fails["f64"] == fails["entry"] == 0
        else:
            ok &= fails["tol"] + fails["f64"] + fails["entry"] > 0
    _build.CSRC, _build.BUILD_DIR = csrc, build_dir
    for mod, _ in modules.values():
        mod._lib.cache_clear()
    print(json.dumps({"ok": ok, "failing_rows": summary, "TOL": TOL, "F64_TOL": F64_TOL,
                      "ENTRY_TOL": ENTRY_TOL}))
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
