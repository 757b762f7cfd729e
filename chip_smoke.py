#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA card (written for the H100).

    python3 chip_smoke.py

Builds the three Hopper kernels from ``src/repro_torch/kernels/csrc`` (one
nvcc per source, all at once), holds each against its plain PyTorch version
at the shapes BackPACK's main path gives it on 3C3D at batch 128, drives the
main path — ``repro_torch.core.run`` with the ten first-order, exact-GGN and
MC extensions on 3C3D (CIFAR-10 shapes, full width, random weights from a
seed) — checks that every kernel launched there and that the card agrees
with the same ``run`` on the CPU, and runs KFRA and DiagHessian on the
784-128-64-10 MLP.  Every phase prints a line; any failure exits non-zero.
The second-to-last lines are the kernel table (JSON) and the card's name and
power limit; the last line is ``{"ok": true, "device": {...}}``.  The full
record goes to ``build/chip_smoke.json``.

Float32 throughout, TF32 off for matmuls and cuDNN (the plain versions and
the CPU comparison are exact float32).  Bounds use the H100 SXM's published
peaks: 67 TFLOP/s float32 without tensor cores, 3.35 TB/s.
"""
import json
import math
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
PEAK_FLOPS = 67e12
PEAK_BYTES = 3.35e12
N = 128          # DeepOBS batch for 3C3D on CIFAR-10
TOL = 1e-4       # max |kernel − plain| / max |plain|: float32, other sum order
FIRST = ("batch_grad", "batch_l2", "second_moment", "variance", "batch_dot")
EXACT = ("diag_ggn", "kflr", "ggn_trace")
MC = ("diag_ggn_mc", "kfac")


def say(tag, **kw):
    print(f"{tag}: " + json.dumps(kw, sort_keys=True), flush=True)


def fail(msg):
    print(f"FAILED: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def main():
    import torch

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: chip_smoke.py needs a CUDA card")
    if not (ROOT / "src" / "repro_torch").is_dir():
        fail(f"{ROOT / 'src' / 'repro_torch'} not found: run from a checkout of the repo")
    sys.path.insert(0, str(ROOT / "src"))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    from repro_torch.configs import papernets
    from repro_torch.core import CrossEntropyLoss, ExtensionConfig, by_name, run
    from repro_torch.core.tree import tree_leaves, tree_map
    from repro_torch.kernels import _build, ops, ref
    from repro_torch.kernels import fused_first_order as ffo_mod
    from repro_torch.kernels import fused_second_order as fso_mod
    from repro_torch.kernels import sq_matmul as sq_mod

    record = {}
    # -- 1. the device --------------------------------------------------------
    kind = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60).stdout.strip().splitlines()[0]
    record["device"] = dict(kind=kind, nvidia_smi=smi, count=torch.cuda.device_count(),
                            torch=torch.__version__, cuda=torch.version.cuda)
    say("device", **record["device"])

    # -- 2. build the kernels -------------------------------------------------
    t0 = time.perf_counter()
    libs = _build.build()
    modules = {"fused_first_order": ffo_mod, "fused_second_order": fso_mod,
               "sq_matmul": sq_mod}
    record["build_s"] = time.perf_counter() - t0
    say("kernels", build_s=record["build_s"],
        kernels=[dict(name=k, source=modules[k].SOURCE, replaces=modules[k].REPLACES,
                      library=libs[k].name) for k in ops.KERNELS])

    # -- 3. each kernel against its plain version at the main path's shapes --
    gen = torch.Generator(device="cuda").manual_seed(0)

    def randn(*shape):
        return torch.randn(*shape, device="cuda", generator=gen)

    def timed(fn, iters=10):
        for _ in range(2):
            fn()
        start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(iters):
            fn()
        stop.record()
        torch.cuda.synchronize()
        return start.elapsed_time(stop) / iters

    def bound(flops, nbytes):
        t_ops, t_bytes = flops / PEAK_FLOPS * 1e3, nbytes / PEAK_BYTES * 1e3
        return max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes else "bytes")

    conv = {"conv1": (1024, 75, 64), "conv2": (256, 576, 96), "conv3": (64, 864, 128)}
    dense = {"dense1": (2048, 512), "dense2": (512, 256), "dense3": (256, 10)}
    cases = []  # (kernel, shape label, launches per run call, inputs, kwargs, flops, bytes)
    # Operations are the fewest the outputs need: G_n = A_nᵀB_n (2·N·r·a·b),
    # one square per G entry and one add each into l2 and moment (3·N·a·b),
    # and dot's N(N−1)/2 off-diagonal pairs (2·a·b each; dot is symmetric
    # and its diagonal is l2).
    for name, (r, a, b) in conv.items():
        A, B = randn(N, r, a), randn(N, r, b)
        flops = 2 * N * r * a * b + 3 * N * a * b + N * (N - 1) * a * b
        nbytes = 4 * (N * r * (a + b) + N + a * b + N * N)
        cases.append(("fused_first_order", f"{name} A[{N},{r},{a}] B[{N},{r},{b}]", 1,
                      (A, B), dict(want_l2=True, want_moment=True, want_dot=True),
                      flops, nbytes))
        for c, wants, label in ((10, dict(want_diag=True, want_kron=True, want_trace=True),
                                 "exact"),
                                (1, dict(want_diag=True, want_kron=True), "mc")):
            # t = A_nᵀS_cn (2·C·N·r·a·b); diag alone is one FMA per t entry,
            # diag + trace a square and two adds; kron = SᵀS is symmetric,
            # so b(b+1)/2 FMAs per row of S (C·N·r rows).
            S = randn(c, N, r, b)
            flops = (2 * c * N * r * a * b + (2 + wants.get("want_trace", 0)) * c * N * a * b
                     + c * N * r * b * (b + 1))
            nbytes = 4 * (N * r * a + c * N * r * b + a * b + b * b
                          + (N if wants.get("want_trace") else 0))
            cases.append(("fused_second_order",
                          f"{name} {label} A[{N},{r},{a}] S[{c},{N},{r},{b}]", 1,
                          (A, S), wants, flops, nbytes))
    for name, (a, b) in dense.items():
        for rows, per_call, label in ((N, 2, "moment+mc"), (10 * N, 1, "exact diag")):
            A, B = randn(rows, a), randn(rows, b)
            cases.append(("sq_matmul", f"{name} {label} A[{rows},{a}] B[{rows},{b}]",
                          per_call, (A, B), {}, 2 * rows * a * b + rows * (a + b),
                          4 * (rows * (a + b) + a * b)))

    wrapper = {"fused_first_order": ops.fused_first_order,
               "fused_second_order": ops.fused_second_order, "sq_matmul": ops.sq_matmul}
    plain = {"fused_first_order": lambda A, B, **w: ref.fused_first_order(A[None], B[None], **w),
             "fused_second_order": ref.fused_second_order, "sq_matmul": ref.sq_matmul}
    library = {"sq_matmul": lambda A, B: torch.matmul(A.square().T, B.square())}
    per_kernel = {k: dict(ms=0.0, plain_ms=0.0, bound_ms=0.0, library_ms=0.0, ops_ms=0.0,
                          bytes_ms=0.0, max_abs_err=0.0, max_rel_err=0.0, shapes=[])
                  for k in ops.KERNELS}
    record["checks"] = []
    for kernel, label, per_call, args, kw, flops, nbytes in cases:
        got = wrapper[kernel](*args, **kw)
        want = plain[kernel](*args, **kw)
        torch.cuda.synchronize()
        if not isinstance(got, dict):
            got, want = {"out": got}, {"out": want}
        abs_err = rel_err = 0.0
        for key in want:
            g = got[key].reshape(want[key].shape)
            if not torch.isfinite(g).all():
                fail(f"{kernel} {label}: non-finite {key}")
            e = (g - want[key]).abs().max().item()
            abs_err = max(abs_err, e)
            rel_err = max(rel_err, e / want[key].abs().max().item())
        ms = timed(lambda: wrapper[kernel](*args, **kw))
        plain_ms = timed(lambda: plain[kernel](*args, **kw))
        lib_ms = timed(lambda: library[kernel](*args)) if kernel in library else None
        b_ms, b_by = bound(flops, nbytes)
        row = dict(kernel=kernel, shape=label, launches_per_call=per_call, rel_err=rel_err,
                   max_abs_err=abs_err, ms=ms, plain_ms=plain_ms, library_ms=lib_ms,
                   bound_ms=b_ms, bound_by=b_by, tflops=flops / ms / 1e9)
        say("check", **row)
        record["checks"].append(row)
        if not rel_err <= TOL:
            fail(f"{kernel} {label}: relative error {rel_err:.3e} above {TOL}")
        agg = per_kernel[kernel]
        agg["shapes"].append(label)
        agg["max_abs_err"] = max(agg["max_abs_err"], abs_err)
        agg["max_rel_err"] = max(agg["max_rel_err"], rel_err)
        agg["ms"] += per_call * ms
        agg["plain_ms"] += per_call * plain_ms
        agg["bound_ms"] += per_call * b_ms
        agg["ops_ms"] += per_call * flops / PEAK_FLOPS * 1e3
        agg["bytes_ms"] += per_call * nbytes / PEAK_BYTES * 1e3
        if lib_ms is not None:
            agg["library_ms"] += per_call * lib_ms
    del cases  # free the check inputs before the main path

    # -- 4. the main path: 3C3D at full width, batch 128, three run calls ----
    model = papernets.c3d3(device="cuda", generator=torch.Generator().manual_seed(0))
    params = model.params()
    x = torch.randn(N, 32, 32, 3, device="cuda", generator=gen)
    y = torch.randint(0, 10, (N,), device="cuda", generator=gen)
    loss = CrossEntropyLoss()
    exts = tuple(by_name(n) for n in FIRST + EXACT + MC)
    cfg = ExtensionConfig(use_kernels=True, mc_seed=0)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    step_s = []
    for _ in range(3):
        t0 = time.perf_counter()
        res = run(model, params, x, y, loss, extensions=exts, cfg=cfg)
        torch.cuda.synchronize()
        step_s.append(time.perf_counter() - t0)
    launches = ops.launch_counts()
    peak = torch.cuda.max_memory_allocated()
    record["main_path"] = dict(model="c3d3", batch=N, extensions=len(exts), step_s=step_s,
                               max_memory_allocated=peak, launches=launches)
    say("main_path", **record["main_path"])
    missing = [k for k, v in launches.items() if v == 0]
    if missing:
        fail(f"the main path launched no {missing}")
    for name in exts:
        for leaf in tree_leaves(res.ext[name.name]):
            if not torch.isfinite(leaf).all():
                fail(f"non-finite {name.name}")

    # The step through the kernels against the same step through the plain
    # PyTorch route (use_kernels=False), interleaved so both see the same host.
    cfg_plain = ExtensionConfig(use_kernels=False, mc_seed=0)
    steps = {"kernels": [], "plain": []}
    before = ops.launch_counts()
    for _ in range(5):
        for route, c in (("kernels", cfg), ("plain", cfg_plain)):
            t0 = time.perf_counter()
            run(model, params, x, y, loss, extensions=exts, cfg=c)
            torch.cuda.synchronize()
            steps[route].append(time.perf_counter() - t0)
    if ops.launch_counts() != {k: v + 5 * launches[k] // 3 for k, v in before.items()}:
        fail("use_kernels=False launched a kernel, or use_kernels=True launched other counts")
    record["step_routes"] = dict(step_s=steps, median_ms={
        k: sorted(v)[len(v) // 2] * 1e3 for k, v in steps.items()})
    say("step_routes", **record["step_routes"])

    # Where one call's device time goes (torch.profiler, CUDA activity).
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run(model, params, x, y, loss, extensions=exts, cfg=cfg)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0

    def device_us(e):  # the attribute's name changed across PyTorch versions
        return getattr(e, "device_time_total", None) or getattr(e, "cuda_time_total", 0)

    # Kernels only: the aten:: operators' device time is their kernels' again.
    events = [e for e in prof.key_averages() if device_us(e) > 0
              and not e.key.startswith(("aten::", "cuda", "Memcpy", "Memset"))]
    device_ms = sum(device_us(e) for e in events) / 1e3
    top = sorted(events, key=lambda e: -device_us(e))[:12]
    record["profile"] = dict(wall_ms=wall * 1e3, device_ms=device_ms,
                             top=[dict(name=e.key[:80], ms=device_us(e) / 1e3,
                                       calls=e.count) for e in top])
    say("profile", **record["profile"])

    # -- 5. the card against the CPU on the same call ------------------------
    draws = torch.randint(0, 10, (1, N), generator=torch.Generator().manual_seed(1))

    def compare(label, mdl, prm, xx, yy, names, rng, tol=TOL):
        cfg_k = ExtensionConfig(use_kernels=True)
        card = run(mdl, prm, xx, yy, loss, extensions=names, cfg=cfg_k, rng=rng)
        cpu = run(mdl, tree_map(lambda p: p.cpu(), prm), xx.cpu(), yy.cpu(), loss,
                  extensions=names, cfg=cfg_k, rng=rng)
        errs = {}
        pairs = [("loss", [card.loss], [cpu.loss]), ("logits", [card.logits], [cpu.logits]),
                 ("grads", tree_leaves(card.grads), tree_leaves(cpu.grads))]
        pairs += [(e.name, tree_leaves(card.ext[e.name]), tree_leaves(cpu.ext[e.name]))
                  for e in names]
        # Variance = N·Σg² − (Σg)²: its rounding error scales with N·Σg².
        scale = {"variance": tree_leaves(cpu.ext["second_moment"])} if "variance" in card.ext else {}
        for key, got, want in pairs:
            err = 0.0
            for i, (g, w) in enumerate(zip(got, want, strict=True)):
                den = (scale[key][i] if key in scale else w).abs().max().item()
                err = max(err, (g.cpu() - w).abs().max().item() / max(den, 1e-30))
            errs[key] = err
        say("compare", label=label, tol=tol, rel_err=errs)
        bad = {k: v for k, v in errs.items() if not v <= tol}
        if bad:
            fail(f"{label}: card and CPU disagree {bad}")
        return errs

    record["compare_c3d3"] = compare("c3d3 card vs cpu", model, params, x, y, exts, draws)

    # -- 6. KFRA and DiagHessian on the MLP ----------------------------------
    mlp = papernets.mlp(device="cuda", generator=torch.Generator().manual_seed(2))
    xm = torch.randn(N, 784, device="cuda", generator=gen)
    ym = torch.randint(0, 10, (N,), device="cuda", generator=gen)
    record["compare_mlp"] = compare("mlp kfra+diag_hessian card vs cpu", mlp, mlp.params(),
                                    xm, ym, (by_name("kfra"), by_name("diag_hessian")), None)

    # -- 7. the kernel table --------------------------------------------------
    table = []
    for k in ops.KERNELS:
        agg = per_kernel[k]
        table.append(dict(
            name=k, route="cuda", source=modules[k].SOURCE, replaces=modules[k].REPLACES,
            launches=launches[k], max_abs_err=agg["max_abs_err"],
            max_rel_err=agg["max_rel_err"], ms=agg["ms"],
            plain_ms=agg["plain_ms"], bound_ms=agg["bound_ms"],
            bound_by="operations" if agg["ops_ms"] >= agg["bytes_ms"] else "bytes",
            library_ms=agg["library_ms"] if k in library else None,
            shapes=agg["shapes"]))
    record["kernels"] = table
    out = ROOT / "build"
    out.mkdir(exist_ok=True)
    (out / "chip_smoke.json").write_text(json.dumps(record, indent=1, default=str))
    if not all(math.isfinite(r["ms"]) for r in table):
        fail("a kernel time is not finite")
    print(json.dumps({"kernels": table}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
