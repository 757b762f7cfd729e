#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA card (written for the H100).

    python3 chip_smoke.py

Builds the ten Hopper kernels from ``src/repro_torch/kernels/csrc`` (one
nvcc per source, all at once) and holds each against its plain PyTorch
version at the shapes its path gives it: BackPACK's on 3C3D at batch 128, and
Hymba-1.5B's serving shapes for flash_attention and wkv.  Then it drives six
paths through the entry points a user calls, five on 3C3D (CIFAR-10 shapes,
full width, random weights from a seed) and one on Hymba-1.5B, each with the
launch counts set to 0 just before and read just after:

* the main path, ``repro_torch.core.run`` with the ten first-order,
  exact-GGN and MC extensions on the fused route (the default), which must
  launch fused_first_order, fused_second_order and sq_matmul and none of
  the per-extension kernels; it is also timed against the plain PyTorch
  route, profiled, and compared card against CPU;
* the per-extension route (``use_fused=False``), which must launch
  per_sample_moment (9 a call), batch_l2 (3) and sq_matmul (9) and no fused
  kernel, compared with the fused route on the card and with the CPU, and
  timed interleaved with the fused route;
* the paper's curvature-preconditioned training
  (``make_extended_train_step`` with ``curvature_optimizer``), ten steps each
  with KFAC and DiagGGN-MC on one fixed batch: the loss must fall, one step
  must agree card against CPU, and the steps are timed against the plain
  gradient step (``make_train_step`` with SGD).

* the Gram family, ``run`` with NTK, NTKClasswise and GGNGram, which must
  launch cross_dot 6 times (3 conv layers × the NTK and the GGNGram Gram)
  and nothing else, compared card against CPU, with the NTK symmetric, its
  diagonal ≥ 0 and the class-wise kernel summing to it; then the
  kernel-space natural gradient ``kernel_ngd_direction`` card against CPU;
* the Laplace posterior on the parameters the KFAC steps trained: DiagLaplace
  (DiagGGN), KronLaplace (KFLR) and LastLayerLaplace (kron) fitted on the
  training batch, ``glm_predictive`` on a held-out batch of 128 (3
  predictive_var launches for each full-network posterior, none for the
  last-layer closed form), card (float32) against the CPU in float64,
  ``probit_predictive`` rows
  summing to 1, a finite ``log_marglik`` that ``optimize_marglik`` raises;
* the serving path (``serve_phase``): Hymba-1.5B at full width in bfloat16,
  ``make_prefill_step`` on 4 prompts of 2048 tokens (flash_attention and wkv
  32 launches each, nothing else), greedy ``generate`` on 4 prompts of 32
  tokens to 128 (each kernel 32 times a serve_step), timed decode steps and
  one profiled, from a 32-token cache and at a long context (16 steps after
  a 1500-token prefill into caches of 2048, ``serve_decode_long``: wall and
  device ms, idle share, attention's device ms); in a float32 copy of the
  weights the serve_step chain over
  1040 tokens matches the full forward (the window-1024 rings wrap, limit
  1e-3) and the card matches the CPU (batch 1, T 64, limit 1e-4); and
  ``python -m repro_torch.launch.serve --arch hymba-1.5b --full`` exits 0.

The two kernels with a library counterpart (sq_matmul: ``torch.matmul`` of
the squares; flash_attention: SDPA) are timed in turns with it (kernel,
library, library, kernel); they and wkv get their device time a call from
a profiler window, taken after every row's event times so that no event
time follows a profiler window; flash_attention's rows name the design
that ran (``flash_attention.design``: "split" for decode, T·g < 64, with its
split count and scratch bytes; "wgmma" for bf16 prefill at (dh, dv) ∈
{(64, 64), (128, 128)} and at the other configs' wider heads, (120, 120),
(192, 128) and (240, 240); "simt" else: float32), and their device time's
share of the bound.  bf16 attention and wkv outputs are
also held row by row (``ROW_TOL``).

sq_matmul, cross_dot, fused_second_order, fused_first_order,
per_sample_moment, predictive_var, ggn_diag (3xTF32 on the tensor cores)
and batch_l2 (3xTF32 in its gradient form, float32 on the CUDA cores in its
Gram form) are also held to their formula evaluated in float64 on the card,
whole-tensor (``F64_TOL``) and entry by entry (``ENTRY_TOL``), the five with
a per-sample sum also at conv3's widths with 256 and 1024 rows a sample
(weight 0).  cross_dot's
one-row-set rows and fused_first_order's dot must be symmetric bit for bit,
and fused_first_order's l2 equal to dot's diagonal bit for bit.  Every float32 row also carries a second bound, 3 × its matrix
products' operations at the TF32 rate (``bound_tf32_ms``), and its share of
it.

It also runs KFRA and DiagHessian on the 784-128-64-10 MLP, card against
CPU.  Every phase prints a line; any failure exits non-zero.  The
second-to-last lines are the kernel table (JSON) and the card's name and
power limit; the last line is ``{"ok": true, "device": {...}}``.  The full
record goes to ``build/chip_smoke.json``.

Float32 throughout BackPACK's paths, TF32 off for matmuls and cuDNN (the
plain versions and the CPU comparison are exact float32); the serving path
runs in the config's bfloat16.  Bounds use the H100 SXM's published peaks:
67 TFLOP/s float32 without tensor cores, 495 TFLOP/s TF32 and 989 TFLOP/s
bf16 with them (for bf16 queries / r), 3.35 TB/s.
"""
import json
import math
import os
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
PEAK_FLOPS = 67e12
PEAK_BF16 = 989e12  # bf16 tensor cores, dense
PEAK_TF32 = 495e12  # TF32 tensor cores, dense: 3xTF32 runs a float32 product as 3 of these
PEAK_BYTES = 3.35e12
N = 128          # DeepOBS batch for 3C3D on CIFAR-10
TOL = 1e-4       # max |kernel − plain| / max |plain|: float32, other sum order
# bfloat16 outputs: kernel and plain version round float32 results once; a
# last-place float32 difference can flip that rounding by one bfloat16 step,
# at most 2^-7 of the largest output.
BF16_TOL = 1e-2
# ...and row by row for bf16 attention and WKV: max |kernel − plain| / max
# |plain| within each output row (one query head's, or one (n, t, h)'s, dv
# values).  The first attention rows see few keys and set the whole tensor's
# max |plain| (≈ 4); a late row's outputs are about 0.05, so a kernel wrong
# there by a whole output still passes BF16_TOL.  One bfloat16 step at a
# row's largest output is 2^-7; the limit is two steps and a half (PERF.md:
# the readings, and planted faults' readings from
# tools/flash_attention_fault.py and tools/wkv_fault.py).
ROW_TOL = 2e-2
ROW_CHECKED = ("flash_attention", "wkv")  # their y / out rows, enforced on bf16
# The 3xTF32 kernels of the BackPACK paths (and batch_l2's CUDA-core Gram form
# beside its 3xTF32 gradient form) are also held to the same formula in
# float64 on the card (ref.* with dtype=float64): TOL against the float32
# plain version cannot tell 3xTF32 from 1xTF32 (the hi parts alone, ≈ 3
# decimal digits), which reads ≈ 3e-5 whole-tensor at cross_dot's conv3
# depth, and most of what TOL sees there is the float32 plain version's own
# sum order.
F64_CHECKED = ("sq_matmul", "cross_dot", "fused_second_order", "fused_first_order",
               "per_sample_moment", "predictive_var", "batch_l2", "ggn_diag")
# max over outputs of max |kernel − f64| / max |f64|: float32 sums over up
# to 110,592 terms read ≤ 9.4e-7 at 3C3D's shapes (H100, PERF.md), the float32
# plain version 3e-5 where its order is long; the limit keeps 3x over the
# kernels.  The planted faults' readings (tools/cross_dot_fault.py) are in
# PERF.md.
F64_TOL = 3e-6
# ...and entry by entry: the median of |kernel − f64| / |f64| over cross_dot's
# and fused_first_order's dot's off-diagonal entries (sums with
# cancellation, where 1xTF32 loses ≈ 3e-5 of an entry) and over the sums of
# squares (fused_second_order's diag, trace and kron diagonal;
# fused_first_order's l2 and moment; per_sample_moment's, predictive_var's,
# batch_l2's, sq_matmul's and ggn_diag's every entry), the largest of the
# outputs' medians.  The max is printed beside it: a near-zero entry makes it
# large for any float32 sum.  The kernels read ≤ 6.9e-7 (1xTF32, the split
# skipped, 1e-5 to 5e-4); the limit keeps 3x over them.
ENTRY_TOL = 2.5e-6
# The serving path: Hymba-1.5B (32 layers, 3 global, 29 with a window of
# 1024), 4 prompts of 2048 tokens for prefill, of 32 tokens to 128 for
# generate; the decode-vs-forward check runs one sequence of 1040 tokens so
# the window-1024 rings wrap.
SERVE = dict(arch="hymba-1.5b", batch=4, prefill_len=2048, prompt_len=32, max_len=128,
             chain_len=1040, cpu_len=64, layers=32, global_layers=3, window=1024,
             long_pos=1500, long_max_len=2048)
CHAIN_TOL = 1e-3  # decode chain vs full forward, float32 weights, 32 layers

FIRST = ("batch_grad", "batch_l2", "second_moment", "variance", "batch_dot")
EXACT = ("diag_ggn", "kflr", "ggn_trace")
MC = ("diag_ggn_mc", "kfac")
FUSED_KERNELS = ("fused_first_order", "fused_second_order", "sq_matmul")
# launches of one run call of the ten extensions on 3C3D's per-extension
# route: 3 conv layers × (moment, exact diag, MC diag) and l2; 3 dense layers
# × (moment, exact diag, MC diag).
PER_EXTENSION_LAUNCHES = {"per_sample_moment": 9, "batch_l2": 3, "sq_matmul": 9}
# rows a sample of the weight-0 rows at conv3's widths (a = 864, b = 128)
CONV3_DEEP_ROWS = (256, 1024)
TRAIN_STEPS = 10
# (curvature, extensions, lr, damping): ten steps on one fixed batch
# reduce the loss with these (chosen on the CPU at the same size).
TRAIN = (("kfac", ("kfac",), 0.2, 0.1),
         ("diag_ggn_mc", ("diag_ggn_mc", "variance"), 0.05, 1.0))


def say(tag, **kw):
    print(f"{tag}: " + json.dumps(kw, sort_keys=True), flush=True)


def fail(msg):
    print(f"FAILED: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def row_rel_err(got, want):
    """The largest, over rows (all but the last dimension), of max |got −
    want| / max |want| within the row."""
    g, w = got.float().flatten(0, -2), want.float().flatten(0, -2)
    return ((g - w).abs().amax(-1) / w.abs().amax(-1)).max().item()


def f64_readings(torch, kernel, got, want64):
    """``rel64`` (max over outputs of max |got − want64| / max |want64|),
    ``entry_median`` (the largest over outputs of the median of |got −
    want64| / |want64| over the entries ``ENTRY_TOL`` reads, ``F64_TOL``'s
    comment: so a fault in one output shows though the others hold more
    entries) and ``entry_max`` (over all those entries)."""
    rel, median, worst = 0.0, 0.0, 0.0
    for key, w in want64.items():
        g = got[key].reshape(w.shape).double()
        rel = max(rel, ((g - w).abs().max() / w.abs().max()).item())
        err = (g - w).abs() / w.abs()
        if kernel == "cross_dot" or key == "dot":  # off the diagonal of each [N1, N2] group
            n1, n2 = w.shape[-2:]
            eye = torch.eye(n1, n2, dtype=torch.bool, device=w.device).expand(w.shape)
            off = err[~eye]
            err = off if off.numel() else err.flatten()  # N = 1: the diagonal
        elif key == "kron":
            err = torch.diagonal(err)
        median = max(median, err.flatten().median().item())
        worst = max(worst, err.max().item())
    return dict(rel64=rel, entry_median=median, entry_max=worst)


def medians_ms(samples):
    return {k: sorted(v)[len(v) // 2] * 1e3 for k, v in samples.items()}


def profiled(call, groups=None):
    """One call under torch.profiler: wall ms, summed device kernel ms, the
    top kernels by device time, and for each ``groups`` label the device ms
    of the kernels whose name holds its text."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        call()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0

    events = kernel_events(torch, prof)
    top = sorted(events, key=lambda e: -device_us(e))[:12]
    out = dict(wall_ms=wall * 1e3, device_ms=sum(device_us(e) for e in events) / 1e3,
               top=[dict(name=e.key[:80], ms=device_us(e) / 1e3, calls=e.count)
                    for e in top])
    for label, text in (groups or {}).items():
        out[f"{label}_device_ms"] = sum(device_us(e) for e in events if text in e.key) / 1e3
    return out


def device_us(e):  # the attribute's name changed across PyTorch versions
    return getattr(e, "device_time_total", None) or getattr(e, "cuda_time_total", 0)


def kernel_events(torch, prof):
    """Kernels only (events on the device): an operator's device time
    (aten::, autograd's backward nodes) is its kernels' again."""
    return [e for e in prof.key_averages() if device_us(e) > 0
            and e.device_type == torch.autograd.DeviceType.CUDA
            and not e.key.startswith(("Memcpy", "Memset"))]


def device_per_call(torch, fn, iters=10, windows=3):
    """Device ms a call of ``fn`` (the sum of its kernels' times in one
    torch.profiler window of ``iters`` calls, after one warm-up call), and
    each kernel's share by name: where a call is short, CUDA events time the
    host that issues it.  A window in which the profiler recorded no kernel
    is taken again, up to ``windows`` in all; then the run fails."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for _ in range(windows):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        events = kernel_events(torch, prof)
        total = sum(device_us(e) for e in events)
        if total > 0:
            return (total / 1e3 / iters,
                    {e.key[:80]: device_us(e) / 1e3 / iters for e in events})
        print("device_per_call: a profiler window recorded no kernel; taken again",
              file=sys.stderr, flush=True)
    fail(f"the profiler recorded no kernel in {windows} windows of {iters} calls")


def attention_mask(torch, t, s, window, q_positions=None, k_positions=None):
    """[T, S] True where a causal, windowed attention sees the key."""
    qp = torch.arange(t, device="cuda") if q_positions is None else q_positions.long()
    kp = torch.arange(s, device="cuda") if k_positions is None else k_positions.long()
    m = (kp[None, :] >= 0) & (qp[:, None] >= kp[None, :])
    if window is not None:
        m &= (qp[:, None] - kp[None, :]) < window
    return m


def seen_pairs(torch, *args):
    """(query, key) pairs an attention computes: the work a bound counts."""
    return int(attention_mask(torch, *args).sum().item())


def lm_kernel_cases(torch, randn, gen):
    """flash_attention and wkv at Hymba-1.5B's serving shapes (and wkv at the
    Pallas kernel's own RWKV6-3B signature), in the path's dtypes and in
    float32, and flash_attention at CodeQwen1.5-7B's dh 128 in bfloat16
    and at the other configs' wider heads (``wide_attention_cases``; weight
    0).  Per-call weights count launches per prefill call: 3 global
    and 29 windowed attentions, 32 SSD scans, in bfloat16 (decode rows give
    their launches per serve_step and weigh 0).  Operations: 2·dh +
    2·dv a seen (query, key) pair; WKV's recurrent form, 4·dk·dv a token and
    head (+ 3·dk + 2·dv with the bonus u).  The peak is bf16's where the
    queries / r are bfloat16."""
    cases = []
    i32 = dict(device="cuda", dtype=torch.int32)
    n, t, h, kv, dh = SERVE["batch"], SERVE["prefill_len"], 25, 5, 64
    for dtype, tag, peak, tol in ((torch.bfloat16, "bf16", PEAK_BF16, BF16_TOL),
                                  (torch.float32, "fp32", PEAK_FLOPS, TOL)):
        size = dtype.itemsize
        q, k, v = (randn(n, t, x, dh).to(dtype) for x in (h, kv, kv))
        for window, per_call in ((None, SERVE["global_layers"]),
                                 (SERVE["window"], SERVE["layers"] - SERVE["global_layers"])):
            weight = per_call if dtype == torch.bfloat16 else 0
            cases.append(("flash_attention", f"prefill {tag} window={window} q[{n},{t},{h},{dh}] "
                          f"kv[{n},{t},{kv},{dh}]", weight, weight, (q, k, v),
                          dict(window=window), 4 * dh * n * h * seen_pairs(torch, t, t, window),
                          size * 2 * n * t * (h + kv) * dh, tol, peak))
        if dtype == torch.bfloat16:
            # CodeQwen1.5-7B's widths (32 heads of 128, no GQA): the wgmma
            # design at dh 128, off the serving path (weight 0)
            q, k, v = (randn(n, t, 32, 128).to(dtype) for _ in range(3))
            cases.append(("flash_attention", f"prefill {tag} dh128 (codeqwen1.5-7b) "
                          f"q,k,v[{n},{t},32,128]", 0, 0, (q, k, v), dict(window=None),
                          4 * 128 * n * 32 * seen_pairs(torch, t, t, None),
                          size * 4 * n * t * 32 * 128, tol, peak))
        # decode at position 1500: a ring of 1024 that wrapped, a global cache of 2048
        pos = 1500
        ring = torch.arange(1024, **i32)
        ring = torch.where(ring <= pos % 1024, ring + 1024, ring)
        glob = torch.arange(2048, **i32)
        glob[pos + 1:] = -1
        if dtype == torch.bfloat16:
            cases += wide_attention_cases(torch, randn, pos, ring, glob)
        qd = randn(n, 1, h, dh).to(dtype)
        for label, s, window, kp, per_step in (
                ("ring 1024", 1024, SERVE["window"], ring,
                 SERVE["layers"] - SERVE["global_layers"]),
                ("global 2048", 2048, None, glob, SERVE["global_layers"])):
            kc, vc = randn(n, s, kv, dh), randn(n, s, kv, dh)  # the float32 cache
            qp = torch.tensor([pos], **i32)
            per_step = per_step if dtype == torch.bfloat16 else 0
            cases.append(("flash_attention", f"decode {label} q {tag} [{n},1,{h},{dh}] fp32 "
                          f"cache[{n},{s},{kv},{dh}] (per call: a serve_step)", per_step, 0,
                          (qd, kc, vc),
                          dict(window=window, q_positions=qp, k_positions=kp),
                          4 * dh * n * h * seen_pairs(torch, 1, s, window, qp, kp),
                          2 * size * n * h * dh + 4 * (2 * n * s * kv * dh + s + 1), tol, peak))
        cases += wkv_cases(torch, randn, dtype, tag, tol, peak)
    return cases


def wkv_cases(torch, randn, dtype, tag, tol, peak):
    """wkv's rows in one dtype (``lm_kernel_cases``): Hymba-1.5B's SSD in
    prefill (chunk 16) and decode (T = 1, chunk 1), and the Pallas kernel's
    own signature at RWKV6-3B widths (weight 0)."""
    cases = []
    n, t, h, size = SERVE["batch"], SERVE["prefill_len"], 25, dtype.itemsize
    # Hymba's SSD: r = C, k = B [.., 16], v = xs [.., 64], a float32 decay per head
    ds, dv = 16, 64
    for label, tt, chunk in (("prefill", t, 16), ("decode", 1, 1)):
        per_call = SERVE["layers"] if dtype == torch.bfloat16 else 0
        weight = per_call if label == "prefill" else 0
        r, kk = randn(n, tt, h, ds).to(dtype), randn(n, tt, h, ds).to(dtype)
        xs = randn(n, tt, h, dv).to(dtype)
        lw = -torch.nn.functional.softplus(randn(n, tt, h, 1))
        s0 = randn(n, h, ds, dv)
        cases.append(("wkv", f"hymba ssd {label} {tag} r,k[{n},{tt},{h},{ds}] "
                      f"v[{n},{tt},{h},{dv}] decay[..,1] state0, chunk {chunk}", per_call,
                      weight, (r, kk, xs, lw, None, s0), dict(chunk=chunk),
                      4 * n * tt * h * ds * dv,
                      size * n * tt * h * (2 * ds + 2 * dv) + 4 * n * tt * h
                      + 4 * 2 * n * h * ds * dv, tol, peak))
    # the Pallas kernel's own signature at RWKV6-3B widths
    h6, d6 = 40, 64
    r, kk, vv = (randn(n, t, h6, d6).to(dtype) for _ in range(3))
    lw = -torch.nn.functional.softplus(randn(n, t, h6, d6))
    u = randn(h6, d6)
    cases.append(("wkv", f"rwkv6 {tag} r,k,v[{n},{t},{h6},{d6}] decay per channel, u, "
                  "chunk 16", 0, 0, (r, kk, vv, lw, u, None), dict(chunk=16),
                  n * t * h6 * (4 * d6 * d6 + 5 * d6),
                  size * 4 * n * t * h6 * d6 + 4 * n * t * h6 * d6 + 4 * h6 * d6
                  + 4 * n * h6 * d6 * d6, tol, peak))
    return cases


def wide_attention_cases(torch, randn, pos, ring, glob):
    """flash_attention at the head widths of the other configs, off the
    serving path (weight 0), bf16 queries ("wgmma" in prefill, "split" in
    decode): h2o-danube3-4b's
    dh 120 (32 heads over 8, window 8192), deepseek-v2-lite's MLA (dh 192,
    dv 128, 16 heads) and gemma3-12b's dh 240 (16 heads over 8, window 1024)
    in prefill of 4×2048; CodeQwen1.5-7B's dh 128 (32 heads, no GQA) and
    gemma3-12b in decode at position 1500 against float32 caches (a global
    cache of 2048, a ring of 1024)."""
    cases = []
    n, t, bf = SERVE["batch"], SERVE["prefill_len"], torch.bfloat16
    for name, h, kv, dh, dv, window in (("h2o-danube3-4b", 32, 8, 120, 120, 8192),
                                        ("deepseek-v2-lite mla", 16, 16, 192, 128, None),
                                        ("gemma3-12b", 16, 8, 240, 240, 1024)):
        q, k, v = randn(n, t, h, dh).to(bf), randn(n, t, kv, dh).to(bf), randn(n, t, kv, dv).to(bf)
        cases.append(("flash_attention", f"wide prefill bf16 dh{dh} dv{dv} ({name}) "
                      f"q[{n},{t},{h},{dh}] kv[{n},{t},{kv},..] window={window}", 0, 0,
                      (q, k, v), dict(window=window),
                      2 * (dh + dv) * n * h * seen_pairs(torch, t, t, window),
                      2 * n * t * (h * (dh + dv) + kv * (dh + dv)), BF16_TOL, PEAK_BF16))
    qp = torch.tensor([pos], device="cuda", dtype=torch.int32)
    for name, h, kv, dh, s, window, kp in (("codeqwen1.5-7b", 32, 32, 128, 2048, None, glob),
                                           ("gemma3-12b", 16, 8, 240, 1024, 1024, ring)):
        q, kc, vc = randn(n, 1, h, dh).to(bf), randn(n, s, kv, dh), randn(n, s, kv, dh)
        cases.append(("flash_attention", f"wide decode bf16 dh{dh} ({name}) q[{n},1,{h},{dh}] "
                      f"fp32 cache[{n},{s},{kv},{dh}] window={window}", 0, 0, (q, kc, vc),
                      dict(window=window, q_positions=qp, k_positions=kp),
                      4 * dh * n * h * seen_pairs(torch, 1, s, window, qp, kp),
                      2 * 2 * n * h * dh + 4 * (2 * n * s * kv * dh + s + 1), BF16_TOL, PEAK_BF16))
    return cases


def library_attention(torch):
    """One ``scaled_dot_product_attention`` call (GQA, causal or an explicit
    mask) on the same inputs: timed as flash_attention's ``library_ms``, used
    nowhere in the port.  Masks are built once per shape and kept; a float32
    cache is cast to the queries' dtype."""
    import torch.nn.functional as TF

    masks = {}

    def attend(q, k, v, *, causal=True, window=None, q_positions=None, k_positions=None):
        t, s = q.shape[1], k.shape[1]
        qt, kt, vt = (x.transpose(1, 2).to(q.dtype) for x in (q, k, v))
        if window is None and q_positions is None and k_positions is None:
            out = TF.scaled_dot_product_attention(qt, kt, vt, is_causal=causal, enable_gqa=True)
        else:
            key = (t, s, window, None if q_positions is None else q_positions.data_ptr(),
                   None if k_positions is None else k_positions.data_ptr())
            if key not in masks:
                masks[key] = attention_mask(torch, t, s, window, q_positions, k_positions)
            out = TF.scaled_dot_product_attention(qt, kt, vt, attn_mask=masks[key],
                                                  enable_gqa=True)
        return out.transpose(1, 2)

    return attend


def backpack_cases(torch, randn, gen, l2_mod):
    """The eight BackPACK kernels' rows at 3C3D's batch-128 shapes: (kernel,
    shape label, launches per run call on its path, weight in the kernel's
    per-call sums, inputs, kwargs, operations, bytes, tol, peak, product
    operations).  Operations are the fewest the outputs need; the product
    operations are their matrix products alone, what 3xTF32 runs on the
    tensor cores (``bound_tf32``)."""
    conv = {"conv1": (1024, 75, 64), "conv2": (256, 576, 96), "conv3": (64, 864, 128)}
    dense = {"dense1": (2048, 512), "dense2": (512, 256), "dense3": (256, 10)}
    cases = []

    def add(kernel, label, per_call, weight, args, kw, flops, nbytes, prod):
        cases.append((kernel, label, per_call, weight, args, kw, flops, nbytes, TOL, PEAK_FLOPS,
                      prod))

    # Operations are the fewest the outputs need: G_n = A_nᵀB_n (2·N·r·a·b),
    # one square per G entry and one add each into l2 and moment (3·N·a·b),
    # and dot's N(N−1)/2 off-diagonal pairs (2·a·b each; dot is symmetric
    # and its diagonal is l2).
    for name, (r, a, b) in conv.items():
        A, B = randn(N, r, a), randn(N, r, b)
        flops = 2 * N * r * a * b + 3 * N * a * b + N * (N - 1) * a * b
        nbytes = 4 * (N * r * (a + b) + N + a * b + N * N)
        add("fused_first_order", f"{name} A[{N},{r},{a}] B[{N},{r},{b}]", 1, 1, (A, B),
            dict(want_l2=True, want_moment=True, want_dot=True), flops, nbytes,
            2 * N * r * a * b + N * (N - 1) * a * b)
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
            add("fused_second_order", f"{name} {label} A[{N},{r},{a}] S[{c},{N},{r},{b}]", 1, 1,
                (A, S), wants, flops, nbytes,
                2 * c * N * r * a * b + c * N * r * b * (b + 1))
        # The per-extension route: the moment of the first sweep and the MC
        # diagonal (N rows), the exact diagonal on the broadcast input (C·N
        # rows); G_n costs 2·r·a·b, its square and sum 2·a·b.
        for rows, per_call, label in ((N, 2, "moment+mc"), (10 * N, 1, "exact diag")):
            Ar = A if rows == N else A.repeat(10, 1, 1)
            Br = B if rows == N else randn(rows, r, b)
            add("per_sample_moment", f"{name} {label} A[{rows},{r},{a}] B[{rows},{r},{b}]",
                per_call, per_call, (Ar, Br), {}, rows * (2 * r * a * b + 2 * a * b),
                4 * (rows * r * (a + b) + a * b), rows * 2 * r * a * b)
        # batch_l2 in both forms; the path takes the one with fewer
        # operations, and the bound counts that one.
        counts = l2_mod.batch_l2_ops(N, r, a, b)
        taken = l2_mod.batch_l2_form(r, a, b)
        prod = min(N * r * (r + 1) // 2 * (2 * a + 2 * b), N * 2 * r * a * b)
        for form in l2_mod.FORMS:
            on_path = int(form == taken)
            add("batch_l2", f"{name} form={form}{' (path)' if on_path else ''} "
                f"A[{N},{r},{a}] B[{N},{r},{b}]", on_path, on_path, (A, B), dict(form=form),
                min(counts.values()), 4 * (N * r * (a + b) + N), prod)
        # ggn_diag has no call site; it is held at the exact sweep's shapes,
        # once each in its sums.
        S = randn(10, N, r, b)
        add("ggn_diag", f"{name} exact A[{N},{r},{a}] S[10,{N},{r},{b}]", 0, 1, (A, S), {},
            10 * N * (2 * r * a * b + 2 * a * b), 4 * (N * r * a + 10 * N * r * b + a * b),
            10 * N * 2 * r * a * b)
    for name, (a, b) in dense.items():
        for rows, per_call, label in ((N, 2, "moment+mc"), (10 * N, 1, "exact diag")):
            A, B = randn(rows, a), randn(rows, b)
            add("sq_matmul", f"{name} {label} A[{rows},{a}] B[{rows},{b}]", per_call, per_call,
                (A, B), {}, 2 * rows * a * b + rows * (a + b), 4 * (rows * (a + b) + a * b),
                2 * rows * a * b)

    # conv3's widths at 256 and 1024 rows a sample (conv3 itself has 64), off
    # the path (weight 0): deep enough that a per-sample sum carried
    # unpromoted in the tensor cores' accumulator fails the float64 checks
    # (tools/cross_dot_fault.py reads these rows).  Drawn from a generator of
    # their own, so the other rows and paths see the inputs they saw before.
    deep = torch.Generator(device="cuda").manual_seed(1)
    _, a, b = conv["conv3"]
    for r in CONV3_DEEP_ROWS:
        A, B, S = (torch.randn(*shape, device="cuda", generator=deep)
                   for shape in ((N, r, a), (N, r, b), (10, N, r, b)))
        name = f"conv3 widths R{r} (weight 0)"
        add("fused_first_order", f"{name} A[{N},{r},{a}] B[{N},{r},{b}]", 0, 0, (A, B),
            dict(want_l2=True, want_moment=True, want_dot=True),
            2 * N * r * a * b + 3 * N * a * b + N * (N - 1) * a * b,
            4 * (N * r * (a + b) + N + a * b + N * N), 2 * N * r * a * b + N * (N - 1) * a * b)
        add("per_sample_moment", f"{name} A[{N},{r},{a}] B[{N},{r},{b}]", 0, 0, (A, B), {},
            N * (2 * r * a * b + 2 * a * b), 4 * (N * r * (a + b) + a * b), N * 2 * r * a * b)
        flops = 2 * 10 * N * r * a * b + 10 * N * (N + 1) * a * b
        add("cross_dot", f"{name} ntk A[{N},{r},{a}] S[10,{N},{r},{b}]", 0, 0,
            (A[None], S, A[None], S), {}, flops,
            4 * (N * r * a + 10 * N * r * b + 10 * N * N), flops)
        add("ggn_diag", f"{name} exact A[{N},{r},{a}] S[10,{N},{r},{b}]", 0, 0, (A, S), {},
            10 * N * (2 * r * a * b + 2 * a * b), 4 * (N * r * a + 10 * N * r * b + a * b),
            10 * N * 2 * r * a * b)
        W = torch.rand(a, b, device="cuda", generator=deep)
        add("predictive_var", f"{name} diag Sigma A[{N},{r},{a}] S[10,{N},{r},{b}]", 0, 0,
            (A, S, W), {}, 2 * 10 * N * r * a * b + 3 * 10 * N * a * b,
            4 * (N * r * a + 10 * N * r * b + 10 * N + a * b), 2 * 10 * N * r * a * b)

    # The Gram family's cross_dot (per gram run call: the NTK's E = C groups
    # over one shared input and GGNGram's C·N class-major rows, one row set
    # each, so the kernel forms G once and the upper triangle of the Gram;
    # and, off the path, two different row sets: the two halves of the
    # batch) and the Laplace predictive's predictive_var (per glm_predictive
    # call: with Sigma for a diagonal posterior, without for a Kronecker
    # one), at the conv layers; the dense layers take closed forms.
    # Operations: G = AᵀB (2·R·a·b a row), the Gram's pairs (2·a·b each,
    # N(N+1)/2 of them on one row set), t = A_nᵀS_cn (2·C·N·R·a·b) and its
    # square, weight and sum (3 or 2 per t entry).
    for name, (r, a, b) in conv.items():
        A, S = randn(N, r, a), randn(10, N, r, b)
        rows = S.reshape(1, 10 * N, r, b)
        for label, args, e, n_rows in (
                (f"{name} ntk A[{N},{r},{a}] S[10,{N},{r},{b}]", (A[None], S, A[None], S), 10, N),
                (f"{name} ggn_gram A[{N},{r},{a}] rows[{10 * N},{r},{b}]",
                 (A[None], rows, A[None], rows), 1, 10 * N)):
            flops = 2 * e * n_rows * r * a * b + e * n_rows * (n_rows + 1) * a * b
            nbytes = 4 * (N * r * a + e * n_rows * r * b + e * n_rows * n_rows)
            add("cross_dot", label, 1, 1, args, {}, flops, nbytes, flops)
        if name == "conv2":
            h = N // 2
            args = (A[None, :h].contiguous(), S[:1, :h].contiguous(),
                    A[None, h:].contiguous(), S[:1, h:].contiguous())
            flops = 2 * N * r * a * b + 2 * h * h * a * b
            add("cross_dot", f"{name} two row sets A[2x{h},{r},{a}] B[2x{h},{r},{b}]", 0, 0,
                args, {}, flops, 4 * (N * r * (a + b) + h * h), flops)
        W = torch.rand(a, b, device="cuda", generator=gen)
        for sigma in (W, None):
            label = "diag Sigma" if sigma is not None else "kron"
            add("predictive_var", f"{name} {label} A[{N},{r},{a}] S[10,{N},{r},{b}]", 1,
                int(sigma is not None), (A, S, sigma), {},
                2 * 10 * N * r * a * b + (2 + (sigma is not None)) * 10 * N * a * b,
                4 * (N * r * a + 10 * N * r * b + 10 * N + (a * b if sigma is not None else 0)),
                2 * 10 * N * r * a * b)
    return cases


def serve_phase(torch, ops):
    """Hymba-1.5B at full width (bfloat16, 32 layers, random weights from a
    seed) through the serving entry points, with the launch counts reset
    before each call and read after: ``make_prefill_step`` on 4 prompts of
    2048 tokens (flash_attention and wkv 32 times each, nothing else);
    greedy ``generate`` on 4 prompts of 32 tokens to 128 (each kernel 32
    times a serve_step); decode steps timed and one profiled; then, in a
    float32 copy of the weights, the serve_step chain over 1040 tokens
    (past the window-1024 rings' wrap) against the full forward, the card
    against the CPU at batch 1, T 64; and the launcher run once."""
    from repro_torch.configs import get_config
    from repro_torch.core.tree import tree_leaves, tree_map
    from repro_torch.nn.models import build_model
    from repro_torch.serve import ServeConfig, generate, prefill
    from repro_torch.train import make_decode_step, make_prefill_step

    out = {}
    cfg = get_config(SERVE["arch"])
    t0 = time.perf_counter()
    model = build_model(cfg, device="cuda", generator=torch.Generator().manual_seed(0))
    params = model.params()
    torch.cuda.synchronize()
    out["model"] = dict(arch=cfg.name, dtype=cfg.dtype, layers=cfg.n_layers,
                        param_count=cfg.param_count(model), build_s=time.perf_counter() - t0,
                        param_bytes=sum(p.numel() * p.element_size() for p in tree_leaves(params)))
    say("serve_model", **out["model"])
    gen = torch.Generator(device="cuda").manual_seed(7)
    n, t_pre = SERVE["batch"], SERVE["prefill_len"]
    per_layer = {k: SERVE["layers"] if k in ("flash_attention", "wkv") else 0 for k in ops.KERNELS}

    # -- prefill: one checked call, then three timed ----------------------------
    prompts = torch.randint(0, cfg.vocab, (n, t_pre), device="cuda", generator=gen)
    prefill_step = make_prefill_step(model)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    last = prefill_step(params, prompts)
    torch.cuda.synchronize()
    launches = ops.launch_counts()
    if launches != per_layer:
        fail(f"prefill must launch flash_attention and wkv 32 times each, got {launches}")
    if tuple(last.shape) != (n, cfg.vocab) or not torch.isfinite(last.float()).all():
        fail(f"prefill: logits {tuple(last.shape)} not finite [N, V]")
    times = []
    for _ in range(3):
        t0 = time.perf_counter()
        prefill_step(params, prompts)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    ms = medians_ms({"p": times})["p"]
    out["prefill"] = dict(batch=n, prompt_len=t_pre, launches=launches, step_s=times, ms=ms,
                          tokens_per_s=n * t_pre / ms * 1e3,
                          max_memory_allocated=torch.cuda.max_memory_allocated())
    say("serve_prefill", **out["prefill"])
    out["profile_prefill"] = profiled(lambda: prefill_step(params, prompts))
    say("profile_serve_prefill", **out["profile_prefill"])

    # -- generate: greedy, 32-token prompts to 128 ------------------------------
    short = prompts[:, :SERVE["prompt_len"]].contiguous()
    sc = ServeConfig(max_len=SERVE["max_len"])
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    toks = generate(model, params, short, sc)
    torch.cuda.synchronize()
    gen_s = time.perf_counter() - t0
    gen_launches = ops.launch_counts()
    if gen_launches != {k: v * sc.max_len for k, v in per_layer.items()}:
        fail(f"generate must launch each kernel 32 times a serve_step ({sc.max_len} steps), "
             f"got {gen_launches}")
    if (tuple(toks.shape) != (n, sc.max_len) or not torch.equal(toks[:, :short.shape[1]], short.int())
            or toks.min() < 0 or toks.max() >= cfg.vocab):
        fail(f"generate: tokens {tuple(toks.shape)} are not the prompts and a continuation")
    out["generate"] = dict(batch=n, prompt_len=short.shape[1], max_len=sc.max_len, s=gen_s,
                           ms_per_serve_step=gen_s / sc.max_len * 1e3, launches=gen_launches,
                           max_memory_allocated=torch.cuda.max_memory_allocated(),
                           first_row=toks[0, short.shape[1]:short.shape[1] + 16].tolist())
    say("serve_generate", **out["generate"])

    # -- decode steps from a 32-token prefill, timed; one profiled ---------------
    decode = make_decode_step(model)
    caches = model.init_serve_cache(params, n, sc.max_len, torch.float32)
    caches, logits = prefill(model, params, caches, short, short.shape[1])
    step_s = []
    for t in range(short.shape[1], short.shape[1] + 16):
        tok = logits.argmax(-1).int()
        t0 = time.perf_counter()
        logits, caches = decode(params, caches, tok, t)
        torch.cuda.synchronize()
        step_s.append(time.perf_counter() - t0)
    tok = logits.argmax(-1).int()
    prof = profiled(lambda: decode(params, caches, tok, short.shape[1] + 16))
    prof["idle_share"] = 1 - prof["device_ms"] / prof["wall_ms"]
    out["decode"] = dict(batch=n, step_s=step_s, ms_per_token=medians_ms({"d": step_s})["d"],
                         profile=prof)
    say("serve_decode", **out["decode"])
    del caches, logits

    # -- decode at a long context: 1500 tokens prefilled, 16 steps timed ----------
    pos, long_len = SERVE["long_pos"], SERVE["long_max_len"]
    caches = model.init_serve_cache(params, n, long_len, torch.float32)
    t0 = time.perf_counter()
    caches, logits = prefill(model, params, caches, prompts[:, :pos].contiguous(), pos)
    torch.cuda.synchronize()
    prefill_s = time.perf_counter() - t0
    step_s = []
    ops.reset_launch_counts()
    for t in range(pos, pos + 16):
        tok = logits.argmax(-1).int()
        t0 = time.perf_counter()
        logits, caches = decode(params, caches, tok, t)
        torch.cuda.synchronize()
        step_s.append(time.perf_counter() - t0)
    long_launches = ops.launch_counts()
    if long_launches != {k: 16 * v for k, v in per_layer.items()}:
        fail(f"long-context decode must launch each kernel 32 times a step, got {long_launches}")
    if not torch.isfinite(logits).all():
        fail("long-context decode: non-finite logits")
    tok = logits.argmax(-1).int()
    prof = profiled(lambda: decode(params, caches, tok, pos + 16), groups={"attention": "flash_"})
    prof["idle_share"] = 1 - prof["device_ms"] / prof["wall_ms"]
    out["decode_long"] = dict(
        batch=n, position=pos, max_len=long_len, prefill_s=prefill_s, step_s=step_s,
        ms_per_token=medians_ms({"d": step_s})["d"], launches=long_launches,
        wall_ms=prof["wall_ms"], device_ms=prof["device_ms"], idle_share=prof["idle_share"],
        attention_device_ms=prof["attention_device_ms"], profile=prof)
    say("serve_decode_long", **out["decode_long"])
    del caches, logits, last

    # -- agreement in a float32 copy of the same weights -------------------------
    params32 = tree_map(lambda p: p.float(), params)
    del params
    seq = torch.randint(0, cfg.vocab, (1, SERVE["chain_len"]), device="cuda", generator=gen)
    caches = model.init_serve_cache(params32, 1, SERVE["chain_len"], torch.float32)
    chain = torch.empty((SERVE["chain_len"], cfg.vocab), device="cuda")
    t0 = time.perf_counter()
    for t in range(SERVE["chain_len"]):
        step_logits, caches = model.serve_step(params32, caches, seq[:, t], t)
        chain[t] = step_logits[0]
    torch.cuda.synchronize()
    chain_s = time.perf_counter() - t0
    ring = caches[0][1]["pos"]  # the first window stack: [15, 1024] positions
    if tuple(ring.shape) != (15, SERVE["window"]) or ring.max().item() != SERVE["chain_len"] - 1:
        fail(f"the window-1024 rings did not wrap: positions {tuple(ring.shape)}, "
             f"max {ring.max().item()}")
    full = model.call(params32, seq)[0]
    chain_err = ((chain - full).abs().max() / full.abs().max()).item()
    del chain, caches
    seq_cpu = seq[:, :SERVE["cpu_len"]]
    card = model.call(params32, seq_cpu)
    cpu_params = tree_map(lambda p: p.cpu(), params32)
    cpu = model.call(cpu_params, seq_cpu.cpu())
    cpu_err = ((card.cpu() - cpu).abs().max() / cpu.abs().max()).item()
    del cpu_params, cpu, card, full, params32
    out["agreement"] = dict(chain_len=SERVE["chain_len"], chain_s=chain_s,
                            chain_vs_forward_rel_err=chain_err, chain_tol=CHAIN_TOL,
                            cpu_len=SERVE["cpu_len"], card_vs_cpu_rel_err=cpu_err, cpu_tol=TOL)
    say("serve_agreement", **out["agreement"])
    if not chain_err <= CHAIN_TOL:
        fail(f"decode chain vs full forward: {chain_err:.3e} above {CHAIN_TOL}")
    if not cpu_err <= TOL:
        fail(f"card vs CPU logits: {cpu_err:.3e} above {TOL}")

    # -- the launcher, once ------------------------------------------------------
    del model
    torch.cuda.empty_cache()
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(filter(None, [str(ROOT / "src"), env.get("PYTHONPATH")]))
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, "-m", "repro_torch.launch.serve", "--arch",
                           SERVE["arch"], "--full"], env=env, cwd=ROOT, capture_output=True,
                          text=True, timeout=600)
    out["launcher"] = dict(returncode=proc.returncode, s=time.perf_counter() - t0,
                           stdout=proc.stdout.strip().splitlines()[:1])
    say("serve_launcher", **out["launcher"])
    if proc.returncode != 0:
        fail(f"the launcher exited {proc.returncode}: {proc.stderr[-2000:]}")
    out["launches"] = {k: launches[k] + gen_launches[k] for k in ops.KERNELS}
    return out


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
    from repro_torch.core import (
        NTK,
        CrossEntropyLoss,
        ExtensionConfig,
        GGNGram,
        NTKClasswise,
        by_name,
        gram_total,
        ntk_total,
        run,
    )
    from repro_torch.core.tree import tree_leaves, tree_map
    from repro_torch.curv import kernel_ngd_direction
    from repro_torch.kernels import _build, ops, ref
    from repro_torch.kernels import batch_l2 as l2_mod
    from repro_torch.kernels import cross_dot as cd_mod
    from repro_torch.kernels import flash_attention as fa_mod
    from repro_torch.kernels import fused_first_order as ffo_mod
    from repro_torch.kernels import fused_second_order as fso_mod
    from repro_torch.kernels import ggn_diag as gd_mod
    from repro_torch.kernels import per_sample_moment as psm_mod
    from repro_torch.kernels import predictive_var as pv_mod
    from repro_torch.kernels import sq_matmul as sq_mod
    from repro_torch.kernels import wkv as wkv_mod
    from repro_torch.laplace import (
        fit_posterior,
        glm_predictive,
        log_marglik,
        optimize_marglik,
        probit_predictive,
    )
    from repro_torch.optim import curvature_optimizer, sgd
    from repro_torch.train import make_extended_train_step, make_train_step

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
               "sq_matmul": sq_mod, "per_sample_moment": psm_mod, "batch_l2": l2_mod,
               "ggn_diag": gd_mod, "cross_dot": cd_mod, "predictive_var": pv_mod,
               "flash_attention": fa_mod, "wkv": wkv_mod}
    record["build_s"] = time.perf_counter() - t0
    say("kernels", build_s=record["build_s"],
        kernels=[dict(name=k, source=modules[k].SOURCE, replaces=modules[k].REPLACES,
                      library=libs[k].name) for k in ops.KERNELS])

    # -- 3. each kernel against its plain version at its path's shapes -------
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

    def bound(flops, nbytes, peak=PEAK_FLOPS):
        t_ops, t_bytes = flops / peak * 1e3, nbytes / PEAK_BYTES * 1e3
        return max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes else "bytes")

    cases = backpack_cases(torch, randn, gen, l2_mod)
    cases += lm_kernel_cases(torch, randn, gen)

    wrapper = {k: getattr(ops, k) for k in ops.KERNELS}
    plain = {k: getattr(ref, k) for k in ops.KERNELS}
    plain["fused_first_order"] = lambda A, B, **w: ref.fused_first_order(A[None], B[None], **w)
    plain["batch_l2"] = lambda A, B, form, **w: ref.batch_l2(A, B, **w)
    plain["cross_dot"] = lambda A1, B1, A2, B2, **w: ref.cross_dot(
        ops.full_a_side(A1, B1), B1, ops.full_a_side(A2, B2), B2, **w)
    library = {"sq_matmul": lambda A, B: torch.matmul(A.square().T, B.square()),
               "flash_attention": library_attention(torch)}
    per_kernel = {k: dict(ms=0.0, plain_ms=0.0, bound_ms=0.0, bound_tf32_ms=0.0,
                          library_ms=0.0, ops_ms=0.0, bytes_ms=0.0, max_abs_err=0.0,
                          max_rel_err=0.0, shapes=[])
                  for k in ops.KERNELS}
    record["checks"] = []
    profiled_rows = []  # (row, args, kw): device times after every row's event times
    for case in cases:
        # (kernel, label, per_call, weight, args, kw, flops, bytes, tol, peak[,
        # product flops])
        kernel, label, per_call, weight, args, kw, flops, nbytes, tol, peak, *prod = case
        got = wrapper[kernel](*args, **kw)
        want = plain[kernel](*args, **kw)
        torch.cuda.synchronize()
        if isinstance(got, tuple):  # wkv: (y, state)
            got, want = dict(zip(("y", "state"), got)), dict(zip(("y", "state"), want))
        if not isinstance(got, dict):
            got, want = {"out": got}, {"out": want}
        abs_err = rel_err = 0.0
        for key in want:
            g = got[key].reshape(want[key].shape).float()
            if not torch.isfinite(g).all():
                fail(f"{kernel} {label}: non-finite {key}")
            e = (g - want[key].float()).abs().max().item()
            abs_err = max(abs_err, e)
            rel_err = max(rel_err, e / want[key].float().abs().max().item())
        extra = {}
        if kernel in F64_CHECKED:  # the formula in float64, and the plain version against it
            want64 = plain[kernel](*args, **kw, dtype=torch.float64)
            if not isinstance(want64, dict):
                want64 = {"out": want64}
            extra.update(f64_readings(torch, kernel, got, want64))
            extra["plain"] = f64_readings(torch, kernel, want, want64)
            del want64

        def run_kernel():
            return wrapper[kernel](*args, **kw)

        def run_library():
            return library[kernel](*args, **kw)

        if kernel in library:  # in turns: kernel, library, library, kernel
            turns = [timed(f) for f in (run_kernel, run_library, run_library, run_kernel)]
            ms, lib_ms = (turns[0] + turns[3]) / 2, (turns[1] + turns[2]) / 2
            extra["turns_ms"] = turns
        else:
            ms, lib_ms = timed(run_kernel), None
        plain_ms = timed(lambda: plain[kernel](*args, **kw))
        if kernel == "flash_attention":
            extra["design"] = fa_mod.design(*args, kw.get("window"), kw.get("q_positions"),
                                            kw.get("k_positions"))
            if extra["design"] == "split":  # its grid and scratch, as the wrapper sizes them
                (n_, t_, h_, _), (s_, kv_, dv_) = args[0].shape, args[2].shape[1:]
                keys = fa_mod.split_keys(s_, n_ * kv_ * -(-t_ * (h_ // kv_) // fa_mod.SPLIT_ROWS),
                                         torch.cuda.get_device_properties(0).multi_processor_count)
                extra.update(split_keys=keys, splits=-(-s_ // keys), scratch_bytes=4 * (
                    fa_mod.split_scratch_floats(n_, t_, h_, dv_, -(-s_ // keys))))
        if kernel in ROW_CHECKED:
            out_key = "y" if kernel == "wkv" else "out"
            extra["row_rel_err"] = row_rel_err(got[out_key], want[out_key])
        b_ms, b_by = bound(flops, nbytes, peak)
        if prod:  # the float32 rows: 3 TF32 products for each float32 one
            extra["bound_tf32_ms"] = bound(3 * prod[0], nbytes, PEAK_TF32)[0]
            extra["share_tf32"] = extra["bound_tf32_ms"] / ms
        row = dict(kernel=kernel, shape=label, launches_per_call=per_call, weight=weight,
                   rel_err=rel_err, tol=tol, peak_tflops=peak / 1e12,
                   max_abs_err=abs_err, ms=ms, plain_ms=plain_ms, library_ms=lib_ms,
                   bound_ms=b_ms, bound_by=b_by, share=b_ms / ms, tflops=flops / ms / 1e9,
                   **extra)
        say("check", **row)
        record["checks"].append(row)
        # device times: wkv's decode event time is the host's; the library
        # rows and the 3xTF32 kernels are read against their bounds
        if kernel in library or kernel == "wkv" or kernel in F64_CHECKED:
            profiled_rows.append((row, args, kw))
        if not rel_err <= tol:
            fail(f"{kernel} {label}: relative error {rel_err:.3e} above {tol}")
        if kernel in F64_CHECKED and not (extra["rel64"] <= F64_TOL
                                          and extra["entry_median"] <= ENTRY_TOL):
            fail(f"{kernel} {label}: against float64 {extra['rel64']:.3e} (limit {F64_TOL}), "
                 f"entry median {extra['entry_median']:.3e} (limit {ENTRY_TOL})")
        if kernel == "cross_dot" and "two row sets" not in label and not torch.equal(
                got["out"], got["out"].transpose(1, 2)):
            fail(f"cross_dot {label}: one row set, but not symmetric bit for bit")
        if kernel == "fused_first_order" and not (
                torch.equal(got["dot"], got["dot"].T)
                and torch.equal(got["l2"], torch.diagonal(got["dot"]))):
            fail(f"fused_first_order {label}: dot not symmetric, or l2 not its diagonal, "
                 "bit for bit")
        if kernel in ROW_CHECKED and tol == BF16_TOL and not extra["row_rel_err"] <= ROW_TOL:
            fail(f"{kernel} {label}: row error {extra['row_rel_err']:.3e} above {ROW_TOL}")
        # decode takes the split-KV design; bf16 prefill, at every width the
        # configs use, the tensor cores; float32 prefill "simt"
        want_design = ("split" if "decode" in label.split()
                       else "wgmma" if label.startswith(("prefill bf16", "wide prefill bf16"))
                       else "simt")
        if kernel == "flash_attention" and extra["design"] != want_design:
            fail(f"flash_attention {label}: design {extra['design']}, not {want_design}")
        agg = per_kernel[kernel]
        agg["shapes"].append(label)
        agg["max_abs_err"] = max(agg["max_abs_err"], abs_err)
        agg["max_rel_err"] = max(agg["max_rel_err"], rel_err)
        agg["ms"] += weight * ms
        agg["plain_ms"] += weight * plain_ms
        agg["bound_ms"] += weight * b_ms
        agg["bound_tf32_ms"] += weight * extra.get("bound_tf32_ms", 0.0)
        agg["ops_ms"] += weight * flops / peak * 1e3
        agg["bytes_ms"] += weight * nbytes / PEAK_BYTES * 1e3
        if lib_ms is not None:
            agg["library_ms"] += weight * lib_ms
    # Device time a call, each from a profiler window of its own.
    for row, args, kw in profiled_rows:
        kernel = row["kernel"]
        extra = dict(device_ms=device_per_call(torch, lambda: wrapper[kernel](*args, **kw))[0])
        extra["device_share"] = row["bound_ms"] / extra["device_ms"]
        if kernel in library:
            extra["library_device_ms"], extra["library_kernels"] = device_per_call(
                torch, lambda: library[kernel](*args, **kw))
        row.update(extra)
        say("device", kernel=row["kernel"], shape=row["shape"], **extra)
    del cases, profiled_rows  # free the check inputs before the main path

    # -- 4. the main path: 3C3D at full width, batch 128, three run calls ----
    model = papernets.c3d3(device="cuda", generator=torch.Generator().manual_seed(0))
    params = model.params()
    x = torch.randn(N, 32, 32, 3, device="cuda", generator=gen)
    y = torch.randint(0, 10, (N,), device="cuda", generator=gen)
    loss = CrossEntropyLoss()
    exts = tuple(by_name(n) for n in FIRST + EXACT + MC)
    cfg = ExtensionConfig(mc_seed=0)  # the default route: kernels, fused
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
    wrong = {k: v for k, v in launches.items() if (v > 0) != (k in FUSED_KERNELS)}
    if wrong:
        fail(f"the fused main path must launch exactly {FUSED_KERNELS}, got {wrong}")
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
    record["step_routes"] = dict(step_s=steps, median_ms=medians_ms(steps))
    say("step_routes", **record["step_routes"])

    # Where one call's device time goes (torch.profiler, CUDA activity).
    record["profile"] = profiled(lambda: run(model, params, x, y, loss, extensions=exts,
                                             cfg=cfg))
    say("profile", **record["profile"])

    # -- 5. the card against the CPU on the same call ------------------------
    draws = torch.randint(0, 10, (1, N), generator=torch.Generator().manual_seed(1))
    cfg_fused = ExtensionConfig(use_kernels=True, use_fused=True)
    cfg_pe = ExtensionConfig(use_kernels=True, use_fused=False)

    def rel_errs(got, want, names):
        """max |got − want| / max |want| per output; ``want`` may lie on the CPU."""
        errs = {}
        pairs = [("loss", [got.loss], [want.loss]), ("logits", [got.logits], [want.logits]),
                 ("grads", tree_leaves(got.grads), tree_leaves(want.grads))]
        pairs += [(e.name, tree_leaves(got.ext[e.name]), tree_leaves(want.ext[e.name]))
                  for e in names]
        # Variance = N·Σg² − (Σg)²: its rounding error scales with N·Σg².
        scale = ({"variance": tree_leaves(want.ext["second_moment"])}
                 if "variance" in got.ext else {})
        for key, gs, ws in pairs:
            err = 0.0
            for i, (g, w) in enumerate(zip(gs, ws, strict=True)):
                den = (scale[key][i] if key in scale else w).abs().max().item()
                err = max(err, (g.to(w.device) - w).abs().max().item() / max(den, 1e-30))
            errs[key] = err
        return errs

    def check_errs(label, errs, tol=TOL, **extra):
        say("compare", label=label, tol=tol, rel_err=errs, **extra)
        bad = {k: v for k, v in errs.items() if not v <= tol}
        if bad:
            fail(f"{label}: disagree {bad}")
        return errs

    def compare(label, mdl, prm, xx, yy, names, rng, cfg_k=cfg_fused):
        card = run(mdl, prm, xx, yy, loss, extensions=names, cfg=cfg_k, rng=rng)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        cpu = run(mdl, tree_map(lambda p: p.cpu(), prm), xx.cpu(), yy.cpu(), loss,
                  extensions=names, cfg=cfg_k, rng=rng)
        return check_errs(label, rel_errs(card, cpu, names),
                          cpu_s=time.perf_counter() - t0, batch=xx.shape[0])

    record["compare_c3d3"] = compare("c3d3 card vs cpu", model, params, x, y, exts, draws)

    # -- 6. the per-extension route (use_fused=False), same call, same draws --
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    pe_s = []
    for _ in range(3):
        t0 = time.perf_counter()
        res_pe = run(model, params, x, y, loss, extensions=exts, cfg=cfg_pe, rng=draws)
        torch.cuda.synchronize()
        pe_s.append(time.perf_counter() - t0)
    pe_launches = ops.launch_counts()
    record["per_extension_route"] = dict(
        model="c3d3", batch=N, extensions=len(exts), step_s=pe_s, launches=pe_launches,
        max_memory_allocated=torch.cuda.max_memory_allocated())
    say("per_extension_route", **record["per_extension_route"])
    want = {k: 3 * PER_EXTENSION_LAUNCHES.get(k, 0) for k in ops.KERNELS}
    if pe_launches != want:
        fail(f"the per-extension route launched {pe_launches}, not {want}")
    res_fused = run(model, params, x, y, loss, extensions=exts, cfg=cfg_fused, rng=draws)
    record["compare_routes"] = check_errs("c3d3 per-extension vs fused route (card)",
                                          rel_errs(res_pe, res_fused, exts))
    del res_pe, res_fused
    record["compare_c3d3_per_extension"] = compare(
        "c3d3 per-extension route card vs cpu", model, params, x, y, exts, draws, cfg_pe)
    steps = {"per_extension": [], "fused": []}
    for _ in range(5):
        for route, c in (("per_extension", cfg_pe), ("fused", cfg_fused)):
            t0 = time.perf_counter()
            run(model, params, x, y, loss, extensions=exts, cfg=c, rng=draws)
            torch.cuda.synchronize()
            steps[route].append(time.perf_counter() - t0)
    record["per_extension_steps"] = dict(step_s=steps, median_ms=medians_ms(steps))
    say("per_extension_steps", **record["per_extension_steps"])
    record["profile_per_extension"] = profiled(lambda: run(
        model, params, x, y, loss, extensions=exts, cfg=cfg_pe, rng=draws))
    say("profile_per_extension", **record["profile_per_extension"])

    # -- 7. the paper's curvature-preconditioned training --------------------
    batch = {"inputs": x, "labels": y}
    cpu_params = tree_map(lambda p: p.cpu(), params)
    cpu_batch = {"inputs": x.cpu(), "labels": y.cpu()}
    plain_step = make_train_step(model, loss, sgd(0.1))
    record["train"] = {}
    trained = {}
    for curvature, names, lr, damping in TRAIN:
        opt = curvature_optimizer(lr, damping=damping, curvature=curvature)
        step = make_extended_train_step(model, loss, opt, tuple(by_name(n) for n in names),
                                        track=("variance",))
        p, state, pp = params, opt.init(params), params
        rng = torch.Generator(device="cuda").manual_seed(3)
        losses, means, times = [], [], {"extended": [], "plain": []}
        torch.cuda.synchronize()
        ops.reset_launch_counts()
        for i in range(TRAIN_STEPS):  # the extended and the plain step in turns
            t0 = time.perf_counter()
            p, state, m = step(p, state, batch, i, rng)
            torch.cuda.synchronize()
            times["extended"].append(time.perf_counter() - t0)
            t0 = time.perf_counter()
            pp, _, _ = plain_step(pp, (), batch, i)
            torch.cuda.synchronize()
            times["plain"].append(time.perf_counter() - t0)
            losses.append(m["loss"].item())
            means.append(m["variance_mean"].item() if "variance_mean" in m else None)
        counts = ops.launch_counts()
        trained[curvature] = p
        med = medians_ms({k: v[1:] for k, v in times.items()})  # after the first step
        prof = profiled(lambda: step(p, state, batch, TRAIN_STEPS, rng))
        # One step card against CPU, from the same parameters and draws.
        card_p, _, _ = step(params, opt.init(params), batch, 0, draws)
        cpu_p, _, _ = step(cpu_params, opt.init(cpu_params), cpu_batch, 0, draws)
        param_err = update_err = 0.0
        for c, w, p0 in zip(tree_leaves(card_p), tree_leaves(cpu_p), tree_leaves(cpu_params)):
            diff = (c.cpu() - w).abs().max().item()
            param_err = max(param_err, diff / w.abs().max().item())
            update_err = max(update_err, diff / max((w - p0).abs().max().item(), 1e-30))
        row = dict(curvature=curvature, extensions=names, lr=lr, damping=damping,
                   losses=losses, variance_mean=means, launches=counts, step_s=times,
                   median_ms=med, extended_over_plain=med["extended"] / med["plain"],
                   card_vs_cpu=dict(params_rel_err=param_err, update_rel_err=update_err,
                                    tol=TOL), profile=prof)
        record["train"][curvature] = row
        say("train", **row)
        if not all(math.isfinite(v) for v in losses) or not losses[-1] < losses[0]:
            fail(f"train {curvature}: the loss did not fall: {losses}")
        on = {k for k, v in counts.items() if v}
        if not on or not on <= set(FUSED_KERNELS):
            fail(f"train {curvature}: launched {counts}, not the fused route's kernels")
        if not param_err <= TOL:
            fail(f"train {curvature}: card and CPU parameters differ by {param_err:.3e}")

    record["profile_plain_step"] = profiled(lambda: plain_step(params, (), batch, 0))
    say("profile_plain_step", **record["profile_plain_step"])

    # -- 8. KFRA and DiagHessian on the MLP ----------------------------------
    mlp = papernets.mlp(device="cuda", generator=torch.Generator().manual_seed(2))
    xm = torch.randn(N, 784, device="cuda", generator=gen)
    ym = torch.randint(0, 10, (N,), device="cuda", generator=gen)
    record["compare_mlp"] = compare("mlp kfra+diag_hessian card vs cpu", mlp, mlp.params(),
                                    xm, ym, (by_name("kfra"), by_name("diag_hessian")), None)

    # -- 9. the Gram family and the kernel-space natural gradient -----------
    gram_exts = (NTK, NTKClasswise, GGNGram)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    res_g = run(model, params, x, y, loss, extensions=gram_exts)
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t0
    gram_launches = ops.launch_counts()
    ntk = ntk_total(res_g.ext["ntk"])
    K = gram_total(res_g.ext["ggn_gram"])
    scale = ntk.abs().max().item()
    gram = dict(model="c3d3", batch=N, launches=gram_launches, first_call_s=first_s,
                max_memory_allocated=torch.cuda.max_memory_allocated(),
                shapes=dict(ntk=list(ntk.shape), ntk_classwise=list(
                    ntk_total(res_g.ext["ntk_classwise"]).shape), ggn_gram=list(K.shape)),
                ntk_asymmetry=(ntk - ntk.T).abs().max().item() / scale,
                ggn_gram_asymmetry=(lambda k: (k - k.T).abs().max().item() / k.abs().max().item())(
                    K.permute(0, 2, 1, 3).reshape(10 * N, 10 * N)),
                ntk_min_diagonal=torch.diagonal(ntk).min().item(),
                classwise_sum_err=(ntk_total(res_g.ext["ntk_classwise"]).sum(-1) - ntk)
                .abs().max().item() / scale)
    record["gram"] = gram
    say("gram", **gram)
    if gram_launches != {k: 6 if k == "cross_dot" else 0 for k in ops.KERNELS}:
        fail(f"the gram path must launch cross_dot 6 times and nothing else, got {gram_launches}")
    if gram["shapes"] != dict(ntk=[N, N], ntk_classwise=[N, N, 10], ggn_gram=[N, N, 10, 10]):
        fail(f"gram: wrong shapes {gram['shapes']}")
    if not (torch.isfinite(ntk).all() and torch.isfinite(K).all()):
        fail("gram: non-finite kernel")
    if not (gram["ntk_asymmetry"] == 0.0 and gram["ntk_min_diagonal"] >= 0
            and gram["classwise_sum_err"] <= TOL):
        fail(f"gram: the NTK is not a symmetric PSD-diagonal kernel summing its classes: {gram}")
    record["compare_gram"] = compare("c3d3 gram card vs cpu", model, params, x, y, gram_exts,
                                     None)
    # Kernel-space NGD, damped by the mean eigenvalue of the [N·C, N·C] Gram.
    K2 = K.permute(0, 2, 1, 3).reshape(10 * N, 10 * N)
    damping = torch.diagonal(K2).mean().item()
    ngd_card, _ = kernel_ngd_direction(model, params, x, y, loss, damping=damping)
    ngd_cpu, _ = kernel_ngd_direction(model, cpu_params, x.cpu(), y.cpu(), loss,
                                      damping=damping)
    ngd_err = max((a.cpu() - b).abs().max().item() / b.abs().max().item()
                  for a, b in zip(tree_leaves(ngd_card), tree_leaves(ngd_cpu), strict=True))
    record["compare_ngd"] = check_errs("c3d3 kernel_ngd_direction card vs cpu",
                                       {"direction": ngd_err}, damping=damping)
    steps = {"gram_run": [], "kernel_ngd": []}
    for _ in range(5):
        t0 = time.perf_counter()
        run(model, params, x, y, loss, extensions=gram_exts)
        torch.cuda.synchronize()
        steps["gram_run"].append(time.perf_counter() - t0)
        t0 = time.perf_counter()
        kernel_ngd_direction(model, params, x, y, loss, damping=damping)
        torch.cuda.synchronize()
        steps["kernel_ngd"].append(time.perf_counter() - t0)
    record["gram_steps"] = dict(step_s=steps, median_ms=medians_ms(steps))
    say("gram_steps", **record["gram_steps"])
    record["profile_gram"] = profiled(lambda: run(model, params, x, y, loss,
                                                  extensions=gram_exts))
    say("profile_gram", **record["profile_gram"])
    del res_g, ntk, K, K2

    # -- 10. the Laplace posterior on the parameters the KFAC steps trained --
    map_params = trained["kfac"]
    # The CPU reference fits and predicts in float64 (the MAP, x and x_out
    # cast, the same loss), so the check reads the card's float32 errors and
    # not a second set of the CPU's (PERF.md §6, PR 22).
    cpu_map = tree_map(lambda p: p.cpu().double(), map_params)
    x_out = torch.randn(N, 32, 32, 3, device="cuda", generator=gen)  # held out
    posteriors = (("diag", "diag", False), ("kron", "kron", False),
                  ("last_layer_kron", "kron", True))
    record["laplace"] = {}
    torch.cuda.synchronize()
    ops.reset_launch_counts()
    for label, structure, last in posteriors:
        fit_s, pred_s = [], []
        for _ in range(3):
            t0 = time.perf_counter()
            post = fit_posterior(model, map_params, x, y, loss, structure=structure,
                                 last_layer=last)
            torch.cuda.synchronize()
            fit_s.append(time.perf_counter() - t0)
        for _ in range(3):
            before = ops.launch_counts()["predictive_var"]
            t0 = time.perf_counter()
            mean, var = glm_predictive(model, map_params, post, x_out)
            torch.cuda.synchronize()
            pred_s.append(time.perf_counter() - t0)
            per_call = ops.launch_counts()["predictive_var"] - before
            if per_call != (0 if last else 3):
                fail(f"laplace {label}: glm_predictive launched predictive_var {per_call} times")
        probs = probit_predictive(mean, var)
        cpu_post = fit_posterior(model, cpu_map, x.cpu().double(), y.cpu(), loss,
                                 structure=structure, last_layer=last)
        cpu_mean, cpu_var = glm_predictive(model, cpu_map, cpu_post, x_out.cpu().double())
        ev = log_marglik(post).item()
        t0 = time.perf_counter()
        tuned, mres = optimize_marglik(post, n_steps=100, lr=0.1)
        torch.cuda.synchronize()
        marglik_s = time.perf_counter() - t0
        ev_tuned = log_marglik(tuned).item()
        row = dict(structure=structure, last_layer=last, fit_s=fit_s, predictive_s=pred_s,
                   marglik_s=marglik_s, median_ms=dict(
                       fit=medians_ms({"f": fit_s})["f"], predictive=medians_ms({"p": pred_s})["p"],
                       optimize_marglik_100_steps=marglik_s * 1e3),
                   predictive_var_per_call=per_call, log_marglik=ev,
                   log_marglik_tuned=ev_tuned, prior_prec_tuned=mres.prior_prec,
                   var_range=[var.min().item(), var.max().item()],
                   probit_row_sum_err=(probs.sum(-1) - 1).abs().max().item())
        record["laplace"][label] = row
        say("laplace", **row)
        if not (torch.isfinite(mean).all() and torch.isfinite(var).all() and (var > 0).all()
                and tuple(var.shape) == (N, 10)):
            fail(f"laplace {label}: the predictive is not finite, positive, [N, C]")
        if not row["probit_row_sum_err"] <= 1e-5:
            fail(f"laplace {label}: probit rows do not sum to 1")
        if not (math.isfinite(ev) and ev_tuned > ev):
            fail(f"laplace {label}: evidence {ev} not finite or not raised ({ev_tuned})")
        err = {k: (got.cpu().double() - want).abs().max().item() / want.abs().max().item()
               for k, got, want in (("mean", mean, cpu_mean), ("var", var, cpu_var))}
        record["laplace"][label]["card_vs_cpu"] = check_errs(
            f"laplace {label} card (float32) vs cpu (float64)", err)
    laplace_launches = ops.launch_counts()
    say("laplace_launches", launches=laplace_launches)
    for structure in ("diag", "kron"):  # the full-network predictives, one call each
        post = fit_posterior(model, map_params, x, y, loss, structure=structure)
        prof = profiled(lambda: glm_predictive(model, map_params, post, x_out))
        record[f"profile_laplace_predictive_{structure}"] = prof
        say("profile_laplace_predictive", structure=structure, **prof)

    # -- 11. the serving path: Hymba-1.5B through prefill, generate, decode ----
    record["serve"] = serve_phase(torch, ops)

    # -- 12. the kernel table -------------------------------------------------
    # launches: each kernel's count on its path (the fused main path's three
    # run calls; the per-extension route's three for its own kernels; the
    # gram path's one run call; the Laplace path's diag and kron predictives;
    # the serving path's checked prefill call and its generate call).
    path_launches = dict(launches, per_sample_moment=pe_launches["per_sample_moment"],
                         batch_l2=pe_launches["batch_l2"],
                         cross_dot=gram_launches["cross_dot"],
                         predictive_var=laplace_launches["predictive_var"],
                         flash_attention=record["serve"]["launches"]["flash_attention"],
                         wkv=record["serve"]["launches"]["wkv"])
    table = []
    for k in ops.KERNELS:
        agg = per_kernel[k]
        table.append(dict(
            name=k, route="cuda", source=modules[k].SOURCE, replaces=modules[k].REPLACES,
            launches=path_launches[k], max_abs_err=agg["max_abs_err"],
            max_rel_err=agg["max_rel_err"], ms=agg["ms"],
            plain_ms=agg["plain_ms"], bound_ms=agg["bound_ms"],
            bound_by="operations" if agg["ops_ms"] >= agg["bytes_ms"] else "bytes",
            bound_tf32_ms=agg["bound_tf32_ms"] if k not in ROW_CHECKED else None,
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
