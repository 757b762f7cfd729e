#!/usr/bin/env python3
"""Where a ``remat`` training step's extra time goes: StableLM-2-1.6B at full
width and depth in bf16, 4 × 512 tokens, AdamW through ``fit``, with and
without ``build_model(cfg, remat=True)``.

    python3 tools/remat_step_profile.py [--steps 4] [--layers 24]

Needs one CUDA card and nvcc.  Runs the variants in turns (plain, remat,
remat without the RNG stash, and back in reverse), each from freshly drawn
weights (a generator seeded 0 on the card), as ``chip_smoke.py``'s remat
check does.  Steps 1..n−2 are timed by the host's clock; the last runs under
torch.profiler.  Per variant, one JSON line: the step's wall ms, the device
ms of its kernels (summed, and by group: GEMMs, attention's forward kernel,
attention's plain backward range, the rest), the number of kernel launches
and of ``cudaMalloc`` / ``cudaFree`` calls, the allocator's retries and
device allocations over the profiled step (``torch.cuda.memory_stats``), and
the peak above the start.  "remat_no_rng" passes
``preserve_rng_state=False`` to ``torch.utils.checkpoint.checkpoint`` (the
layers draw no random numbers, so the recompute needs no RNG stash).
"""
import argparse
import dataclasses
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))

STATS = ("num_alloc_retries", "num_device_alloc", "num_device_free",
         "allocation.all.allocated")
# the record_function ranges of kernels/ops.py: listed on the device too, not kernels
RANGES = ("flash_attention_backward", "wkv_backward", "flash_attention_jvp", "wkv_jvp")


def device_us(e):  # the attribute's name changed across PyTorch versions
    return getattr(e, "device_time_total", None) or getattr(e, "cuda_time_total", 0)


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--steps", type=int, default=4)
    parser.add_argument("--layers", type=int, default=None, help="cut the depth (default: all)")
    args = parser.parse_args()
    import torch
    import torch.utils.checkpoint
    from torch.profiler import ProfilerActivity, profile

    if not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
        return 1
    from repro_torch.configs import SHAPES, get_config
    from repro_torch.kernels import _build
    from repro_torch.nn.models import build_model
    from repro_torch.optim import adamw
    from repro_torch.train import loop as loop_mod

    _build.build()
    cfg = get_config("stablelm-1.6b")
    if args.layers:
        cfg = dataclasses.replace(cfg, n_layers=args.layers)
    shape = dataclasses.replace(SHAPES["train_4k"], seq_len=512, global_batch=4)
    checkpoint = torch.utils.checkpoint.checkpoint
    factory = loop_mod.make_train_step
    smi = __import__("subprocess").run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True).stdout.strip()

    def profiled_step(step, out):
        def wrapped(params, opt_state, batch, step_idx, *rest):
            if step_idx != args.steps - 1:
                return step(params, opt_state, batch, step_idx, *rest)
            torch.cuda.synchronize()
            before = torch.cuda.memory_stats()
            with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                t0 = time.perf_counter()
                res = step(params, opt_state, batch, step_idx, *rest)
                torch.cuda.synchronize()
                out["wall_ms"] = (time.perf_counter() - t0) * 1e3
            after = torch.cuda.memory_stats()
            out["allocator"] = {k: after.get(k, 0) - before.get(k, 0) for k in STATS}
            events = prof.key_averages()
            kernels = [e for e in events if device_us(e) > 0
                       and e.device_type == torch.autograd.DeviceType.CUDA
                       and not e.key.startswith(("Memcpy", "Memset"))
                       and e.key not in RANGES]
            total = sum(device_us(e) for e in kernels) / 1e3
            gemm = sum(device_us(e) for e in kernels
                       if any(t in e.key for t in ("gemm", "Gemm", "nvjet"))) / 1e3
            fwd = sum(device_us(e) for e in kernels if "flash_" in e.key) / 1e3
            bwd = sum(device_us(e) for e in events if e.key == "flash_attention_backward"
                      and e.device_type == torch.autograd.DeviceType.CPU) / 1e3
            host = {e.key: e.count for e in events
                    if e.key in ("cudaMalloc", "cudaFree", "cudaLaunchKernel",
                                 "cuLaunchKernel", "cudaMemcpyAsync", "cudaStreamSynchronize",
                                 "cudaDeviceSynchronize")}
            out.update(device_ms=total, gemm_ms=gemm, attention_forward_ms=fwd,
                       attention_backward_ms=bwd, rest_ms=total - gemm - fwd - bwd,
                       kernel_launches=sum(e.count for e in kernels), host_calls=host,
                       idle_share=1 - total / out["wall_ms"],
                       top=[dict(name=e.key[:70], ms=device_us(e) / 1e3, calls=e.count)
                            for e in sorted(kernels, key=lambda e: -device_us(e))[:6]])
            return res
        return wrapped

    for name in ("plain", "remat", "remat_no_rng", "remat_no_rng", "remat", "plain"):
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        if name == "remat_no_rng":
            torch.utils.checkpoint.checkpoint = lambda *a, **k: checkpoint(
                *a, preserve_rng_state=False, **k)
        out = {}
        loop_mod.make_train_step = lambda *a, **k: profiled_step(factory(*a, **k), out)
        try:
            model = build_model(cfg, remat=name != "plain", device="cuda",
                                generator=torch.Generator(device="cuda").manual_seed(0))
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            base = torch.cuda.memory_allocated()
            _, _, hist, _ = loop_mod.fit(model, cfg, shape, adamw(1e-3),
                                         loop_mod.LoopConfig(steps=args.steps, log_every=100),
                                         log_fn=lambda *_: None)
            peak = torch.cuda.max_memory_allocated() - base
        finally:
            torch.utils.checkpoint.checkpoint = checkpoint
            loop_mod.make_train_step = factory
        del model
        print(json.dumps(dict(variant=name, layers=cfg.n_layers, losses=[h["loss"] for h in hist],
                              step_ms=[h["dur_s"] * 1e3 for h in hist],
                              peak_bytes_above_start=peak, card=smi, **out)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
