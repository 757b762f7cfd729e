#!/usr/bin/env python3
"""fused_first_order at the language-model head against its formula in
float64, on the LM run's own data.

    python3 tools/lm_head_accuracy.py [--csrc DIR] [--random]

Needs one CUDA card and nvcc.  Builds ``chip_smoke.py``'s ``lm_run``
model (StableLM-2-1.6B at full width, 4 layers, float32, the same seeds),
takes the head's input A [4, 512, 2048] and the loss cotangent B [4, 512,
100352] (softmax − onehot over the 2042 unmasked positions) from one
forward, and reads, as max |got − f64| / max |f64| per output: the kernel's
l2, moment and dot (all three asked, as the first-order sweep asks them:
l2 is then dot's diagonal) and its l2 asked alone; the per-extension route's
kernels (batch_l2, and BatchDot's pairwise form ``per_sample_dots``); the
plain float32 version.  With ``--csrc DIR`` (an older ``csrc/``, e.g. a
parent commit's from ``git archive``) the older build's kernel is read too,
and both builds are timed in turns on random inputs of the same shape
(``chip_smoke.py``'s head row).  ``--random`` also reads all of it on those
random inputs.  One JSON line per data set.
"""
import argparse
import dataclasses
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--csrc", type=Path, help="an older csrc/ to read beside this one")
    parser.add_argument("--random", action="store_true", help="also on random inputs")
    args = parser.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("FAILED: no CUDA card", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    from chip_smoke import LM_RUN
    from repro_torch.configs import get_config
    from repro_torch.core import CrossEntropyLoss
    from repro_torch.core.module import per_sample_dots
    from repro_torch.kernels import _build, ops, ref
    from repro_torch.kernels import fused_first_order as ffo
    from repro_torch.nn.models import build_model

    def load(src, out):
        saved = _build.CSRC, _build.BUILD_DIR
        _build.CSRC, _build.BUILD_DIR = src, out
        ffo._lib.cache_clear()
        try:
            return ffo._lib()
        finally:
            _build.CSRC, _build.BUILD_DIR = saved
            ffo._lib.cache_clear()

    libs = {"this": load(_build.CSRC, _build.BUILD_DIR)}
    if args.csrc is not None:
        libs["older"] = load(args.csrc.resolve(), ROOT / "build" / "against" / "lm_head")
    cached = ffo._lib

    def kernel(which, A, B, **want):
        ffo._lib = lambda: libs[which]
        try:
            return {k: v[0] for k, v in ffo.fused_first_order_cuda(A[None], B[None], **want).items()}
        finally:
            ffo._lib = cached

    def errs(got, exact):
        return {k: ((got[k].double() - exact[k]).abs().max() / exact[k].abs().max()).item()
                for k in got}

    every = dict(want_l2=True, want_moment=True, want_dot=True)

    def read(label, A, B):
        exact = {k: v[0] for k, v in ref.fused_first_order(
            A[None].double(), B[None].double(), **every).items()}
        row = {"data": label}
        for which in libs:
            row[which] = errs(kernel(which, A, B, **every), exact)
            row[f"{which}_l2_alone"] = errs(kernel(which, A, B, want_l2=True), exact)
        row["per_extension"] = errs({"l2": ops.batch_l2(A, B), "dot": per_sample_dots(A, B)},
                                    exact)
        row["plain_float32"] = errs({k: v[0] for k, v in ref.fused_first_order(
            A[None], B[None], **every).items()}, exact)
        del exact
        torch.cuda.empty_cache()
        return row

    print(json.dumps({"device": torch.cuda.get_device_name(0)}), flush=True)
    cfg = dataclasses.replace(get_config(LM_RUN["arch"]), n_layers=LM_RUN["n_layers"],
                              dtype="float32")
    model = build_model(cfg, device="cuda",
                        generator=torch.Generator(device="cuda").manual_seed(1))
    params = model.params()
    gen = torch.Generator(device="cuda").manual_seed(9)  # lm_run_phase's batch
    n, t = LM_RUN["batch"], LM_RUN["seq"]
    toks = torch.randint(0, cfg.vocab, (n, t), device="cuda", generator=gen)
    labels = torch.randint(0, cfg.vocab, (n, t), device="cuda", generator=gen)
    labels.view(-1)[torch.randperm(n * t, device="cuda", generator=gen)[:LM_RUN["masked"]]] = -1
    with torch.no_grad():
        z, tape = model.forward_tape(params, toks)
    A, B = tape[-1].contiguous(), CrossEntropyLoss().grad(z, labels).contiguous()
    del z, tape, model, params
    torch.cuda.empty_cache()
    print(json.dumps(read("lm_run's head", A, B)), flush=True)
    del A, B
    rg = torch.Generator(device="cuda").manual_seed(4)
    A = torch.randn(n, t, cfg.d_model, device="cuda", generator=rg)
    B = torch.randn(n, t, cfg.vocab, device="cuda", generator=rg)
    if args.random:
        print(json.dumps(read("random", A, B)), flush=True)
    if len(libs) > 1:  # times in turns: older, this, this, older
        def ms(which):
            kernel(which, A, B, **every)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(3):
                kernel(which, A, B, **every)
            torch.cuda.synchronize()
            return (time.perf_counter() - t0) / 3 * 1e3

        turns = [(w, ms(w)) for w in ("older", "this", "this", "older")]
        print(json.dumps({"data": "random", "ms_turns": turns}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
