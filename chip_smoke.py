#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA card (written for the H100).

    python3 chip_smoke.py

Builds the ten Hopper kernels from ``src/repro_torch/kernels/csrc`` (one
nvcc per source, all at once) and holds each against its plain PyTorch
version at the shapes its path gives it: BackPACK's on 3C3D at batch 128,
Hymba-1.5B's and StableLM-2-1.6B's serving shapes for flash_attention and
wkv, the LM run's shapes for fused_first_order, fused_second_order and
flash_attention, whisper-tiny's (non-causal attention over 1500 frames,
cross-attention of 448 queries against them, its head and encoder
feed-forward), Granite-3.0-1B-A400M's (GQA attention at 16 over 8 heads,
fused_first_order with its 32 experts as the group axis at R = 1, and
every Dense shape of its BackPACK sweep: q, k, v, o, the router and the
head) and DeepSeek-V2-Lite's (MLA attention at q, k 192 and v 128, its 64
experts at R = 1, every Dense shape of its sweep).  Then it drives sixteen
paths through the entry points a user calls, seven on 3C3D (CIFAR-10
shapes, full width, random weights from a seed), five on language models,
one on the encoder-decoder, two on the mixtures of experts and one through
the observability layer, each with the launch counts set to 0 just before
and read just after:

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
* the accumulated lane (``accumulated_phase``): ``plan_for_batch`` with a
  ``microbatch_size`` on the main path's ten extensions at n = 450 in four
  slices (fused_first_order 12, fused_second_order 24, sq_matmul 36 and,
  in the six pair passes, cross_dot 18 on two row sets, nothing else)
  against the monolithic ``run`` at n = 450, BatchDot symmetric bit for
  bit, its peak memory below the monolithic call's; the Gram family at
  n = 256 in two slices (cross_dot 12 on one row set, 6 on two) against the
  monolithic Gram ``run``; the main path checkpointed, killed before work
  unit 5 and resumed to the uninterrupted run's bits; both calls timed in
  turns and profiled;
* the matrix-free lane (``matfree_phase``): ``ggn_vp`` / ``hvp`` card
  against CPU, symmetric, against the fused route's DiagGGN coordinate by
  coordinate and streamed in slices of 113; five ``make_cg_ngd_step`` steps
  with CG (no kernel) and with the Gram solve (cross_dot 3 a step), the loss
  falling and each step's first update card (float32) against the CPU in
  float64; ``log_marglik_matfree`` by SLQ; the NTK consumers ``gp_predict``
  (three solvers that agree; in two slices, cross_dot 6 on one row set and
  3 on two, against the monolithic call), ``influence_scores`` /
  ``self_influence`` card against CPU and ``select_subset`` (the same picks
  in two slices; rows whose ReLU or max-pool pattern flips in a slice are
  named and left out of the kernel's comparison); each call timed,
  profiled (device activity) and its launches asserted, cross_dot held
  against its plain version at each of the phase's shapes in the kernel
  table; the ``ntk_apps`` launcher exits 0;
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
  one profiled, from a 32-token cache and at a long context (on a model cut
  to 4 layers, global, two windowed, global: 16 steps after a 1500-token
  prefill into caches of 2048, ``serve_decode_long``: wall and device ms,
  idle share, attention's device ms); the serve_step chain over
  1040 tokens of a float32 model cut to 4 layers (global, two windowed,
  global) matches its full forward (the window-1024 rings wrap, limit 1e-3)
  and a float32 copy of the full model matches the CPU (batch 1, T 64,
  limit 1e-4); and
  ``python -m repro_torch.launch.serve --arch hymba-1.5b --full`` exits 0;
* the dense serving path (``serve_phase`` with ``SERVE_DENSE``): the same on
  StableLM-2-1.6B at full width and depth (24 layers of MHA, 32 heads of 64,
  LayerNorm, RoPE on 16 of 64 dims, qkv biases), flash_attention 24 times a
  prefill call and a serve_step and nothing else, its float32 chain over 96
  tokens (no window: nothing wraps);
* the other dense configs' heads (``dense_heads_phase``): CodeQwen1.5-7B
  (dh 128), Gemma-3-12B (dh 240, one 5 : 1 pattern), H2O-Danube3-4B (dh
  120, window 8192) and InternVL2-2B (a 256-row image prefix) at full width
  and cut depth, one bf16 prefill call on "wgmma" and greedy decode
  (flash_attention once a layer a call), card against CPU and the decode
  chain against the forward in float32;
* BackPACK on a language model (``lm_run_phase``): ``run`` on StableLM-2 at
  full width with 4 of its 24 layers, float32, 4 × 512 tokens, the
  first-order extensions and DiagGGN-MC at the full vocabulary
  (fused_first_order and fused_second_order 7 a layer plus the head,
  flash_attention once a layer, nothing else), the gradient against
  autograd, Σ_n batch_grad against it, the per-extension route against the
  fused one, KFAC with DiagGGN-MC at a vocabulary of 8192, the reduced
  StableLM-2 and Gemma-3 card against CPU with the MC draws passed in;
  timed and profiled (device time by BackPACK kernels, attention's forward,
  GEMMs, attention's backward in plain torch and the rest);
* training language models (``train_lm_phase``): the training launcher
  ``python -m repro_torch.launch.train --arch stablelm-1.6b --full`` in bf16
  at 4 × 512 tokens with AdamW and with DiagGGN-MC + ``--track-variance``
  (the last step lowers the loss of its own batch, read with the weights
  before and after it; the share of each parameter's entries it moved
  printed; flash_attention 24 a step, fused_first_order and
  fused_second_order 169 a step with the MC sweep; steps timed, one
  profiled, the peak above the start); ``remat`` (the same losses, the
  gradient pass's peak lower, flash_attention 48 a step); ``cg_ngd`` at full
  width with 4 layers in float32 (flash_attention through ``torch.func``'s
  jvp and vjp, 4 + 8 · 11 a step; the GGN symmetric on two random
  directions); KFAC at full depth with the vocabulary cut to 8192; one
  ``fit`` step of each optimizer and ``ggn_vp`` / ``hvp`` card against CPU on
  the reduced config; a restart repeating the uninterrupted losses bit for
  bit; ``launch.serve --full --uncertainty``; and the examples
  ``curvature_training`` (98M parameters), ``noise_scale`` and
  ``laplace_uncertainty``;
* Whisper (``whisper_phase``): whisper-tiny at full width and depth, 4 ×
  1500 frames; ``encode`` (flash_attention 4) and greedy
  ``generate_whisper`` over the 448 decoder positions (8 a serve_step) in
  bf16, decode timed and profiled at positions 32 and 447, a float32
  chain over the 448 positions against the forward, card against CPU, the
  serving launcher; BackPACK ``run`` in float32 (fused_first_order and
  fused_second_order once a Dense layer of the tree, 65; flash_attention
  12) against autograd, KFAC at a vocabulary of 8192, the reduced config
  card against CPU; the training launcher with AdamW and DiagGGN-MC; the
  serving example (StableLM-2, RWKV6 and Whisper reduced);
* the mixture of experts (``moe_phase``): Granite-3.0-1B-A400M at full
  width and depth in bf16, a prefill call of 4 × 2048 tokens
  (flash_attention 24, the pairs each layer drops at capacity 2560 printed),
  greedy ``generate`` from 4 × 32 to 128, decode timed and profiled at 32
  cached tokens; in float32 at capacity factor E / top_k (nothing dropped,
  asserted) the 64-token chain against the forward and 2 layers card
  against CPU; BackPACK ``run`` in float32 on 4 layers at 4 × 512
  (fused_first_order 33, 12 of them over the 32 experts; fused_second_order
  21; flash_attention 4) against autograd, BatchL2, BatchDot and
  SecondMoment off the experts against float64 of batch_grad, the experts'
  moments against float64; the reduced config card against CPU; the
  training launcher with AdamW and DiagGGN-MC + Variance;
* MLA with routed and shared experts (``mla_phase``): DeepSeek-V2-Lite at
  full width and depth in bf16, a prefill call of 4 × 2048 tokens
  (flash_attention 27, the pairs each layer drops at capacity 960
  printed), greedy ``generate`` from 4 × 32 to 128 and decode at 32 cached
  tokens (no kernel a serve_step: the absorbed decode over the compressed
  cache is float32 einsums), decode at 1500 cached tokens on 4 layers; in
  float32 at capacity factor E / top_k the absorbed 64-token chain on 4
  layers against the unabsorbed forward and 2 layers card against CPU;
  BackPACK ``run`` in float32 on 2 layers at 4 × 512 (fused_first_order
  25, 6 of them over the 64 experts; fused_second_order 19;
  flash_attention 2) with the same checks as Granite's; training through
  ``fit`` in bf16 at full width on 4 layers with AdamW and DiagGGN-MC +
  Variance, KFAC refused, and the training launcher on the reduced config;
* the observability layer (``obs_phase``): 3C3D's fused and per-extension
  ``SweepPlan.run`` with ``repro_torch.obs`` off and on (results bit for
  bit, ``kernel.calls.*`` equal to the launches and to the route's counts,
  the span tree printed, the cost timed in turns); the training launcher
  with ``--trace-jsonl``, ``--metrics-report`` and ``--profile-dir`` on
  StableLM-2-1.6B at full size, DiagGGN-MC + Variance, 3 steps (the Chrome
  trace holding fused_first_order's, fused_second_order's and
  flash_attention's kernels by symbol and the ``train/step`` ranges; the
  steps against the same 3 without the flags); Hymba-1.5B's ``generate``
  under a registry (its spans, ``serve.tokens``, wkv's and flash_attention's
  counters against the launches); the ``ntk_apps`` launcher's GP with
  ``--trace-jsonl`` (cross_dot).

Every card-against-CPU ``run`` check (``card_vs_cpu``) names the samples
whose ReLU signs or max-pool picks a card and a CPU forward decide
differently (a pre-activation within rounding of 0, a window whose two
largest inputs tie within rounding: ``flipped``, ``[]`` when none), holds
the per-sample outputs over the other samples, and the batch-summed ones
from ``run`` on the card and the CPU over the sub-batch without them, which
must itself flip nothing; any other difference fails at ``TOL``.

The two kernels with a library counterpart (sq_matmul: ``torch.matmul`` of
the squares; flash_attention: SDPA), and fused_first_order's expert rows
(``torch.bmm`` of the squares), are timed in turns with it (kernel,
library, library, kernel); they and wkv get their device time a call from
a profiler window, taken after every row's event times so that no event
time follows a profiler window; flash_attention's rows name the design
that ran (``flash_attention.design``: "split" for decode, T·g < 64, with its
split count and scratch bytes; "wgmma" for bf16 prefill and the training
launcher's forward at (dh, dv) ∈
{(64, 64), (128, 128), (192, 128)} and at the other configs' wider heads,
(120, 120) and (240, 240); "simt" else: float32), and their device time's
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
T_START = time.perf_counter()  # every printed line carries its seconds since (``at_s``)
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
# the window-1024 rings wrap, at 4 layers (global, two windowed, global):
# at 32 it took ≈ 1 min of the script.  The long-context decode is timed after
# 1500 tokens fed a serve_step each (the rings wrap; the decode rows of the
# kernel table sit at the same position), at ``long_cut``'s depth: the two
# fills at full depth took 232.7–305.6 s of calls of 891.6–1074.2 s
# against the script's limit of 1200 (H100 80GB HBM3, 700.00 W).
SERVE = dict(arch="hymba-1.5b", batch=4, prefill_len=2048, prompt_len=32, max_len=128,
             chain_len=1040, cpu_len=64, layers=32, global_layers=3, window=1024,
             long_pos=1500, long_max_len=2048, kernels=("flash_attention", "wkv"),
             chain_cut=dict(n_layers=4, window_segments=[(None, 1), (1024, 2), (None, 1)]),
             long_cut=dict(n_layers=4, window_segments=[(None, 1), (1024, 2), (None, 1)]))
# decode chain vs full forward, float32 weights: here Hymba's 4-layer cut and the
# dense chains; Hymba's 32 layers in test_card_hymba_full_depth_chain
# (tests/test_torch_card.py, gpu-marked)
CHAIN_TOL = 1e-3
# The dense serving path: StableLM-2-1.6B at full width and depth (24 layers of
# MHA, 32 heads of 64, LayerNorm, RoPE on 16 of 64 dims, qkv biases), the same
# prompts and lengths as Hymba's; its float32 chain needs no ring wrap (no
# window), so it runs 96 tokens.
SERVE_DENSE = dict(arch="stablelm-1.6b", batch=4, prefill_len=2048, prompt_len=32, max_len=128,
                   chain_len=96, cpu_len=64, layers=24, global_layers=24, window=None,
                   long_pos=1500, long_max_len=2048, kernels=("flash_attention",),
                   long_cut=dict(n_layers=4))
# The other dense configs at full width, cut in depth (the cut named in each
# line): one bf16 prefill call of 2 × 1024 tokens, greedy decode of 4 tokens
# after a 16-token prompt, and in float32 the card against the CPU at batch 1,
# T 64, and a 64-token decode chain against the forward.  Weights are drawn on
# the card (gemma3's 3.3 billion at 6 layers would take the CPU tens of
# seconds).
DENSE_HEADS = {
    "codeqwen1.5-7b": dict(n_layers=2),
    "gemma3-12b": dict(n_layers=6, pattern_repeat=1),
    "h2o-danube-3-4b": dict(n_layers=2, window_segments=[(8192, 2)]),
    "internvl2-2b": dict(n_layers=2),
}
DENSE_HEADS_RUN = dict(batch=2, prefill_len=1024, prompt_len=16, max_len=20, cpu_len=64,
                       chain_len=64)
# BackPACK on a language model: StableLM-2 at full width with 4 of its 24
# layers, float32, N = 4 sequences of 512 tokens, 6 labels masked; the
# first-order sweep and DiagGGN-MC at the full vocabulary, then KFAC with
# DiagGGN-MC with the vocabulary cut to 8192 (the head's KFAC B factor alone
# would be 100352² × 4 B = 40.3 GB at the full one).
LM_RUN = dict(arch="stablelm-1.6b", n_layers=4, batch=4, seq=512, masked=6,
              kfac_vocab=8192, cpu_batch=2, cpu_seq=32)
LM_FIRST = ("batch_grad", "batch_l2", "second_moment", "variance", "batch_dot")
# Training language models (train_lm_phase): the launcher on StableLM-2 at full
# width and depth in bf16, 4 × 512 tokens (AdamW 6 steps, DiagGGN-MC with
# Variance 4); remat the same plain step; cg_ngd at 4 layers in float32, 3
# steps of 10 CG iterations (the launcher's lr and damping); KFAC at full depth
# with the vocabulary cut to 8192 (the head's B would be 100352² × 4 B = 40.3
# GB, with a 100352² inverse); the reduced config card vs CPU at 2 × 32; the
# restart at 2 × 32 over 6 steps, failing at step 3; the examples'
# curvature_training at 10 steps of 8 × 64.
TRAIN_LM = dict(arch="stablelm-1.6b", seq=512, batch=4, adamw_steps=6, mc_steps=4,
                cg_layers=4, cg_steps=3, cg_iters=10, cg_lr=0.3, cg_damping=0.1,
                kfac_vocab=8192, kfac_steps=3, cpu_batch=2, cpu_seq=32, restart_steps=6,
                restart_fail=3, example_steps=10, example_seq=64, example_batch=8)

# Whisper (whisper_phase): whisper-tiny at full width and depth (4 encoder and 4
# decoder layers of d 384, 6 heads of 64, vocabulary 51865, 448 decoder
# positions), 4 sets of 1500 frames (30 s of audio each).  Serving in bf16:
# encode, greedy generate_whisper over the 448 positions, 8 decode steps timed
# from positions 32 and 439 (the step after each profiled); a float32 copy's
# serve_step chain over the 448 positions against the forward, and the card
# against the CPU at 1 × 64 frames and 16 tokens.  BackPACK run in float32 at
# 4 × 1500 frames and 448 tokens, 6 labels masked (first-order + DiagGGN-MC at
# the full vocabulary; KFAC with DiagGGN-MC at the vocabulary cut to 8192: the
# head's B factor alone would be 51865² × 4 B = 10.8 GB, with its inverse); the
# reduced config card vs CPU at 2 × 16 frames.  The training launcher in bf16,
# AdamW 4 steps and DiagGGN-MC with Variance 3.
WHISPER = dict(arch="whisper-tiny", batch=4, frames=1500, masked=6, decode_at=(32, 439),
               decode_steps=8, cpu_frames=64, cpu_tokens=16, kfac_vocab=8192, cpu_batch=2,
               cpu_seq=16, adamw_steps=4, mc_steps=3)

# The mixture of experts (moe_phase): Granite-3.0-1B-A400M at full width and
# depth (24 layers of d 1024, 16 query heads over 8 KV heads of 64, 32 experts
# of 512, top-8, capacity factor 1.25, vocabulary 49155; bf16), weights drawn
# on the card.  Serving: a prefill call of 4 × 2048 tokens (capacity 2560 an
# expert), greedy generate from 4 prompts of 32 tokens to 128, 16 decode steps
# timed at 32 cached tokens (4 tokens a step: capacity 4, nothing dropped).
# The float32 decode chain over 64 tokens against the forward runs at capacity
# factor E / top_k = 4, where an expert's capacity (64) is the forward's token
# count, so the forward drops nothing and the chain has a reference: at 1.25
# the reference's capacity semantics drop tokens in the forward that a decode
# step never drops.  The card against the CPU on 2 of the 24 layers, 1 × 64.
# BackPACK run in float32 on 4 of the 24 layers, 4 × 512 tokens (capacity 640),
# the first-order extensions and DiagGGN-MC; the reduced config card vs CPU at
# 2 × 16.  The training launcher in bf16 at 4 × 512, AdamW 6 steps and
# DiagGGN-MC with Variance 4.
MOE = dict(arch="granite-moe-1b-a400m", batch=4, prefill_len=2048, prompt_len=32, max_len=128,
           decode_steps=16, chain_len=64, cpu_layers=2, run_layers=4, seq=512, masked=6,
           cpu_batch=2, cpu_seq=16, adamw_steps=6, mc_steps=4, seed=17)
# The MLA mixture of experts: DeepSeek-V2-Lite-16B (arXiv:2405.04434; 27
# layers, d 2048, 16 heads, kv_lora 512, qk 128 + 64 RoPE, v 128, 64 experts
# of 1408 top-6 and 2 shared, vocabulary 102400) at full width, weights drawn
# on the card.  Serving in bf16 at full depth (≈ 32.4 GB of weights): a
# prefill call of 4 × 2048 tokens (capacity 960 an expert), greedy generate
# from 4 prompts of 32 tokens to 128, 16 decode steps timed at 32 cached
# tokens, and 16 at 1500 cached tokens on 4 of the 27 layers over a
# compressed cache written directly (random ckv / kpe at positions 0..1499 of
# 2048), not filled token by token.  In float32 at capacity factor E / top_k
# (the forward drops nothing): the absorbed chain over 64 tokens on 4 layers
# against the unabsorbed forward, 2 layers card against CPU at 1 × 64.  The
# BackPACK run in float32 on 2 layers at 4 × 512 (capacity 240): its result
# holds 4 float32 copies of the parameters beside the weights (gradient,
# SecondMoment, Variance, DiagGGN-MC) and BatchGrad ×4 of those off the
# experts.  Training in bf16 through ``fit`` on 4 layers: full depth does
# not fit (AdamW's float32 moments alone are 8 B × 16.2B ≈ 130 GB).  The
# training launcher on the reduced config.
MLA = dict(arch="deepseek-v2-lite-16b", batch=4, prefill_len=2048, prompt_len=32, max_len=128,
           decode_steps=16, long_cached=1500, long_len=2048, long_layers=4, chain_len=64,
           chain_layers=4, cpu_layers=2, run_layers=2, seq=512, masked=6, cpu_batch=2,
           cpu_seq=16, train_layers=4, adamw_steps=6, mc_steps=4, launcher_seq=16,
           launcher_batch=2, launcher_steps=3, seed=19)

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
# The accumulated lane: the main path's ten extensions at n = 450 in slices of
# at most 113 (k = 4: three of 113 and a tail of 111, then 3 + 3 pair
# passes), the Gram family at n = 256 in two slices of 128 (one pair pass),
# and the interrupt before work unit 5 (four slices and one pair pass done).
ACC = dict(n=450, microbatch=113, slices=4, pairs=6, gram_n=256, gram_microbatch=128,
           fail_at=5)
# Its launches: each slice runs the fused main path (per slice 3 conv ×
# fused_first_order; 3 conv × 2 sweeps × fused_second_order; 3 dense × the
# moment and both diagonals in sq_matmul), each pair pass BatchDot alone:
# its cross block through cross_dot on two row sets at the 3 conv layers (the
# dense layers take the rank-1 closed form), nothing else.
ACC_LAUNCHES = {"fused_first_order": 3 * 4, "fused_second_order": 6 * 4, "sq_matmul": 9 * 4,
                "cross_dot": 3 * 6}
# The Gram family in two slices: per slice the NTK pair (one jac sweep) and
# GGNGram at 3 conv layers on one row set, per pair pass the same on two.
ACC_GRAM_ROW_SETS = {"one": 2 * 3 * 2, "two": 1 * 3 * 2}
# The matrix-free lane (matfree_phase) on 3C3D at batch 128: the streamed
# product's slice; five NGD steps a solver (CG 10 iterations, tol 0 so the
# card and the CPU run as many; damping 10 against the GGN's top
# eigenvalues of ≈ 100 at these weights, where lr 1 lowers the loss at every
# step on a CPU batch of the same shape); SLQ with 4
# probes of 20 Lanczos iterations; the float64 checks (the NGD steps' first
# updates, SLQ) on the batch's first 16 rows, so the CPU's float64 side
# stays short; the GP's 32 test rows and its Lanczos solver (rank 8, CG to
# 1e-5 or 200 iterations); influence on 16 training and 8 test rows, 20 CG
# iterations; subsets of 8 (BAIT's λ 1, about the Gram's mean diagonal).
MATFREE = dict(microbatch=113, steps=5, cg_iters=10, ngd_cg_tol=0.0, lr=1.0, damping=10.0,
               prior_prec=1.0, probes=4, slq_iters=20, check_rows=16, gp_test=32, rank=8,
               cg_tol=1e-5, cg_maxiter=200, influence_train=16, influence_test=8,
               influence_iters=20, select_k=8, bait_lam=1.0)
# cross_dot launches by row sets: a Gram sweep (NTK or GGNGram) launches once
# a conv layer (3), on one row set; in two slices (microbatches=2: 2 slices
# and 1 pair pass) 2 × 3 on one and the pair pass's 3 on two.  The 'kernel'
# NGD step runs one GGNGram sweep a step (3).
GRAM_ONE = {"one": 3, "two": 0}
GRAM_TWO_SLICES = {"one": 6, "two": 3}
# The cross-check's DiagGGN run: the exact sweep at 3 conv layers
# (fused_second_order) and at 3 dense layers (sq_matmul), nothing else.
DIAG_LAUNCHES = {"fused_second_order": 3, "sq_matmul": 3}
# The card's float32 against the CPU in float64 (the NGD steps' first
# updates): within F64_FACTOR of the CPU's own float32-against-float64 reading
# of the call (and no less than 1e-6, a few float32 steps).
F64_FACTOR = 10
# SLQ's card float32 against the CPU's float64: a fixed limit, 5× the card's
# reading of 4.0e-4 (H100).  Not F64_FACTOR's rule: the CPU's float32 reads
# 1.3e-2 to 4e-2 by its thread count, its sums over the P = 1.35M entries of
# the Lanczos dot and norm rounding in another order, and the quadrature
# P·Σ τ² log λ multiplies their error by P (tools/slq_reductions.py).
SLQ_F64_TOL = 2e-3
# (curvature, extensions, lr, damping): ten steps on one fixed batch
# reduce the loss with these (chosen on the CPU at the same size).
TRAIN = (("kfac", ("kfac",), 0.2, 0.1),
         ("diag_ggn_mc", ("diag_ggn_mc", "variance"), 0.05, 1.0))


def say(tag, **kw):
    kw["at_s"] = time.perf_counter() - T_START
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


def rel_errs(got, want, names, keep=None, kinds=None):
    """max |got − want| / max |want| per output of two ``run`` Results
    (``want`` may lie on the CPU).  ``keep`` (sample indices) restricts the
    per-sample outputs to those rows and the pairwise ones to those rows and
    columns; ``kinds`` reads only outputs of those kinds (``output_kinds``)."""
    from repro_torch.core.tree import tree_leaves

    kind = output_kinds(names)
    pairs = [("loss", [got.loss], [want.loss]), ("logits", [got.logits], [want.logits]),
             ("grads", tree_leaves(got.grads), tree_leaves(want.grads))]
    pairs += [(e.name, tree_leaves(got.ext[e.name]), tree_leaves(want.ext[e.name]))
              for e in names]
    # Variance = N·Σg² − (Σg)²: its rounding error scales with N·Σg².
    scale = ({"variance": tree_leaves(want.ext["second_moment"])}
             if "variance" in got.ext else {})
    errs = {}
    for key, gs, ws in pairs:
        if kinds is not None and kind[key] not in kinds:
            continue
        err = 0.0
        for i, (g, w) in enumerate(zip(gs, ws, strict=True)):
            g = g.to(w.device)
            den = scale[key][i] if key in scale else w
            if keep is not None and kind[key] != "batch":
                rows = keep.to(w.device)
                g, w, den = g[rows], w[rows], den[rows]
                if kind[key] == "pairs":
                    g, w, den = g[:, rows], w[:, rows], den[:, rows]
            err = max(err, (g - w).abs().max().item() / max(den.abs().max().item(), 1e-30))
        errs[key] = err
    return errs


def output_kinds(names):
    """Each output of a ``run`` with these extensions: ``"rows"`` (a leading
    per-sample axis: the logits, BatchGrad, BatchL2, per-sample traces),
    ``"pairs"`` ([N, N, ...]: BatchDot, the Gram family) or ``"batch"``
    (summed over the batch: the loss, the gradient, the moments, diagonals
    and Kronecker factors), by each extension's reducer."""
    from repro_torch.core.extensions import reduce_spec

    kinds = {"loss": "batch", "logits": "rows", "grads": "batch"}
    for name, red in reduce_spec(names).items():
        kinds[name] = "pairs" if red.pairwise else "rows" if red.streams_rows else "batch"
    return kinds


def forward_pattern(model, params, x):
    """Each sample's ReLU signs and max-pool picks in a forward of ``x``:
    ``[(layer, kind, [N, ...] tensor)]``, the choices that rounding can tip
    one way on the card and the other on the CPU (a pre-activation within
    rounding of 0; a window whose two largest inputs tie within rounding)."""
    from repro_torch.core import Activation
    from repro_torch.nn.layers import MaxPool2d

    _, tapes = model.forward_tape(params, x)
    out = []
    for i, (mod, tape) in enumerate(zip(model.mods, tapes, strict=True)):
        if isinstance(mod, MaxPool2d):
            out.append((i, "max_pool", tape[1]))  # [N, C, H', W']: the window's pick
        elif isinstance(mod, Activation) and mod.name == "relu":
            out.append((i, "relu", tape > 0))
    return out


def flipped_windows(torch, model, params, cpu_params, x):
    """The max-pool windows and ReLU units that a card forward of ``x`` and a
    CPU forward of it decide differently: ``[dict(sample, layer, kind,
    at)]``, ``at`` the window's [channel, row, column] (a ReLU: its unit's
    index within the sample)."""
    with torch.no_grad():
        card = forward_pattern(model, params, x)
        cpu = forward_pattern(model, cpu_params, x.cpu())
    flips = []
    for (layer, kind, a), (_, _, b) in zip(card, cpu, strict=True):
        for idx in (a.cpu() != b).nonzero().tolist():
            flips.append(dict(sample=idx[0], layer=layer, kind=kind, at=idx[1:]))
    return flips


def card_vs_cpu(torch, run, model, params, x, y, loss, names, rng, cfg, tol=TOL):
    """One ``run`` on the card against the same call on the CPU, with the
    rule for what rounding may tip (the matrix-free phase's for its slices):

    * the samples whose ReLU signs or max-pool picks differ between a card
      and a CPU forward (``flipped_windows``) are named;
    * per-sample outputs (logits, BatchGrad, BatchL2, per-sample traces; the
      rows and columns of BatchDot and the Gram family) are compared over the
      other samples;
    * batch-summed outputs over the whole batch when nothing flips, else
      from ``run`` on the card and on the CPU over the sub-batch without the
      flipped samples (the MC draws' columns taken with them), which must
      itself flip nothing.

    Returns the compare line's fields: ``rel_err`` (per output), ``flipped``,
    ``sub_batch`` (its rows, or None), ``reflipped`` (the sub-batch's flips)
    and ``bad`` (the outputs above ``tol``)."""
    from repro_torch.core.tree import tree_map

    cpu_params = tree_map(lambda p: p.cpu(), params)
    flips = flipped_windows(torch, model, params, cpu_params, x)

    def both(xx, yy, draws):
        card = run(model, params, xx, yy, loss, extensions=names, cfg=cfg, rng=draws)
        torch.cuda.synchronize()
        cpu = run(model, cpu_params, xx.cpu(), yy.cpu(), loss, extensions=names, cfg=cfg,
                  rng=draws)
        return card, cpu

    t0 = time.perf_counter()
    card, cpu = both(x, y, rng)
    out = dict(cpu_s=time.perf_counter() - t0, batch=x.shape[0], flipped=flips, sub_batch=None,
               reflipped=[])
    bad_samples = sorted({f["sample"] for f in flips})
    if not bad_samples:
        out["rel_err"] = rel_errs(card, cpu, names)
    else:
        keep = torch.tensor([i for i in range(x.shape[0]) if i not in bad_samples])
        out["rel_err"] = rel_errs(card, cpu, names, keep=keep, kinds=("rows", "pairs"))
        del card, cpu
        xs, ys = x[keep.to(x.device)], y[keep.to(y.device)]
        out["sub_batch"] = len(keep)
        out["reflipped"] = flipped_windows(torch, model, params, cpu_params, xs)
        draws = rng[:, keep.to(rng.device)] if isinstance(rng, torch.Tensor) else rng
        card, cpu = both(xs, ys, draws)
        out["rel_err"].update(rel_errs(card, cpu, names, kinds=("batch",)))
    out["bad"] = {k: v for k, v in out["rel_err"].items() if not v <= tol}
    return out


def check_errs(label, errs, tol=TOL, **extra):
    say("compare", label=label, tol=tol, rel_err=errs, **extra)
    bad = {k: v for k, v in errs.items() if not v <= tol}
    if bad:
        fail(f"{label}: disagree {bad}")
    return errs


def medians_ms(samples):
    return {k: sorted(v)[len(v) // 2] * 1e3 for k, v in samples.items()}


def profiled(call, groups=None, host_ops=True, ranges=None):
    """One call under torch.profiler: wall ms, summed device kernel ms, the
    top kernels by device time, for each ``groups`` label the device ms
    of the kernels whose name holds its text (or one of its texts), and for
    each ``ranges`` label the device ms of the kernels launched inside the
    ``record_function`` range of that name.  ``host_ops=False`` records
    the device's activity only: the figures read only kernels, and a call of
    tens of thousands of small operators (SLQ, CG) takes minutes to
    summarize with the host's recorded too."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    if torch.autograd._profiler_enabled():
        fail("profiled: another torch.profiler window (an obs.profile?) is open: "
             "windows cannot nest")
    activities = [ProfilerActivity.CUDA] + ([ProfilerActivity.CPU] if host_ops else [])
    with profile(activities=activities) as prof:
        t0 = time.perf_counter()
        call()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0

    events = kernel_events(torch, prof)
    top = sorted(events, key=lambda e: -device_us(e))[:12]
    out = dict(wall_ms=wall * 1e3, device_ms=sum(device_us(e) for e in events) / 1e3,
               top=[dict(name=e.key[:80], ms=device_us(e) / 1e3, calls=e.count)
                    for e in top])
    for label, texts in (groups or {}).items():
        texts = (texts,) if isinstance(texts, str) else texts
        out[f"{label}_device_ms"] = sum(device_us(e) for e in events
                                        if any(t in e.key for t in texts)) / 1e3
    for label, name in (ranges or {}).items():  # the host-side range: its kernels' sum
        out[f"{label}_device_ms"] = sum(
            device_us(e) for e in prof.key_averages()
            if e.key == name and e.device_type == torch.autograd.DeviceType.CPU) / 1e3
    return out


def device_us(e):  # the attribute's name changed across PyTorch versions
    return getattr(e, "device_time_total", None) or getattr(e, "cuda_time_total", 0)


# The record_function ranges the port opens (kernels/ops.py's backward and jvp
# of attention and wkv): the profiler also lists each as a range on the device,
# which is not a kernel.
PORT_RANGES = ("flash_attention_backward", "wkv_backward", "flash_attention_jvp", "wkv_jvp")


def kernel_events(torch, prof):
    """Kernels only (events on the device): an operator's device time
    (aten::, autograd's backward nodes) is its kernels' again, and a
    ``PORT_RANGES`` range's is its kernels'."""
    return [e for e in prof.key_averages() if device_us(e) > 0
            and e.device_type == torch.autograd.DeviceType.CUDA
            and not e.key.startswith(("Memcpy", "Memset")) and e.key not in PORT_RANGES]


def device_per_call(torch, fn, iters=10, windows=3):
    """Device ms a call of ``fn`` (the sum of its kernels' times in one
    torch.profiler window of ``iters`` calls, after one warm-up call), and
    each kernel's share by name: where a call is short, CUDA events time the
    host that issues it.  A window in which the profiler recorded no kernel
    is taken again, up to ``windows`` in all; then the run fails."""
    from torch.profiler import ProfilerActivity, profile

    if torch.autograd._profiler_enabled():
        fail("device_per_call: another torch.profiler window (an obs.profile?) is open: "
             "windows cannot nest")
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
        # decode at the long-context decode's position: a ring of 1024 that
        # wrapped, a global cache of 2048
        pos = SERVE["long_pos"]
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
    dv 128, 16 heads; weighted on its path by ``mla_kernel_cases``, and kept
    here: these rows draw from the generator that then draws 3C3D's data)
    and gemma3-12b's dh 240 (16 heads over 8, window 1024) in prefill of
    4×2048; CodeQwen1.5-7B's dh 128 (32 heads, no GQA) and
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

    # The accumulated lane's pair passes (``accumulated_phase``): BatchDot's
    # cross block, E = 1 and each side its own A, of two slices of one batch
    # (n = 450 in slices of 113, the tail 111: three pair passes at each
    # shape a call, the launches its weight), and the NTK's E = 10 groups
    # over one shared A at n = 256 in two slices of 128 (weight 0; S's
    # slices are strided, so the call's copy of them is timed with it).
    # Operations: G on both sides (2·R·a·b a row) and the N1·N2 pairs (2·a·b
    # each).  Drawn from a generator of their own.
    pair = torch.Generator(device="cuda").manual_seed(2)
    m = ACC["microbatch"]
    for name, (r, a, b) in conv.items():
        for n1, n2 in ((m, m), (m, ACC["n"] - (ACC["slices"] - 1) * m)):
            A, B = (torch.randn(n1 + n2, r, w, device="cuda", generator=pair) for w in (a, b))
            flops = 2 * (n1 + n2) * r * a * b + 2 * n1 * n2 * a * b
            add("cross_dot", f"{name} two row sets batch_dot pair A[{n1}+{n2},{r},{a}] "
                f"B[{n1}+{n2},{r},{b}]", 3, 3,
                (A[None, :n1], B[None, :n1], A[None, n1:], B[None, n1:]), {}, flops,
                4 * ((n1 + n2) * r * (a + b) + n1 * n2), flops)
    r, a, b = conv["conv2"]
    h = ACC["gram_microbatch"]
    A, S = (torch.randn(*shape, device="cuda", generator=pair)
            for shape in ((2 * h, r, a), (10, 2 * h, r, b)))
    flops = 2 * 10 * 2 * h * r * a * b + 2 * 10 * h * h * a * b
    add("cross_dot", f"conv2 two row sets ntk pair A[{h}+{h},{r},{a}] S[10,{h}+{h},{r},{b}]",
        0, 0, (A[None, :h], S[:, :h], A[None, h:], S[:, h:]), {}, flops,
        4 * (2 * h * r * a + 10 * 2 * h * r * b + 10 * h * h), flops)

    # The matrix-free phase's shapes that no row above has (``matfree_phase``;
    # its monolithic NTK and GGNGram calls at 128 rows are the Gram rows):
    # gp_predict's NTK over 128 + 32 rows, and in two slices of 80 each
    # slice on one row set and the pair pass on two; select_subset's NTK
    # (diversity) and GGNGram (BAIT: 10 class-major rows a sample) in two
    # slices of 64, the same.  Per call and weight: a call's launches at a
    # conv layer and the phase's (three gp_predict solvers; one two-slice
    # call each).  Drawn from a generator of their own; the pair passes'
    # S slices are strided, so the call's copy of them is timed with it,
    # while GGNGram's rows are copied by the engine before its call.
    mat = torch.Generator(device="cuda").manual_seed(3)
    n_gp = N + MATFREE["gp_test"]
    for name, (r, a, b) in conv.items():
        A, S = (torch.randn(*shape, device="cuda", generator=mat)
                for shape in ((n_gp, r, a), (10, n_gp, r, b)))
        flops = 2 * 10 * n_gp * r * a * b + 10 * n_gp * (n_gp + 1) * a * b
        add("cross_dot", f"{name} ntk gp A[{n_gp},{r},{a}] S[10,{n_gp},{r},{b}]", 1, 3,
            (A[None], S, A[None], S), {}, flops,
            4 * (n_gp * r * a + 10 * n_gp * r * b + 10 * n_gp * n_gp), flops)
        for h, use in ((n_gp // 2, "gp"), (N // 2, "select")):
            A1, S1 = A[:h].contiguous(), S[:, :h].contiguous()
            flops = 2 * 10 * h * r * a * b + 10 * h * (h + 1) * a * b
            add("cross_dot", f"{name} ntk {use} slice A[{h},{r},{a}] S[10,{h},{r},{b}]", 2, 2,
                (A1[None], S1, A1[None], S1), {}, flops,
                4 * (h * r * a + 10 * h * r * b + 10 * h * h), flops)
            flops = 2 * 10 * 2 * h * r * a * b + 2 * 10 * h * h * a * b
            add("cross_dot", f"{name} two row sets ntk {use} pair A[{h}+{h},{r},{a}] "
                f"S[10,{h}+{h},{r},{b}]", 1, 1,
                (A[None, :h], S[:, :h], A[None, h:2 * h], S[:, h:2 * h]), {}, flops,
                4 * (2 * h * r * a + 10 * 2 * h * r * b + 10 * h * h), flops)
        h = N // 2
        rows1 = S[:, :h].reshape(1, 10 * h, r, b)
        rows2 = S[:, h:2 * h].reshape(1, 10 * h, r, b)
        flops = 2 * 10 * h * r * a * b + 10 * h * (10 * h + 1) * a * b
        add("cross_dot", f"{name} ggn_gram select slice A[{h},{r},{a}] rows[{10 * h},{r},{b}]",
            2, 2, (A[None, :h], rows1, A[None, :h], rows1), {}, flops,
            4 * (h * r * a + 10 * h * r * b + 100 * h * h), flops)
        flops = 2 * 10 * 2 * h * r * a * b + 2 * 100 * h * h * a * b
        add("cross_dot", f"{name} two row sets ggn_gram select pair A[{h}+{h},{r},{a}] "
            f"rows[{10 * h}+{10 * h},{r},{b}]", 1, 1,
            (A[None, :h], rows1, A[None, h:2 * h], rows2), {}, flops,
            4 * (2 * h * r * a + 2 * 10 * h * r * b + 100 * h * h), flops)
    return cases


def row_set_spy(ops, kinds):
    """Wrap the cross_dot kernel's launcher to count its launches on one row
    set (both sides the same tensors, the kernel's symmetric route) and on
    two; returns the function that restores it."""
    launch = ops.cross_dot_cuda

    def spy(A1, B1, A2, B2):
        one = (A1.data_ptr() == A2.data_ptr() and A1.shape == A2.shape
               and B1.data_ptr() == B2.data_ptr() and B1.shape == B2.shape)
        kinds["one" if one else "two"] += 1
        return launch(A1, B1, A2, B2)

    ops.cross_dot_cuda = spy
    return lambda: setattr(ops, "cross_dot_cuda", launch)


def accumulated_phase(torch, ops, model, params, loss, exts, gram_exts):
    """The accumulated lane on 3C3D at full width, through ``plan_for_batch``
    with a ``microbatch_size``: the main path's ten extensions at n = 450 in
    four slices (launch counts ``ACC_LAUNCHES``, every cross_dot on two row
    sets) against the monolithic ``run`` at n = 450 under ``TOL``, BatchDot
    symmetric bit for bit, its peak memory (above what was allocated when
    it started) below the monolithic call's; the Gram family at n = 256 in
    two slices (cross_dot 12 times on one row set, 6 on two) against the
    monolithic Gram ``run``; the main path checkpointed after every work
    unit, killed before unit 5 and resumed: the uninterrupted run's bits;
    and the wall time, device time and idle share of the accumulated and
    the monolithic call, in turns."""
    import tempfile

    from repro_torch.core import AccumulatedSweepPlan, ExtensionConfig, ntk_total, plan_for_batch
    from repro_torch.core import run as run_sweep
    from repro_torch.core.tree import tree_leaves
    from repro_torch.train.checkpoint import SweepCheckpointer
    from repro_torch.train.fault import FailureInjector, SimulatedFailure

    gen = torch.Generator(device="cuda").manual_seed(5)
    n = ACC["n"]
    x = torch.randn(n, 32, 32, 3, device="cuda", generator=gen)
    y = torch.randint(0, 10, (n,), device="cuda", generator=gen)
    cfg = ExtensionConfig(mc_seed=0)
    plan = plan_for_batch(exts, cfg, n, microbatch_size=ACC["microbatch"])
    if not (isinstance(plan, AccumulatedSweepPlan) and plan.num_microbatches == ACC["slices"]):
        fail(f"accumulated: plan_for_batch gave {type(plan).__name__}, not 4 slices")
    out = dict(model="c3d3", batch=n, microbatch=ACC["microbatch"], describe=plan.describe())

    def acc_call():
        return plan.run(model, params, x, y, loss, cfg=cfg)

    def mono_call():
        return run_sweep(model, params, x, y, loss, extensions=exts, cfg=cfg)

    def measured(call):
        """(result, wall s, peak bytes above the start, peak bytes)."""
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        res = call()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated()
        return res, wall, peak - base, peak

    # -- the main path in slices, against the monolithic call -------------------
    ops.reset_launch_counts()
    mono, out["mono_first_s"], out["mono_peak_bytes"], out["mono_max_memory_allocated"] = \
        measured(mono_call)
    mono_launches = ops.launch_counts()
    kinds = {"one": 0, "two": 0}
    restore = row_set_spy(ops, kinds)
    try:
        ops.reset_launch_counts()
        acc, out["acc_first_s"], out["acc_peak_bytes"], out["acc_max_memory_allocated"] = \
            measured(acc_call)
        launches = ops.launch_counts()
    finally:
        restore()
    out.update(launches=launches, mono_launches=mono_launches, cross_dot_row_sets=dict(kinds))
    say("accumulated", **out)
    want = {k: ACC_LAUNCHES.get(k, 0) for k in ops.KERNELS}
    if launches != want:
        fail(f"accumulated: launched {launches}, not {want}")
    if kinds != {"one": 0, "two": ACC_LAUNCHES["cross_dot"]}:
        fail(f"accumulated: cross_dot launches by row sets {kinds}, not all on two")
    out["compare"] = check_errs(f"accumulated n={n} k={ACC['slices']} vs monolithic (card)",
                                rel_errs(acc, mono, exts))
    if not all(torch.equal(d, d.T) for d in tree_leaves(acc.ext["batch_dot"])):
        fail("accumulated: BatchDot's [n, n] blocks are not symmetric bit for bit")
    if not out["acc_peak_bytes"] < out["mono_peak_bytes"]:
        fail(f"accumulated: peak {out['acc_peak_bytes']} bytes, not below the monolithic "
             f"call's {out['mono_peak_bytes']}")
    del mono

    # -- the Gram family in two slices ------------------------------------------
    ng = ACC["gram_n"]
    xg, yg = x[:ng], y[:ng]
    gplan = plan_for_batch(gram_exts, cfg, ng, microbatch_size=ACC["gram_microbatch"])
    gkinds = {"one": 0, "two": 0}
    restore = row_set_spy(ops, gkinds)
    try:
        ops.reset_launch_counts()
        gacc = gplan.run(model, params, xg, yg, loss, cfg=cfg)
        torch.cuda.synchronize()
        glaunches = ops.launch_counts()
    finally:
        restore()
    gmono = run_sweep(model, params, xg, yg, loss, extensions=gram_exts, cfg=cfg)
    ntk = ntk_total(gacc.ext["ntk"])
    gram = dict(batch=ng, microbatch=ACC["gram_microbatch"], launches=glaunches,
                cross_dot_row_sets=gkinds, ntk_symmetric=bool(torch.equal(ntk, ntk.T)),
                ntk_min_diagonal=torch.diagonal(ntk).min().item())
    say("accumulated_gram", **gram)
    if glaunches != {k: sum(ACC_GRAM_ROW_SETS.values()) if k == "cross_dot" else 0
                     for k in ops.KERNELS} or gkinds != ACC_GRAM_ROW_SETS:
        fail(f"accumulated gram: launched {glaunches}, by row sets {gkinds}, not "
             f"{ACC_GRAM_ROW_SETS}")
    if not (gram["ntk_symmetric"] and gram["ntk_min_diagonal"] >= 0):
        fail("accumulated gram: the NTK is not symmetric with a diagonal >= 0")
    gram["compare"] = check_errs(f"accumulated gram n={ng} k=2 vs monolithic (card)",
                                 rel_errs(gacc, gmono, gram_exts))
    out["gram"] = gram
    del gacc, gmono, ntk

    # -- interrupt and resume ------------------------------------------------------
    with tempfile.TemporaryDirectory() as tmp:
        store = SweepCheckpointer(tmp, keep=1)
        t0 = time.perf_counter()
        try:
            plan.run_checkpointed(model, params, x, y, loss, cfg=cfg, checkpointer=store,
                                  checkpoint_every=1,
                                  injector=FailureInjector(fail_at_step=ACC["fail_at"]))
            fail("accumulated: the injected failure did not fire")
        except SimulatedFailure:
            pass
        killed_s = time.perf_counter() - t0
        if store.latest() != ACC["fail_at"]:
            fail(f"accumulated: last snapshot at {store.latest()}, not {ACC['fail_at']}")
        t0 = time.perf_counter()
        resumed = plan.resume(model, params, x, y, loss, store, cfg=cfg)
        torch.cuda.synchronize()
        resume_s = time.perf_counter() - t0
        snapshot_bytes = os.path.getsize(os.path.join(tmp, f"step_{store.latest():08d}",
                                                      "arrays.npz"))
    parts = [("loss", [resumed.loss], [acc.loss]), ("logits", [resumed.logits], [acc.logits]),
             ("grads", tree_leaves(resumed.grads), tree_leaves(acc.grads))]
    parts += [(e.name, tree_leaves(resumed.ext[e.name]), tree_leaves(acc.ext[e.name]))
              for e in exts]
    differ = [key for key, gs, ws in parts
              if not all(torch.equal(g, w) for g, w in zip(gs, ws, strict=True))]
    out["resume"] = dict(fail_at=ACC["fail_at"], killed_s=killed_s, resume_s=resume_s,
                         snapshot_bytes=snapshot_bytes, differ=differ)
    say("accumulated_resume", **out["resume"])
    if differ:
        fail(f"accumulated: resume after the failure differs from the uninterrupted run in "
             f"{differ}")
    del resumed, acc

    # -- times, in turns ------------------------------------------------------------
    walls = {"accumulated": [], "monolithic": []}
    for route in ("accumulated", "monolithic", "monolithic", "accumulated"):
        call = acc_call if route == "accumulated" else mono_call
        t0 = time.perf_counter()
        call()
        torch.cuda.synchronize()
        walls[route].append((time.perf_counter() - t0) * 1e3)
    out["wall_ms"] = walls
    for route, call in (("accumulated", acc_call), ("monolithic", mono_call)):
        prof = profiled(call)
        prof["idle_share"] = 1 - prof["device_ms"] / prof["wall_ms"]
        out[f"profile_{route}"] = prof
        say("profile_accumulated", route=route, **prof)
    return out


def matfree_phase(torch, ops, model, params, x, y, loss):
    """The matrix-free curvature lane and its NTK consumers on 3C3D at full
    width, batch 128, through the entry points a user calls, each call with
    the launch counts set to 0 just before and read just after (cross_dot's
    row sets spied), timed (wall ms, peak bytes above its start) and
    profiled once (device ms, idle share):

    * ``ggn_vp`` / ``hvp`` card against CPU (``TOL``), ⟨u, Hv⟩ = ⟨Hu, v⟩,
      ``ggn_vp(e_i)[i]`` against the fused route's DiagGGN at two
      coordinates of each of the 12 leaves, the product streamed in slices
      of 113 against the monolithic one (1e-5);
    * five ``make_cg_ngd_step`` steps with each solver (CG launches no
      kernel; the Gram solve cross_dot 3 a step): the loss falls; the
      returned step's first parameter update on the batch's first 16 rows
      card (float32) against the CPU in float64, within ``F64_FACTOR`` of
      the CPU's float32 reading; CG's final residual (the step's metric)
      against one more product at that update;
    * ``log_marglik_matfree`` (4 probes, 20 iterations): log_det_ratio ≥ 0
      and finite; card against CPU float64 on the first 16 rows, the same
      probes, within ``SLQ_F64_TOL``;
    * ``gp_predict`` on 128 + 32 rows with each solver (they agree to
      ``TOL``; the Lanczos solve within its cg_tol or its cap reported) and
      in two slices (cross_dot ``GRAM_TWO_SLICES``; kernel, mean and var
      within ``TOL`` of the monolithic call's); ``influence_scores`` /
      ``self_influence`` on 16 training rows (20 CG iterations) card against
      CPU; ``select_subset`` diversity and BAIT of 8, the same picks in two
      slices and the kernel as the monolithic call's to ``TOL`` (off rows
      whose forward pattern flips in a slice, which are named); the
      launcher on c2d2.
    """
    from repro_torch.core import Activation, DiagGGN, ExtensionConfig
    from repro_torch.core import run as run_sweep
    from repro_torch.core.tree import tree_leaves, tree_map, tree_unflatten
    from repro_torch.curv import GGNOperator, ggn_vp, hvp, lanczos_topk
    from repro_torch.laplace import log_marglik_matfree
    from repro_torch.nn.layers import MaxPool2d
    from repro_torch.ntk_apps import (gp_predict, influence_scores, ntk_kernel, select_subset,
                                      self_influence)
    from repro_torch.optim import make_cg_ngd_step

    M = MATFREE
    dev = x.device
    gen = torch.Generator(device=dev).manual_seed(7)
    out = {"calls": {}, "section_s": {}}
    clock = [time.perf_counter()]

    def section(label):
        """Seconds since the previous section ended, kept under ``label``."""
        now = time.perf_counter()
        out["section_s"][label] = now - clock[0]
        clock[0] = now

    def to_cpu(tree, dtype=None):
        return tree_map(lambda a: a.cpu().to(dtype) if dtype and a.dtype.is_floating_point
                        else a.cpu(), tree)

    def rel(got, want):
        """max over leaves of max |got − want| / max |want| (``want`` may lie
        on the CPU, in float64)."""
        return max(((g.to(w.device, w.dtype) - w).abs().max()
                    / w.abs().max().clamp_min(1e-30)).item()
                   for g, w in zip(tree_leaves(got), tree_leaves(want), strict=True))

    def dot(a, b):
        return sum((p * q).sum() for p, q in zip(tree_leaves(a), tree_leaves(b), strict=True))

    def randn_like(tree):
        return tree_map(lambda p: torch.randn(p.shape, device=dev, generator=gen), tree)

    def call(label, fn, launches=None, rows=None):
        """One counted, timed call of ``fn`` and one profiled call; fails
        unless the launch counts are ``launches`` (absent kernels 0) and,
        where ``rows`` is given, cross_dot's row sets are ``rows``."""
        kinds = {"one": 0, "two": 0}
        restore = row_set_spy(ops, kinds)
        try:
            torch.cuda.synchronize()
            base = torch.cuda.memory_allocated()
            torch.cuda.reset_peak_memory_stats()
            ops.reset_launch_counts()
            t0 = time.perf_counter()
            res = fn()
            torch.cuda.synchronize()
            wall = (time.perf_counter() - t0) * 1e3
            counts = ops.launch_counts()
            peak = torch.cuda.max_memory_allocated() - base
        finally:
            restore()
        t0 = time.perf_counter()
        prof = profiled(fn, host_ops=False)
        if not prof["device_ms"] > 0:
            fail(f"matfree {label}: the profiler recorded no kernel")
        row = dict(wall_ms=wall, device_ms=prof["device_ms"], profiled_wall_ms=prof["wall_ms"],
                   profile_s=time.perf_counter() - t0,
                   idle_share=1 - prof["device_ms"] / prof["wall_ms"], peak_bytes=peak,
                   launches={k: v for k, v in counts.items() if v}, cross_dot_row_sets=kinds,
                   top=prof["top"][:4])
        out["calls"][label] = row
        say("matfree_call", label=label, **row)
        want = {k: (launches or {}).get(k, 0) for k in ops.KERNELS}
        if counts != want:
            fail(f"matfree {label}: launched {counts}, not {want}")
        if rows is not None and kinds != rows:
            fail(f"matfree {label}: cross_dot by row sets {kinds}, not {rows}")
        return res

    def pattern(xx):
        """Each sample's ReLU signs and max-pool picks in a forward of ``xx``."""
        _, tapes = model.forward_tape(params, xx)
        parts = []
        for mod, tape in zip(model.mods, tapes):
            if isinstance(mod, MaxPool2d):
                parts.append(tape[1].reshape(xx.shape[0], -1))
            elif isinstance(mod, Activation):
                parts.append((tape > 0).reshape(xx.shape[0], -1))
        return parts

    def flipped_rows(xx):
        """The rows whose forward pattern in two slices (the accumulated
        lane's, ``microbatches=2``) differs from the whole batch's: float32
        GEMMs of another row count round differently, and a pre-activation
        within that rounding of 0 (or a max-pool near-tie) goes the other way
        there, so that row's Jacobian is another function's."""
        m = -(-xx.shape[0] // 2)
        with torch.no_grad():
            whole = pattern(xx)
            sliced = [torch.cat(pair) for pair in zip(pattern(xx[:m]), pattern(xx[m:]))]
        bad = torch.zeros(xx.shape[0], dtype=torch.bool, device=xx.device)
        for a, b in zip(whole, sliced, strict=True):
            bad |= (a != b).any(1)
        return bad.nonzero().flatten().tolist()

    def agree_off(K2, K1, rows):
        """``rel`` of two [N, N, ...] kernels on the rows and columns not in
        ``rows``."""
        keep = torch.tensor([i for i in range(K1.shape[0]) if i not in rows], device=K1.device)
        return rel(K2[keep][:, keep], K1[keep][:, keep])

    def f64_check(label, card, cpu32, cpu64, limit=None, **extra):
        """The card's float32 against the CPU's float64, within ``limit``,
        by default F64_FACTOR of the CPU's float32 against its float64."""
        r32, r = rel(cpu32, cpu64), rel(card, cpu64)
        limit = limit if limit is not None else max(F64_FACTOR * r32, 1e-6)
        row = dict(card_vs_f64=r, cpu_f32_vs_f64=r32, limit=limit, **extra)
        say("matfree_f64", label=label, **row)
        if not r <= limit:
            fail(f"matfree {label}: card vs CPU float64 {r:.3e} above {limit:.3e}")
        return row

    cpu_params, cpu64_params = to_cpu(params), to_cpu(params, torch.float64)
    xc, yc, x64 = x.cpu(), y.cpu(), x.cpu().double()

    # -- products ----------------------------------------------------------------
    v = randn_like(params)
    prods = {}
    for name, fn in (("ggn_vp", ggn_vp), ("hvp", hvp)):
        card = call(name, lambda: fn(model, params, x, y, loss, v))
        t0 = time.perf_counter()
        want = fn(model, cpu_params, xc, yc, loss, to_cpu(v))
        prods[name] = card
        out[name] = dict(card_vs_cpu=rel(card, want), cpu_s=time.perf_counter() - t0)
        say("matfree_product", name=name, tol=TOL, **out[name])
        if not out[name]["card_vs_cpu"] <= TOL:
            fail(f"matfree {name}: card vs CPU {out[name]['card_vs_cpu']:.3e} above {TOL}")
    u = randn_like(params)
    hu = hvp(model, params, x, y, loss, u)
    uhv, huv = dot(u, prods["hvp"]).item(), dot(hu, v).item()
    bound = (dot(u, u).sqrt() * dot(prods["hvp"], prods["hvp"]).sqrt()).item()
    out["hvp_symmetry"] = dict(u_hv=uhv, hu_v=huv, rel=abs(uhv - huv) / bound)
    say("matfree_symmetry", tol=TOL, **out["hvp_symmetry"])
    if not out["hvp_symmetry"]["rel"] <= TOL:
        fail(f"matfree: <u, Hv> = {uhv} but <Hu, v> = {huv}")
    streamed = call("ggn_vp_streamed", lambda: ggn_vp(
        model, params, x, y, loss, v, cfg=ExtensionConfig(microbatch_size=M["microbatch"])))
    out["streamed_vs_monolithic"] = rel(streamed, prods["ggn_vp"])
    say("matfree_streamed", microbatch=M["microbatch"], rel_err=out["streamed_vs_monolithic"])
    if not out["streamed_vs_monolithic"] <= 1e-5:
        fail(f"matfree: streamed ggn_vp {out['streamed_vs_monolithic']:.3e} from monolithic")

    # ggn_vp(e_i)[i] against the fused route's DiagGGN (fused_second_order, sq_matmul)
    diag = call("diag_ggn_run", lambda: run_sweep(model, params, x, y, loss,
                                                  extensions=(DiagGGN,)),
                launches=DIAG_LAUNCHES).ext["diag_ggn"]
    leaves, dl = tree_leaves(params), tree_leaves(diag)
    worst = 0.0
    for j, d in enumerate(dl):
        for i in (int(d.argmax()), int(torch.randint(d.numel(), (1,), generator=gen,
                                                      device=dev))):
            e = [torch.zeros_like(p) for p in leaves]
            e[j].view(-1)[i] = 1.0
            g = ggn_vp(model, params, x, y, loss, tree_unflatten(params, e))
            got = tree_leaves(g)[j].reshape(-1)[i]
            worst = max(worst, ((got - d.reshape(-1)[i]).abs() / d.max()).item())
    out["diag_cross_check"] = dict(leaves=len(dl), coordinates=2 * len(dl), rel_err=worst)
    say("matfree_diag_cross_check", tol=TOL, **out["diag_cross_check"])
    if len(dl) != 12 or not worst <= TOL:
        fail(f"matfree: ggn_vp(e_i)[i] vs DiagGGN {worst:.3e} over {len(dl)} leaves")
    del prods, streamed, diag, hu, u, v
    section("products")

    # -- CG and the natural-gradient step --------------------------------------------
    batch = {"inputs": x, "labels": y}
    n = M["check_rows"]  # the rows of the float64 checks
    out["ngd"] = {}
    for solver in ("cg", "kernel"):
        opt, step = make_cg_ngd_step(model, loss, lr=M["lr"], damping=M["damping"],
                                     solver=solver, cg_iters=M["cg_iters"],
                                     cg_tol=M["ngd_cg_tol"])
        per_step = {"cross_dot": 3} if solver == "kernel" else {}
        p, st, m = call(f"ngd_{solver}_step", lambda: step(params, opt.init(params), batch, 0),
                        launches=per_step, rows=GRAM_ONE if solver == "kernel" else None)
        losses, walls = [float(m["loss"])], []
        ops.reset_launch_counts()
        for i in range(1, M["steps"]):
            t0 = time.perf_counter()
            p, st, m = step(p, st, batch, i)
            losses.append(float(m["loss"]))
            torch.cuda.synchronize()
            walls.append((time.perf_counter() - t0) * 1e3)
        counts = ops.launch_counts()
        row = dict(losses=losses, step_ms=walls, launches={k: v for k, v in counts.items() if v})
        if solver == "cg":
            row.update(cg_iters=m["cg_iters"], cg_resid=float(m["cg_resid"]))
        # The first step's parameter update on the batch's first n rows: card
        # float32, CPU float32 and float64, each through the returned step.
        def first_update(prm, xx, yy):
            new, _, met = step(prm, opt.init(prm), {"inputs": xx, "labels": yy}, 0)
            return tree_map(lambda a, b: a.detach().double() - b.detach().double(), new,
                            prm), met

        got, met = first_update(params, x[:n], y[:n])
        t0 = time.perf_counter()
        cpu32 = first_update(cpu_params, xc[:n], yc[:n])[0]
        cpu64 = first_update(cpu64_params, x64[:n], yc[:n])[0]
        cpu_s = time.perf_counter() - t0
        if solver == "cg":  # the step's final residual against one more product
            d = tree_map(lambda u: (-u / M["lr"]).float(), got)
            op = GGNOperator(model, params, x[:n], y[:n], loss, damping=M["damping"])
            g = run_sweep(model, params, x[:n], y[:n], loss).grads
            r = tree_map(torch.sub, g, op.mv(d))
            true = (dot(r, r).sqrt() / dot(g, g).sqrt()).item()
            row["resid"] = dict(recurrence=float(met["cg_resid"]), recomputed=true,
                                iters=met["cg_iters"])
            if not abs(true - row["resid"]["recurrence"]) <= 0.05 * true + 1e-6:
                fail(f"matfree cg: recurrence residual {row['resid']['recurrence']:.4e}, "
                     f"recomputed {true:.4e}")
        row["update"] = f64_check(f"ngd {solver} first update, first {n} rows", got, cpu32,
                                  cpu64, cpu_s=cpu_s)
        out["ngd"][solver] = row
        say("matfree_ngd", solver=solver, lr=M["lr"], damping=M["damping"], **row)
        if counts != {k: (M["steps"] - 1) * per_step.get(k, 0) for k in ops.KERNELS}:
            fail(f"matfree ngd {solver}: {M['steps'] - 1} steps launched {counts}")
        if not (all(math.isfinite(v) for v in losses) and losses[-1] < losses[0]):
            fail(f"matfree ngd {solver}: the loss did not fall: {losses}")
        del p, st, got, cpu32, cpu64

    section("ngd")

    # -- SLQ evidence ---------------------------------------------------------------------
    kw = dict(prior_prec=M["prior_prec"], probes=M["probes"], iters=M["slq_iters"])
    ev = call("log_marglik_matfree", lambda: log_marglik_matfree(model, params, x, y, loss, **kw))
    card16 = log_marglik_matfree(model, params, x[:n], y[:n], loss, **kw)
    t0 = time.perf_counter()
    cpu32 = log_marglik_matfree(model, cpu_params, xc[:n], yc[:n], loss, **kw)
    cpu64 = log_marglik_matfree(model, cpu64_params, x64[:n], yc[:n], loss, **kw)
    cpu_s = time.perf_counter() - t0

    def terms(e):
        return [torch.tensor([e.log_det_ratio, e.log_marglik], dtype=torch.float64),
                e.per_probe.double()]

    out["slq"] = dict(log_marglik=ev.log_marglik, log_lik=ev.log_lik, scatter=ev.scatter,
                      log_det_ratio=ev.log_det_ratio, per_probe=ev.per_probe.tolist(),
                      check=f64_check(f"slq first {n} rows", terms(card16), terms(cpu32),
                                      terms(cpu64), limit=SLQ_F64_TOL, cpu_s=cpu_s,
                                      log_det_ratio=[card16.log_det_ratio,
                                                     cpu64.log_det_ratio]))
    say("matfree_slq", **{k: v for k, v in out["slq"].items() if k != "check"})
    if not (math.isfinite(ev.log_marglik) and math.isfinite(ev.log_det_ratio)
            and ev.log_det_ratio >= 0):
        fail(f"matfree slq: log_det_ratio {ev.log_det_ratio}, evidence {ev.log_marglik}")

    section("slq")

    # -- the GP predictive --------------------------------------------------------------
    x_te = torch.randn((M["gp_test"],) + tuple(x.shape[1:]), device=dev, generator=gen)
    K = call("ntk_kernel", lambda: ntk_kernel(model, params, x, y, loss),
             launches={"cross_dot": 3}, rows=GRAM_ONE)
    ridge = torch.diagonal(K).mean().item()  # cond(K + λI) ≤ N + 1
    gps, out["gp"] = {}, dict(ridge=ridge, train=x.shape[0], test=M["gp_test"])
    for solver in ("cholesky", "eigh", "lanczos"):
        skw = dict(ridge=ridge, solver=solver)
        if solver == "lanczos":
            skw.update(rank=M["rank"], cg_tol=M["cg_tol"], cg_maxiter=M["cg_maxiter"])
        gps[solver] = call(f"gp_predict_{solver}", lambda: gp_predict(
            model, params, x, y, x_te, loss, **skw), launches={"cross_dot": 3}, rows=GRAM_ONE)
    info = gps["lanczos"].info
    out["gp"]["lanczos"] = dict(iters=info.iters, resid=info.resid.item(), cg_tol=M["cg_tol"],
                                capped=info.iters >= M["cg_maxiter"])
    for solver in ("eigh", "lanczos"):
        out["gp"][f"{solver}_vs_cholesky"] = {f: rel(getattr(gps[solver], f),
                                                      getattr(gps["cholesky"], f))
                                              for f in ("mean", "var")}
    two = call("gp_predict_two_slices", lambda: gp_predict(
        model, params, x, y, x_te, loss, ridge=ridge, microbatches=2),
        launches={"cross_dot": 9}, rows=GRAM_TWO_SLICES)
    flips = flipped_rows(torch.cat([x, x_te]))
    mono = gps["cholesky"]
    out["gp"]["two_slices_vs_monolithic"] = dict(
        {f: rel(getattr(two, f), getattr(mono, f)) for f in ("kernel", "mean", "var")},
        flipped_rows=flips)
    say("matfree_gp", tol=TOL, **out["gp"])
    held = (("eigh_vs_cholesky", ("mean", "var")), ("lanczos_vs_cholesky", ("mean", "var")),
            ("two_slices_vs_monolithic", ("kernel", "mean", "var")))
    bad = {f"{key} {f}": out["gp"][key][f] for key, fs in held for f in fs
           if not out["gp"][key][f] <= TOL}
    if bad or not all(torch.isfinite(gps[s].mean).all() and (gps[s].var > 0).all() for s in gps):
        fail(f"matfree gp: solvers or slices disagree {bad}, or a non-finite / non-positive "
             "predictive")
    if not out["gp"]["lanczos"]["capped"] and not info.resid.item() <= M["cg_tol"]:
        fail(f"matfree gp: the Lanczos solve stopped at {info.iters} iterations with residual "
             f"{info.resid.item():.3e} above its cg_tol {M['cg_tol']}")
    del gps, two, K
    section("gp")

    # -- influence ------------------------------------------------------------------------
    nt, ne = M["influence_train"], M["influence_test"]
    xi, yi, xt, yt = x[:nt], y[:nt], x[nt:nt + ne], y[nt:nt + ne]
    top = lanczos_topk(GGNOperator(model, params, xi, yi, loss).mv, params, k=1, iters=8)
    damping = 0.1 * top.eigvals[0].item()  # cond(G + δI) ≤ 11: 20 iterations converge
    ikw = dict(damping=damping, cg_tol=0.0, cg_maxiter=M["influence_iters"])
    inf = call("influence_scores", lambda: influence_scores(model, params, xi, yi, xt, yt, loss,
                                                            **ikw))
    sel = call("self_influence", lambda: self_influence(model, params, xi, yi, loss, **ikw))
    t0 = time.perf_counter()
    inf_cpu = influence_scores(model, cpu_params, xi.cpu(), yi.cpu(), xt.cpu(), yt.cpu(), loss,
                               **ikw)
    sel_cpu = self_influence(model, cpu_params, xi.cpu(), yi.cpu(), loss, **ikw)
    out["influence"] = dict(
        damping=damping, top_eigval=top.eigvals[0].item(), iters=[inf.iters, sel.iters],
        cpu_iters=[inf_cpu.iters, sel_cpu.iters], cpu_s=time.perf_counter() - t0,
        resid=[inf.resid.max().item(), sel.resid.max().item()],
        card_vs_cpu=dict(scores=rel(inf.scores, inf_cpu.scores),
                         self=rel(sel.scores, sel_cpu.scores)))
    say("matfree_influence", tol=TOL, **out["influence"])
    iters = [M["influence_iters"]] * 2
    if not (out["influence"]["iters"] == out["influence"]["cpu_iters"] == iters
            and max(out["influence"]["card_vs_cpu"].values()) <= TOL):
        fail(f"matfree influence: {out['influence']}")

    section("influence")

    # -- subset selection ---------------------------------------------------------------
    out["select"] = {}
    flips = flipped_rows(x)
    for method in ("diversity", "bait"):
        skw = dict(method=method, lam=M["bait_lam"])
        mono = call(f"select_{method}", lambda: select_subset(model, params, x, y, loss,
                                                              M["select_k"], **skw),
                    launches={"cross_dot": 3}, rows=GRAM_ONE)
        two = call(f"select_{method}_two_slices", lambda: select_subset(
            model, params, x, y, loss, M["select_k"], microbatches=2, **skw),
            launches={"cross_dot": 9}, rows=GRAM_TWO_SLICES)
        diag = torch.diagonal(mono.kernel.permute(0, 2, 1, 3).flatten(0, 1).flatten(1, 2)
                              if mono.kernel.dim() == 4 else mono.kernel)
        row = dict(indices=mono.indices.tolist(), two_slices=two.indices.tolist(),
                   scores=mono.scores.tolist(), kernel_rel=rel(two.kernel, mono.kernel),
                   flipped_rows=flips, kernel_off_flips=agree_off(two.kernel, mono.kernel, flips),
                   kernel_mean_diagonal=diag.mean().item())
        out["select"][method] = row
        say("matfree_select", method=method, **row)
        if row["indices"] != row["two_slices"] or not row["kernel_off_flips"] <= TOL:
            fail(f"matfree select {method}: {row}")

    section("select")

    # -- the launcher ---------------------------------------------------------------------
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(filter(None, [str(ROOT / "src"), env.get("PYTHONPATH")]))
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, "-m", "repro_torch.launch.ntk_apps", "--gp", "--model",
                           "c2d2"], env=env, cwd=ROOT, capture_output=True, text=True,
                          timeout=600)
    out["launcher"] = dict(returncode=proc.returncode, s=time.perf_counter() - t0,
                           stdout=proc.stdout.strip().splitlines()[:1])
    say("matfree_launcher", **out["launcher"])
    if proc.returncode != 0:
        fail(f"the ntk_apps launcher exited {proc.returncode}: {proc.stderr[-2000:]}")
    section("launcher")
    say("matfree_sections", **out["section_s"])
    out["cross_dot_launches"] = (sum(c["launches"].get("cross_dot", 0)
                                     for c in out["calls"].values())
                                 + out["ngd"]["kernel"]["launches"].get("cross_dot", 0))
    return out


def serve_phase(torch, ops, spec=SERVE):
    """A language model at full width (``spec``: Hymba-1.5B, ``SERVE``, or
    StableLM-2-1.6B, ``SERVE_DENSE``; bfloat16, every layer, random weights
    from a seed) through the serving entry points, with the launch counts
    reset before each call and read after: ``make_prefill_step`` on 4
    prompts of 2048 tokens (each of ``spec["kernels"]`` once a layer,
    nothing else); greedy ``generate`` on 4 prompts of 32 tokens to 128
    (the same a serve_step); decode steps timed and one profiled, from a
    32-token cache and, on a bf16 model cut to ``long_cut``'s 4 layers, at
    ``long_pos`` (1500) cached tokens; then, in a float32 copy of the
    weights, the card against the CPU at batch 1, T 64, and the serve_step
    chain over ``chain_len`` tokens against the full forward (Hymba: 1040,
    past the window-1024 rings' wrap, at ``chain_cut``'s 4 layers); and the
    launcher run once."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.core.tree import tree_leaves, tree_map
    from repro_torch.nn.models import build_model
    from repro_torch.serve import ServeConfig, generate, prefill
    from repro_torch.train import make_decode_step, make_prefill_step

    out = {}
    cfg = get_config(spec["arch"])
    t0 = time.perf_counter()
    model = build_model(cfg, device="cuda", generator=torch.Generator(device="cuda").manual_seed(0))
    params = model.params()
    torch.cuda.synchronize()
    out["model"] = dict(arch=cfg.name, dtype=cfg.dtype, layers=cfg.n_layers,
                        param_count=cfg.param_count(model), build_s=time.perf_counter() - t0,
                        param_bytes=sum(p.numel() * p.element_size() for p in tree_leaves(params)))
    say("serve_model", **out["model"])
    gen = torch.Generator(device="cuda").manual_seed(7)
    n, t_pre = spec["batch"], spec["prefill_len"]
    per_layer = {k: spec["layers"] if k in spec["kernels"] else 0 for k in ops.KERNELS}

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
        fail(f"{cfg.name} prefill must launch {per_layer}, got {launches}")
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
    short = prompts[:, :spec["prompt_len"]].contiguous()
    sc = ServeConfig(max_len=spec["max_len"])
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    toks = generate(model, params, short, sc)
    torch.cuda.synchronize()
    gen_s = time.perf_counter() - t0
    gen_launches = ops.launch_counts()
    if gen_launches != {k: v * sc.max_len for k, v in per_layer.items()}:
        fail(f"{cfg.name} generate must launch {per_layer} a serve_step ({sc.max_len} "
             f"steps), got {gen_launches}")
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

    # -- decode at a long context, cut in depth: long_pos tokens prefilled, 16 timed --
    pos, long_len = spec["long_pos"], spec["long_max_len"]
    lcfg = dataclasses.replace(cfg, **spec["long_cut"])
    lmodel = build_model(lcfg, device="cuda",
                         generator=torch.Generator(device="cuda").manual_seed(0))
    lparams, ldecode = lmodel.params(), make_decode_step(lmodel)
    long_per_layer = {k: lcfg.n_layers if k in spec["kernels"] else 0 for k in ops.KERNELS}
    caches = lmodel.init_serve_cache(lparams, n, long_len, torch.float32)
    t0 = time.perf_counter()
    caches, logits = prefill(lmodel, lparams, caches, prompts[:, :pos].contiguous(), pos)
    torch.cuda.synchronize()
    prefill_s = time.perf_counter() - t0
    step_s = []
    ops.reset_launch_counts()
    for t in range(pos, pos + 16):
        tok = logits.argmax(-1).int()
        t0 = time.perf_counter()
        logits, caches = ldecode(lparams, caches, tok, t)
        torch.cuda.synchronize()
        step_s.append(time.perf_counter() - t0)
    long_launches = ops.launch_counts()
    if long_launches != {k: 16 * v for k, v in long_per_layer.items()}:
        fail(f"{cfg.name} long-context decode must launch {long_per_layer} a step, "
             f"got {long_launches}")
    if not torch.isfinite(logits).all():
        fail("long-context decode: non-finite logits")
    tok = logits.argmax(-1).int()
    prof = profiled(lambda: ldecode(lparams, caches, tok, pos + 16),
                    groups={"attention": "flash_"})
    prof["idle_share"] = 1 - prof["device_ms"] / prof["wall_ms"]
    out["decode_long"] = dict(
        batch=n, position=pos, max_len=long_len, layers=lcfg.n_layers, prefill_s=prefill_s,
        step_s=step_s, ms_per_token=medians_ms({"d": step_s})["d"], launches=long_launches,
        wall_ms=prof["wall_ms"], device_ms=prof["device_ms"], idle_share=prof["idle_share"],
        attention_device_ms=prof["attention_device_ms"], profile=prof)
    say("serve_decode_long", **out["decode_long"])
    del caches, logits, last, lmodel, lparams

    # -- agreement in a float32 copy of the same weights -------------------------
    # The chain runs at ``spec["chain_cut"]``'s depth where one is given (a
    # model of its own, weights from seed 0): Hymba's 1040 serve_steps at 32
    # layers took ≈ 1 min of the script.
    params32 = tree_map(lambda p: p.float(), params)
    del params
    chain_len, cut = spec["chain_len"], spec.get("chain_cut")
    cmodel, cparams, chain_layers = model, params32, cfg.n_layers
    if cut is not None:
        ccfg = dataclasses.replace(cfg, dtype="float32", **cut)
        cmodel = build_model(ccfg, device="cuda", generator=torch.Generator().manual_seed(0))
        cparams, chain_layers = cmodel.params(), ccfg.n_layers
    seq = torch.randint(0, cfg.vocab, (1, chain_len), device="cuda", generator=gen)
    caches = cmodel.init_serve_cache(cparams, 1, chain_len, torch.float32)
    chain = torch.empty((chain_len, cfg.vocab), device="cuda")
    t0 = time.perf_counter()
    for t in range(chain_len):
        step_logits, caches = cmodel.serve_step(cparams, caches, seq[:, t], t)
        chain[t] = step_logits[0]
    torch.cuda.synchronize()
    chain_s = time.perf_counter() - t0
    if spec["window"] is not None:
        ring = caches[0][1]["pos"]  # the first window stack: [layers, 1024] positions
        if ring.shape[-1] != spec["window"] or ring.max().item() != chain_len - 1:
            fail(f"the window-1024 rings did not wrap: positions {tuple(ring.shape)}, "
                 f"max {ring.max().item()}")
    full = cmodel.call(cparams, seq)[0]
    chain_err = ((chain - full).abs().max() / full.abs().max()).item()
    del chain, caches, cmodel, cparams
    seq_cpu = seq[:, :spec["cpu_len"]]
    card = model.call(params32, seq_cpu)
    cpu_params = tree_map(lambda p: p.cpu(), params32)
    cpu = model.call(cpu_params, seq_cpu.cpu())
    cpu_err = ((card.cpu() - cpu).abs().max() / cpu.abs().max()).item()
    del cpu_params, cpu, card, full, params32
    out["agreement"] = dict(chain_len=chain_len, chain_s=chain_s, chain_layers=chain_layers,
                            layers=cfg.n_layers,
                            chain_vs_forward_rel_err=chain_err, chain_tol=CHAIN_TOL,
                            cpu_len=spec["cpu_len"], card_vs_cpu_rel_err=cpu_err, cpu_tol=TOL)
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
                           spec["arch"], "--full"], env=env, cwd=ROOT, capture_output=True,
                          text=True, timeout=600)
    out["launcher"] = dict(returncode=proc.returncode, s=time.perf_counter() - t0,
                           stdout=proc.stdout.strip().splitlines()[:1])
    say("serve_launcher", **out["launcher"])
    if proc.returncode != 0:
        fail(f"the launcher exited {proc.returncode}: {proc.stderr[-2000:]}")
    out["launches"] = {k: launches[k] + gen_launches[k] for k in ops.KERNELS}
    return out


def dense_kernel_cases(torch):
    """The dense language models' rows, from a generator of their own (seed
    4): flash_attention at StableLM-2-1.6B's MHA (g = 1, 32 heads of 64) in
    bf16 prefill (24 a prefill call), in decode against a global cache at
    1500 tokens (24 a serve_step, weight 0), in bf16 at the training
    launcher's shape (``TRAIN_LM``: 24 a step) and in float32 at the BackPACK
    run's shape (``LM_RUN``: one a layer, 4); fused_first_order and
    fused_second_order at the run's Dense shapes, R = T = 512 rows a sample,
    weighted by their launches a sweep (7 Dense a layer, the head once): the
    first-order sweep's l2, moment and dot; the MC sweep's diagonal (C = 1)
    at the full vocabulary; and diagonal with Kronecker factor at the KFAC
    run's vocabulary of 8192 (``fused_dense_cases``)."""
    gen = torch.Generator(device="cuda").manual_seed(4)

    def randn(*shape):
        return torch.randn(*shape, device="cuda", generator=gen)

    cases = []
    i32 = dict(device="cuda", dtype=torch.int32)
    n, t, h, dh, layers = (SERVE_DENSE["batch"], SERVE_DENSE["prefill_len"], 32, 64,
                           SERVE_DENSE["layers"])
    bf = torch.bfloat16
    q, k, v = (randn(n, t, h, dh).to(bf) for _ in range(3))
    cases.append(("flash_attention", f"prefill bf16 g1 (stablelm-1.6b) q,k,v[{n},{t},{h},{dh}]",
                  layers, layers, (q, k, v), dict(window=None),
                  4 * dh * n * h * seen_pairs(torch, t, t, None), 2 * 4 * n * t * h * dh,
                  BF16_TOL, PEAK_BF16))
    pos, s = SERVE_DENSE["long_pos"], SERVE_DENSE["long_max_len"]  # the timed decode's
    glob = torch.arange(s, **i32)
    glob[pos + 1:] = -1
    qp = torch.tensor([pos], **i32)
    qd, kc, vc = randn(n, 1, h, dh).to(bf), randn(n, s, h, dh), randn(n, s, h, dh)
    cases.append(("flash_attention", f"decode global {s} g1 (stablelm-1.6b) q bf16 "
                  f"[{n},1,{h},{dh}] fp32 cache[{n},{s},{h},{dh}] (per call: a serve_step)",
                  layers, 0, (qd, kc, vc), dict(window=None, q_positions=qp, k_positions=glob),
                  4 * dh * n * h * seen_pairs(torch, 1, s, None, qp, glob),
                  2 * 2 * n * h * dh + 4 * (2 * n * s * h * dh + s + 1), BF16_TOL, PEAK_BF16))
    nt, tt = TRAIN_LM["batch"], TRAIN_LM["seq"]
    q, k, v = (randn(nt, tt, h, dh).to(bf) for _ in range(3))
    cases.append(("flash_attention", f"train_lm bf16 g1 (stablelm-1.6b, the launcher's forward) "
                  f"q,k,v[{nt},{tt},{h},{dh}]", layers, layers, (q, k, v), dict(window=None),
                  4 * dh * nt * h * seen_pairs(torch, tt, tt, None), 2 * 4 * nt * tt * h * dh,
                  BF16_TOL, PEAK_BF16))
    nb, tb, L = LM_RUN["batch"], LM_RUN["seq"], LM_RUN["n_layers"]
    q, k, v = (randn(nb, tb, h, dh) for _ in range(3))
    cases.append(("flash_attention", f"lm_run fp32 g1 (stablelm-1.6b, forward of run) "
                  f"q,k,v[{nb},{tb},{h},{dh}]", L, L, (q, k, v), dict(window=None),
                  4 * dh * nb * h * seen_pairs(torch, tb, tb, None), 4 * 4 * nb * tb * h * dh,
                  TOL, PEAK_FLOPS))
    d, ff, vocab = 2048, 5632, 100352
    return cases + fused_dense_cases(
        torch, randn, "lm", nb, (("wq/wk/wv/wo", tb, d, d, 4 * L),
                                 ("w_gate/w_up", tb, d, ff, 2 * L), ("w_down", tb, ff, d, L),
                                 ("head", tb, d, vocab, 1)), LM_RUN["kfac_vocab"])


def fused_dense_cases(torch, randn, tag, nb, dense, kfac_vocab):
    """fused_first_order's and fused_second_order's rows at a model's Dense
    shapes ``dense`` ((name, R rows a sample, a, b, launches a sweep), the
    head named "head"), each weighted by its launches: the first-order
    sweep's l2, moment and dot; the MC sweep's diagonal (C = 1) at the full
    vocabulary; and diagonal with Kronecker factor at the KFAC run's
    (the head's b cut to ``kfac_vocab``)."""
    cases = []
    for name, r, a, b, per_call in dense:
        A, B = randn(nb, r, a), randn(nb, r, b)
        flops = 2 * nb * r * a * b + 3 * nb * a * b + nb * (nb - 1) * a * b
        cases.append(("fused_first_order", f"{tag} {name} A[{nb},{r},{a}] B[{nb},{r},{b}]",
                      per_call, per_call, (A, B),
                      dict(want_l2=True, want_moment=True, want_dot=True), flops,
                      4 * (nb * r * (a + b) + nb + a * b + nb * nb), TOL, PEAK_FLOPS,
                      2 * nb * r * a * b + nb * (nb - 1) * a * b))
        S = B[None]
        cases.append(("fused_second_order", f"{tag} {name} mc A[{nb},{r},{a}] S[1,{nb},{r},{b}]",
                      per_call, per_call, (A, S), dict(want_diag=True),
                      2 * nb * r * a * b + 2 * nb * a * b, 4 * (nb * r * (a + b) + a * b),
                      TOL, PEAK_FLOPS, 2 * nb * r * a * b))
        if name == "head":
            b = kfac_vocab
            A, S = randn(nb, r, a), randn(1, nb, r, b)
            name = f"head vocab {b}"
        else:
            A, S = randn(nb, r, a), randn(1, nb, r, b)
        cases.append(("fused_second_order", f"{tag} kfac {name} A[{nb},{r},{a}] S[1,{nb},{r},{b}]",
                      per_call, per_call, (A, S), dict(want_diag=True, want_kron=True),
                      2 * nb * r * a * b + 2 * nb * a * b + nb * r * b * (b + 1),
                      4 * (nb * r * (a + b) + a * b + b * b), TOL, PEAK_FLOPS,
                      2 * nb * r * a * b + nb * r * b * (b + 1)))
    return cases


def whisper_kernel_cases(torch):
    """whisper-tiny's rows (``WHISPER``), from a generator of their own (seed
    14): flash_attention at each shape of its paths, 6 heads of 64 with no
    GQA (g = 1), queries on 448 decoder positions and keys on 1500 frames.
    bf16 ("wgmma"): the encoder's non-causal self-attention (4 an encode,
    and 4 in the training launcher's forward), the decoder's causal
    self-attention (448 rows: 3.5 tiles of 128) and its non-causal
    cross-attention (448 queries against 1500 keys: 23 tiles of 64 and a
    tail of 28), 4 each a training forward; in decode ("split") the self
    attention against the float32 cache at position 447 and the cross
    attention against 1500 bf16 keys with no positions (4 each a
    serve_step, weight 0); in float32 ("simt") the three of ``run``'s
    forward (4 each).  fused_first_order and fused_second_order
    (``fused_dense_cases``) at each Dense shape of the sweep: R 1500 in the
    encoder and at the decoder's ``ck``/``cv``, R 448 elsewhere in the
    decoder and at the head (384 × 51865; KFAC's at 8192).  Operations and
    bytes as ``dense_kernel_cases`` counts them; a non-causal attention sees
    T·S pairs."""
    gen = torch.Generator(device="cuda").manual_seed(14)

    def randn(*shape):
        return torch.randn(*shape, device="cuda", generator=gen)

    cases = []
    n, s, t, h, dh = WHISPER["batch"], WHISPER["frames"], 448, 6, 64
    enc, dec = 4, 4
    bf, f32 = torch.bfloat16, torch.float32

    def attention(label, tq, tk, causal, q_dtype, kv_dtype, per_call, weight, tol, peak,
                  **kw):
        q = randn(n, tq, h, dh).to(q_dtype)
        k, v = randn(n, tk, h, dh).to(kv_dtype), randn(n, tk, h, dh).to(kv_dtype)
        pairs = (seen_pairs(torch, tq, tk, None, kw.get("q_positions"), kw.get("k_positions"))
                 if causal else tq * tk)
        nbytes = (q_dtype.itemsize * 2 * n * tq * h * dh + kv_dtype.itemsize * 2 * n * tk * h * dh
                  + (4 * (tk + 1) if "k_positions" in kw else 0))
        cases.append(("flash_attention", label, per_call, weight, (q, k, v),
                      dict(causal=causal, window=None, **kw), 4 * dh * n * h * pairs, nbytes, tol,
                      peak))

    for dtype, tag, tol, peak, why in ((bf, "bf16", BF16_TOL, PEAK_BF16, "training forward"),
                                       (f32, "fp32", TOL, PEAK_FLOPS, "forward of run")):
        attention(f"whisper {tag} encoder non-causal q,k,v[{n},{s},{h},{dh}] ({why})", s, s,
                  False, dtype, dtype, enc, enc, tol, peak)
        attention(f"whisper {tag} decoder self causal q,k,v[{n},{t},{h},{dh}] ({why})", t, t,
                  True, dtype, dtype, dec, dec, tol, peak)
        attention(f"whisper {tag} cross non-causal q[{n},{t},{h},{dh}] k,v[{n},{s},{h},{dh}] "
                  f"({why})", t, s, False, dtype, dtype, dec, dec, tol, peak)
    i32 = dict(device="cuda", dtype=torch.int32)
    attention(f"decode whisper self q bf16 [{n},1,{h},{dh}] fp32 cache[{n},{t},{h},{dh}] "
              f"at position {t - 1} (per call: a serve_step)", 1, t, True, bf, f32, dec, 0,
              BF16_TOL, PEAK_BF16, q_positions=torch.tensor([t - 1], **i32),
              k_positions=torch.arange(t, **i32))
    attention(f"decode whisper cross non-causal q bf16 [{n},1,{h},{dh}] bf16 "
              f"k,v[{n},{s},{h},{dh}] (per call: a serve_step)", 1, s, False, bf, bf, dec, 0,
              BF16_TOL, PEAK_BF16)
    # every Dense shape of the sweep (6 an encoder layer, 10 a decoder layer,
    # the head: 65), its launches a sweep
    d, ff = 384, 1536
    cases += fused_dense_cases(torch, randn, "whisper", n, (
        ("encoder wq/wk/wv/wo, decoder ck/cv", s, d, d, 4 * enc + 2 * dec),
        ("encoder w_up", s, d, ff, enc), ("encoder w_down", s, ff, d, enc),
        ("decoder wq/wk/wv/wo/cq/co", t, d, d, 6 * dec), ("decoder w1", t, d, ff, dec),
        ("decoder w2", t, ff, d, dec), ("head", t, d, 51865, 1)), WHISPER["kfac_vocab"])
    return cases


def moe_kernel_cases(torch):
    """Granite-3.0-1B-A400M's rows (``MOE``), from a generator of their own
    (seed 16): flash_attention with 16 query heads over 8 KV heads of 64 (g
    = 2) in bf16 prefill at 4 × 2048 ("wgmma", 24 a prefill call), in
    decode against the float32 cache at 32 cached tokens ("split", 24 a
    serve_step, weight 0) and in float32 at the run's 4 × 512 ("simt", 4);
    fused_first_order with the experts as its group axis, E = 32 × 640
    capacity slots × R = 1, SecondMoment's moment alone, at ``e_gate`` /
    ``e_up`` (1024 × 512, 2 a layer of the run) and ``e_down`` (512 × 1024,
    1 a layer), its library call ``torch.bmm`` of the squares (TF32 off);
    and every Dense shape of the run's sweep (R = 512, N = 4): ``wq``/``wo``
    (1024 × 1024, 2 a layer), ``wk``/``wv`` (1024 × 512, 2 a layer), the
    router (1024 × 32, 1 a layer) and the head (1024 × 49155, once; an odd
    b), fused_first_order's l2, moment and dot and fused_second_order's MC
    diagonal at the full vocabulary (``fused_dense_cases``), weighted by
    their 21 launches a sweep."""
    from repro_torch.nn.moe import capacity

    gen = torch.Generator(device="cuda").manual_seed(16)

    def randn(*shape):
        return torch.randn(*shape, device="cuda", generator=gen)

    cases = []
    d, h, kv, dh, e, de, L, vocab = 1024, 16, 8, 64, 32, 512, 24, 49155
    lr, nb, tb = MOE["run_layers"], MOE["batch"], MOE["seq"]
    bf, i32 = torch.bfloat16, dict(device="cuda", dtype=torch.int32)
    n, t = MOE["batch"], MOE["prefill_len"]
    q, k, v = randn(n, t, h, dh).to(bf), randn(n, t, kv, dh).to(bf), randn(n, t, kv, dh).to(bf)
    cases.append(("flash_attention", f"prefill bf16 g2 (granite-moe-1b-a400m) q[{n},{t},{h},{dh}] "
                  f"k,v[{n},{t},{kv},{dh}]", L, L, (q, k, v), dict(window=None),
                  4 * dh * n * h * seen_pairs(torch, t, t, None),
                  2 * (2 * n * t * h * dh + 2 * n * t * kv * dh), BF16_TOL, PEAK_BF16))
    s, pos = MOE["max_len"], MOE["prompt_len"]
    kp = torch.arange(s, **i32)
    kp[pos + 1:] = -1
    qp = torch.tensor([pos], **i32)
    cases.append(("flash_attention", f"decode g2 (granite-moe-1b-a400m) q bf16 [{n},1,{h},{dh}] "
                  f"fp32 cache[{n},{s},{kv},{dh}] at {pos} cached (per call: a serve_step)", L, 0,
                  (randn(n, 1, h, dh).to(bf), randn(n, s, kv, dh), randn(n, s, kv, dh)),
                  dict(window=None, q_positions=qp, k_positions=kp),
                  4 * dh * n * h * seen_pairs(torch, 1, s, None, qp, kp),
                  # q and out in bf16; K and V at the pos + 1 valid keys; the positions
                  2 * 2 * n * h * dh + 4 * (2 * n * (pos + 1) * kv * dh + s + 1),
                  BF16_TOL, PEAK_BF16))
    q, k, v = randn(nb, tb, h, dh), randn(nb, tb, kv, dh), randn(nb, tb, kv, dh)
    cases.append(("flash_attention", f"granite fp32 g2 (forward of run) q[{nb},{tb},{h},{dh}] "
                  f"k,v[{nb},{tb},{kv},{dh}]", lr, lr, (q, k, v), dict(window=None),
                  4 * dh * nb * h * seen_pairs(torch, tb, tb, None),
                  4 * (2 * nb * tb * h * dh + 2 * nb * tb * kv * dh), TOL, PEAK_FLOPS))
    cap = capacity(nb * tb, e, 8, 1.25)
    for name, a, b, per_call in (("e_gate/e_up", d, de, 2 * lr), ("e_down", de, d, lr)):
        A, B = randn(e, cap, 1, a), randn(e, cap, 1, b)
        cases.append(("fused_first_order", f"granite experts {name} moment E={e} "
                      f"A[{e},{cap},1,{a}] B[{e},{cap},1,{b}]", per_call, per_call, (A, B),
                      dict(want_l2=False, want_moment=True),
                      2 * e * cap * a * b + e * cap * (a + b),
                      4 * (e * cap * (a + b) + e * a * b), TOL, PEAK_FLOPS, 2 * e * cap * a * b))
    # every Dense shape of the sweep (q, k, v, o and the router a layer, the
    # head: 21), its launches a sweep; the run takes no KFAC
    return cases + [c for c in fused_dense_cases(torch, randn, "granite", nb, (
        ("wq/wo", tb, d, d, 2 * lr), ("wk/wv", tb, d, kv * dh, 2 * lr), ("router", tb, d, e, lr),
        ("head", tb, d, vocab, 1)), e) if " kfac " not in c[1]]


def mla_kernel_cases(torch):
    """DeepSeek-V2-Lite's rows (``MLA``), from a generator of their own (seed
    18): flash_attention at MLA's widths, 16 heads with q and k of 192 (128
    + the shared RoPE key's 64) and v of 128, in bf16 prefill at 4 × 2048
    ("wgmma", 27 a prefill call) and in float32 at the run's 4 × 512
    ("simt", 2); decode attention is the absorbed float32 einsums, no kernel.
    fused_first_order with the experts as its group axis, E = 64 × 240
    capacity slots × R = 1, SecondMoment's moment alone, at ``e_gate`` /
    ``e_up`` (2048 × 1408, 2 a layer of the run) and ``e_down`` (1408 ×
    2048, 1 a layer), its library call ``torch.bmm`` of the squares (TF32
    off); and every Dense shape of the run's sweep (R = 512, N = 4): ``dq``
    (2048 × 3072), ``dkv`` (2048 × 576), ``uk`` / ``uv`` (512 × 2048),
    ``wo`` (2048 × 2048), the router (2048 × 64), ``s_gate`` / ``s_up``
    (2048 × 2816), ``s_down`` (2816 × 2048) and the head (2048 × 102400,
    once), fused_first_order's l2, moment and dot and fused_second_order's
    MC diagonal (``fused_dense_cases``), weighted by their 19 launches a
    sweep."""
    from repro_torch.nn.moe import capacity

    gen = torch.Generator(device="cuda").manual_seed(18)

    def randn(*shape):
        return torch.randn(*shape, device="cuda", generator=gen)

    cases = []
    d, h, dh, dv, e, de, L, vocab = 2048, 16, 192, 128, 64, 1408, 27, 102400
    lr, nb, tb = MLA["run_layers"], MLA["batch"], MLA["seq"]
    for tag, dtype, n, t, per_call, tol, peak in (
            ("prefill bf16 mla", torch.bfloat16, MLA["batch"], MLA["prefill_len"], L, BF16_TOL,
             PEAK_BF16),
            ("deepseek fp32 mla (forward of run)", torch.float32, nb, tb, lr, TOL, PEAK_FLOPS)):
        q, k, v = (randn(n, t, h, w).to(dtype) for w in (dh, dh, dv))
        cases.append(("flash_attention", f"{tag} (deepseek-v2-lite-16b) q,k[{n},{t},{h},{dh}] "
                      f"v[{n},{t},{h},{dv}]", per_call, per_call, (q, k, v), dict(window=None),
                      2 * (dh + dv) * n * h * seen_pairs(torch, t, t, None),
                      dtype.itemsize * 2 * n * t * h * (dh + dv), tol, peak))
    cap = capacity(nb * tb, e, 6, 1.25)
    for name, a, b, per_call in (("e_gate/e_up", d, de, 2 * lr), ("e_down", de, d, lr)):
        A, B = randn(e, cap, 1, a), randn(e, cap, 1, b)
        cases.append(("fused_first_order", f"deepseek experts {name} moment E={e} "
                      f"A[{e},{cap},1,{a}] B[{e},{cap},1,{b}]", per_call, per_call, (A, B),
                      dict(want_l2=False, want_moment=True),
                      2 * e * cap * a * b + e * cap * (a + b),
                      4 * (e * cap * (a + b) + e * a * b), TOL, PEAK_FLOPS, 2 * e * cap * a * b))
    return cases + [c for c in fused_dense_cases(torch, randn, "deepseek", nb, (
        ("dq", tb, d, h * dh, lr), ("dkv", tb, d, 512 + 64, lr), ("uk/uv", tb, 512, h * 128, 2 * lr),
        ("wo", tb, h * dv, d, lr), ("router", tb, d, e, lr), ("s_gate/s_up", tb, d, 2 * de, 2 * lr),
        ("s_down", tb, 2 * de, d, lr), ("head", tb, d, vocab, 1)), e) if " kfac " not in c[1]]


def expert_moment_library(torch):
    """The library call for fused_first_order's expert rows (R = 1,
    moment alone): ``torch.bmm`` of the squares, (A∘A)ᵀ(B∘B) per expert."""
    def moment(A, B, **_):
        return {"moment": torch.bmm(A[:, :, 0].square().transpose(1, 2), B[:, :, 0].square())}
    return moment


def dense_heads_phase(torch, ops):
    """The other dense configs at full width and reduced depth
    (``DENSE_HEADS``), bf16 weights drawn on the card: one prefill call of
    2 × 1024 tokens (flash_attention once a layer, nothing else: the "wgmma"
    design at CodeQwen's dh 128, Gemma-3's 240, H2O-Danube3's 120 and
    InternVL2's 128 behind a 256-row image prefix), greedy decode from a
    16-token prompt to 20 (once a layer a serve_step); then in float32 the
    card against the CPU at batch 1, T 64 (``TOL``) and a 64-token decode
    chain against the forward (``CHAIN_TOL``)."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.core.tree import tree_map
    from repro_torch.kernels import flash_attention as fa_mod
    from repro_torch.nn.models import build_model
    from repro_torch.serve import ServeConfig, generate
    from repro_torch.train import make_prefill_step

    out = {}
    run_ = DENSE_HEADS_RUN
    for arch, cut in DENSE_HEADS.items():
        full = get_config(arch)
        cfg = dataclasses.replace(full, **cut)
        t0 = time.perf_counter()
        model = build_model(cfg, device="cuda",
                            generator=torch.Generator(device="cuda").manual_seed(0))
        params = model.params()
        torch.cuda.synchronize()
        build_s = time.perf_counter() - t0
        gen = torch.Generator(device="cuda").manual_seed(8)
        n, t = run_["batch"], run_["prefill_len"]

        def inputs(n, t, dtype):
            toks = torch.randint(0, cfg.vocab, (n, t), device="cuda", generator=gen)
            if cfg.frontend != "vision":
                return toks
            prefix = torch.randn(n, cfg.n_prefix, cfg.d_model, device="cuda", generator=gen)
            return {"tokens": toks, "prefix": prefix.to(dtype)}

        x = inputs(n, t - cfg.n_prefix, torch.bfloat16)
        per_layer = {k: cfg.n_layers if k == "flash_attention" else 0 for k in ops.KERNELS}
        step = make_prefill_step(model)
        torch.cuda.synchronize()
        ops.reset_launch_counts()
        last = step(params, x)
        torch.cuda.synchronize()
        launches = ops.launch_counts()
        h, kv = cfg.n_heads, cfg.kv_heads
        dh = cfg.head_dim or cfg.d_model // h
        probe = torch.empty((n, t, h, dh), device="cuda", dtype=torch.bfloat16)
        kprobe = torch.empty((n, t, kv, dh), device="cuda", dtype=torch.bfloat16)
        design = fa_mod.design(probe, kprobe, kprobe)
        del probe, kprobe
        t0 = time.perf_counter()
        step(params, x)
        torch.cuda.synchronize()
        prefill_ms = (time.perf_counter() - t0) * 1e3
        prompts = torch.randint(0, cfg.vocab, (n, run_["prompt_len"]), device="cuda",
                                generator=gen)
        ops.reset_launch_counts()
        toks = generate(model, params, prompts, ServeConfig(max_len=run_["max_len"]))
        torch.cuda.synchronize()
        gen_launches = ops.launch_counts()
        if launches != per_layer or design != "wgmma":
            fail(f"{arch} prefill launched {launches} (design {design}), not "
                 f"{cfg.n_layers} flash_attention on 'wgmma'")
        if gen_launches != {k: v * run_["max_len"] for k, v in per_layer.items()}:
            fail(f"{arch} generate launched {gen_launches}, not {cfg.n_layers} a serve_step")
        if not torch.isfinite(last.float()).all() or tuple(toks.shape) != (n, run_["max_len"]):
            fail(f"{arch}: non-finite prefill logits or wrong tokens {tuple(toks.shape)}")
        # float32: the card against the CPU, and the decode chain against the forward
        params32 = tree_map(lambda p: p.float(), params)
        del params, last
        xs = inputs(1, run_["cpu_len"], torch.float32)
        card = model.call(params32, xs)
        cpu_params = tree_map(lambda p: p.cpu(), params32)
        xs_cpu = tree_map(lambda a: a.cpu(), xs)
        t0 = time.perf_counter()
        cpu = model.call(cpu_params, xs_cpu)
        cpu_s = time.perf_counter() - t0
        cpu_err = ((card.cpu() - cpu).abs().max() / cpu.abs().max()).item()
        del cpu_params, cpu, card
        seq = torch.randint(0, cfg.vocab, (1, run_["chain_len"]), device="cuda", generator=gen)
        caches = model.init_serve_cache(params32, 1, run_["chain_len"], torch.float32)
        chain = []
        for i in range(run_["chain_len"]):
            logits, caches = model.serve_step(params32, caches, seq[:, i], i)
            chain.append(logits[0])
        # decode embeds tokens alone: the forward it matches has no image rows
        fwd = model.call(params32, seq if cfg.frontend != "vision" else {
            "tokens": seq, "prefix": torch.zeros((1, 0, cfg.d_model), device="cuda")})[0]
        chain_err = ((torch.stack(chain) - fwd).abs().max() / fwd.abs().max()).item()
        row = dict(arch=arch, cut=cut, layers=cfg.n_layers, d_model=cfg.d_model, heads=h,
                   kv_heads=kv, head_dim=dh, vocab=cfg.vocab, build_s=build_s,
                   param_count=cfg.param_count(model), prefill=[n, t], design=design,
                   prefill_ms=prefill_ms, launches=launches, generate_launches=gen_launches,
                   card_vs_cpu_rel_err=cpu_err, cpu_forward_s=cpu_s, tol=TOL,
                   chain_vs_forward_rel_err=chain_err, chain_tol=CHAIN_TOL)
        out[arch] = row
        say("dense_heads", **row)
        del params32, caches, chain, fwd, model
        torch.cuda.empty_cache()
        if not cpu_err <= TOL:
            fail(f"{arch} card vs CPU logits: {cpu_err:.3e} above {TOL}")
        if not chain_err <= CHAIN_TOL:
            fail(f"{arch} decode chain vs forward: {chain_err:.3e} above {CHAIN_TOL}")
    out["launches"] = {k: sum(r["launches"][k] + r["generate_launches"][k]
                              for r in out.values()) for k in ops.KERNELS}
    return out


def _counts(ops, **want):
    return {k: want.get(k, 0) for k in ops.KERNELS}


def _card_gen(torch, seed):
    return torch.Generator(device="cuda").manual_seed(seed)


def _cut_params(torch, params, layers):
    """A ``CausalLM``'s weights with the first ``layers`` of its stacked layers."""
    from repro_torch.core.tree import tree_map

    return tuple(tree_map(lambda p: p[:layers], p) if i == 1 else p
                 for i, p in enumerate(params))


def _nbytes(tree):
    from repro_torch.core.tree import tree_leaves

    return sum(p.numel() * p.element_size() for p in tree_leaves(tree))


def _timed_decode(torch, ops, model, params, caches, logits, pos, steps, tag, want, **meta):
    """``steps`` timed decode steps from position ``pos`` (their launches read
    and held to ``want`` a step), then one profiled: a row printed under
    ``tag`` and returned."""
    from repro_torch.train import make_decode_step

    decode = make_decode_step(model)
    step_s = []
    ops.reset_launch_counts()
    for _ in range(steps):
        tok = logits.argmax(-1).int()
        t0 = time.perf_counter()
        logits, caches = decode(params, caches, tok, pos)
        torch.cuda.synchronize()
        step_s.append(time.perf_counter() - t0)
        pos += 1
    launches = ops.launch_counts()
    tok = logits.argmax(-1).int()
    prof = profiled(lambda: decode(params, caches, tok, pos), groups={"attention": "flash_"})
    row = dict(**meta, step_s=step_s, launches=launches,
               ms_per_token=medians_ms({"d": step_s})["d"], wall_ms=prof["wall_ms"],
               device_ms=prof["device_ms"], attention_device_ms=prof["attention_device_ms"],
               idle_share=1 - prof["device_ms"] / prof["wall_ms"], top=prof["top"][:8])
    say(tag, **row)
    if launches != {k: v * steps for k, v in want.items()} or not torch.isfinite(logits).all():
        fail(f"{tag}: launched {launches}, not {want} a step, or non-finite logits")
    return row


def _moe_serving(torch, ops, cfg, spec, tag, dense_per_layer, step_attention, **model_meta):
    """A mixture of experts served in bf16 at full depth, weights drawn on the
    card: ``make_prefill_step`` on ``spec``'s prompts (flash_attention once a
    layer, nothing else; the pairs each layer drops, by ``_drop_spy``),
    tokens/s, profiled; greedy ``generate`` (``step_attention``
    flash_attention launches a serve_step); decode timed at the prompt's
    length.  Returns (rows, model, params)."""
    from repro_torch.core.module import Dense
    from repro_torch.nn.layers import BatchedDense
    from repro_torch.nn.models import build_model
    from repro_torch.nn.moe import capacity
    from repro_torch.serve import ServeConfig, generate, prefill
    from repro_torch.train import make_prefill_step

    out = {}
    L, E, top_k = cfg.n_layers, cfg.n_experts, cfg.top_k
    gen = _card_gen(torch, spec["seed"])
    t0 = time.perf_counter()
    model = build_model(cfg, device="cuda", generator=_card_gen(torch, 0))
    params = model.params()
    torch.cuda.synchronize()
    dense, experts = _layers_of(model, Dense), _layers_of(model, BatchedDense)
    out["model"] = dict(arch=cfg.name, dtype=cfg.dtype, layers=L, d_model=cfg.d_model,
                        heads=cfg.n_heads, experts=E, top_k=top_k, d_expert=cfg.d_expert,
                        capacity_factor=cfg.capacity_factor, vocab=cfg.vocab,
                        param_count=cfg.param_count(model),
                        active_param_count=cfg.active_param_count(model),
                        param_bytes=_nbytes(params), build_s=time.perf_counter() - t0,
                        dense_layers=dense, batched_dense_layers=experts, **model_meta)
    say(f"{tag}_model", **out["model"])
    # the head and ``dense_per_layer`` Dense a layer; three expert layers a layer
    if dense != dense_per_layer * L + 1 or experts != 3 * L:
        fail(f"{tag}: {dense} Dense and {experts} BatchedDense layers in the tree, not "
             f"{dense_per_layer * L + 1} and {3 * L}")
    n, t_pre = spec["batch"], spec["prefill_len"]
    prompts = torch.randint(0, cfg.vocab, (n, t_pre), device="cuda", generator=gen)
    prefill_step = make_prefill_step(model)
    seen, unpatch = _drop_spy()
    try:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        ops.reset_launch_counts()
        last = prefill_step(params, prompts)
        torch.cuda.synchronize()
        launches = ops.launch_counts()
    finally:
        unpatch()
    if launches != _counts(ops, flash_attention=L):
        fail(f"{tag} prefill must launch {_counts(ops, flash_attention=L)}, got {launches}")
    if tuple(last.shape) != (n, cfg.vocab) or not torch.isfinite(last.float()).all():
        fail(f"{tag} prefill: logits {tuple(last.shape)} not finite [N, V]")
    if [r["capacity"] for r in seen] != [capacity(n * t_pre, E, top_k, cfg.capacity_factor)] * L:
        fail(f"{tag} prefill: capacities {seen}")
    times = []
    for _ in range(3):
        t0 = time.perf_counter()
        prefill_step(params, prompts)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    ms = medians_ms({"p": times})["p"]
    prof = profiled(lambda: prefill_step(params, prompts), groups={"attention": "flash_"})
    out["prefill"] = dict(batch=n, prompt_len=t_pre, capacity=seen[0]["capacity"],
                          dropped_per_layer=[r["dropped"] for r in seen],
                          pairs_per_layer=n * t_pre * top_k, launches=launches, step_s=times,
                          ms=ms, tokens_per_s=n * t_pre / ms * 1e3,
                          max_memory_allocated=torch.cuda.max_memory_allocated(),
                          wall_ms=prof["wall_ms"], device_ms=prof["device_ms"],
                          attention_device_ms=prof["attention_device_ms"],
                          idle_share=1 - prof["device_ms"] / prof["wall_ms"], top=prof["top"][:8])
    say(f"{tag}_prefill", **out["prefill"])

    short = prompts[:, :spec["prompt_len"]].contiguous()
    sc = ServeConfig(max_len=spec["max_len"])
    torch.cuda.synchronize()
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    toks = generate(model, params, short, sc)
    torch.cuda.synchronize()
    gen_s = time.perf_counter() - t0
    gen_launches = ops.launch_counts()
    if gen_launches != _counts(ops, flash_attention=step_attention * sc.max_len):
        fail(f"{tag} generate must launch flash_attention {step_attention} a serve_step "
             f"({sc.max_len} steps), got {gen_launches}")
    if (tuple(toks.shape) != (n, sc.max_len) or not torch.equal(toks[:, :short.shape[1]],
                                                                 short.int())
            or toks.min() < 0 or toks.max() >= cfg.vocab):
        fail(f"{tag} generate: tokens {tuple(toks.shape)} are not the prompts and a continuation")
    out["generate"] = dict(batch=n, prompt_len=short.shape[1], max_len=sc.max_len, s=gen_s,
                           ms_per_serve_step=gen_s / sc.max_len * 1e3, launches=gen_launches,
                           first_row=toks[0, short.shape[1]:short.shape[1] + 16].tolist())
    say(f"{tag}_generate", **out["generate"])

    caches = model.init_serve_cache(params, n, sc.max_len, torch.float32)
    caches, logits = prefill(model, params, caches, short, short.shape[1])
    cap = capacity(n, E, top_k, cfg.capacity_factor)
    out["decode"] = _timed_decode(torch, ops, model, params, caches, logits, short.shape[1],
                                  spec["decode_steps"], f"{tag}_decode",
                                  _counts(ops, flash_attention=step_attention), batch=n,
                                  cached=short.shape[1], layers=L, capacity=cap)
    if cap < n:
        fail(f"{tag} decode: capacity {cap} below the step's {n} tokens")
    return out, model, params


def _moe_agreement(torch, cfg, spec, tag, layers):
    """In float32 at capacity factor E / top_k on ``layers`` layers, weights
    drawn on the card: the forward drops nothing (asserted), the serve_step
    chain over ``spec["chain_len"]`` tokens against it (``CHAIN_TOL``), and
    the first ``spec["cpu_layers"]`` layers card against CPU (``TOL``)."""
    import dataclasses

    from repro_torch.core.tree import tree_map
    from repro_torch.nn.models import build_model

    gen = _card_gen(torch, spec["seed"] + 1)
    ccfg = dataclasses.replace(cfg, dtype="float32", capacity_factor=cfg.n_experts / cfg.top_k,
                               n_layers=layers)
    model = build_model(ccfg, device="cuda", generator=_card_gen(torch, 0))
    params = model.params()
    seq = torch.randint(0, cfg.vocab, (1, spec["chain_len"]), device="cuda", generator=gen)
    seen, unpatch = _drop_spy()
    try:
        full = model.call(params, seq)[0]
    finally:
        unpatch()
    drops = [r["dropped"] for r in seen]
    caches = model.init_serve_cache(params, 1, spec["chain_len"], torch.float32)
    chain = torch.empty_like(full)
    t0 = time.perf_counter()
    for t in range(spec["chain_len"]):
        step_logits, caches = model.serve_step(params, caches, seq[:, t], t)
        chain[t] = step_logits[0]
    torch.cuda.synchronize()
    chain_s = time.perf_counter() - t0
    chain_err = _rel(chain, full)
    del chain, caches, full
    cut = build_model(dataclasses.replace(ccfg, n_layers=spec["cpu_layers"]), device="meta")
    cparams = _cut_params(torch, params, spec["cpu_layers"])
    card = cut.call(cparams, seq)
    t0 = time.perf_counter()
    cpu = cut.call(tree_map(lambda p: p.cpu(), cparams), seq.cpu())
    cpu_s = time.perf_counter() - t0
    cpu_err = _rel(card.cpu(), cpu)
    del card, cpu, cparams, params, model
    torch.cuda.empty_cache()
    row = dict(capacity_factor=ccfg.capacity_factor, capacity=seen[0]["capacity"],
               chain_len=spec["chain_len"], chain_layers=layers,
               forward_dropped_per_layer=drops, chain_s=chain_s,
               chain_vs_forward_rel_err=chain_err, chain_tol=CHAIN_TOL,
               cpu_layers=spec["cpu_layers"], card_vs_cpu_rel_err=cpu_err, cpu_forward_s=cpu_s,
               cpu_tol=TOL)
    say(f"{tag}_agreement", **row)
    if any(drops) or len(drops) != layers:
        fail(f"{tag} chain: the forward at capacity factor {ccfg.capacity_factor} dropped "
             f"{drops}")
    if not chain_err <= CHAIN_TOL:
        fail(f"{tag} decode chain vs forward: {chain_err:.3e} above {CHAIN_TOL}")
    if not cpu_err <= TOL:
        fail(f"{tag} card vs CPU logits: {cpu_err:.3e} above {TOL}")
    return row


def _moe_run(torch, ops, cfg, spec, tag):
    """BackPACK ``run`` in float32 on ``spec["run_layers"]`` layers at
    ``spec["batch"]`` × ``spec["seq"]`` tokens, the first-order extensions
    and DiagGGN-MC: fused_first_order once a Dense and once a BatchedDense
    (its experts the group axis), fused_second_order once a Dense,
    flash_attention once a layer, nothing else.  The result's float32 bytes
    reckoned before, the peak read after; the gradient against autograd, Σ_n
    batch_grad against it, BatchL2, BatchDot and SecondMoment off the
    experts against their float64 formula on batch_grad (``F64_TOL``), the
    experts' moments (a spy on ``BatchedDense.backward``) against float64;
    then, with no result kept (two of DeepSeek's do not fit beside each
    other), timed and profiled; the reduced config card against CPU with the
    MC draws passed in.  Returns (the run's row, the card-vs-CPU errors)."""
    import dataclasses

    from repro_torch.core import CrossEntropyLoss, ExtensionConfig, by_name, run
    from repro_torch.core.module import Dense
    from repro_torch.core.tree import tree_leaves, tree_map
    from repro_torch.nn.layers import BatchedDense
    from repro_torch.nn.models import build_model
    from repro_torch.nn.moe import capacity

    loss = CrossEntropyLoss()
    gen = _card_gen(torch, spec["seed"] + 2)
    E, top_k = cfg.n_experts, cfg.top_k

    def model32(reduced=False):
        c = dataclasses.replace(cfg.reduced() if reduced else cfg, dtype="float32",
                                **({} if reduced else dict(n_layers=spec["run_layers"])))
        m = build_model(c, device="cuda", generator=_card_gen(torch, 1))
        return c, m, m.params()

    def batch(c, nb, t, masked):
        toks = torch.randint(0, c.vocab, (nb, t), device="cuda", generator=gen)
        labels = torch.randint(0, c.vocab, (nb, t), device="cuda", generator=gen)
        labels.view(-1)[torch.randperm(labels.numel(), device="cuda", generator=gen)[:masked]] = -1
        draws = torch.randint(0, c.vocab, (1, nb, t), device="cuda", generator=gen)
        return toks, labels, draws

    rcfg, model, params = model32()
    nr, tr, lr = spec["batch"], spec["seq"], rcfg.n_layers
    toks, labels, draws = batch(rcfg, nr, tr, spec["masked"])
    names = LM_FIRST + ("diag_ggn_mc",)
    exts = tuple(by_name(e) for e in names)
    fused = ExtensionConfig(mc_samples=1)
    rdense, rexperts = _layers_of(model, Dense), _layers_of(model, BatchedDense)
    want = _counts(ops, fused_first_order=rdense + rexperts, fused_second_order=rdense,
                   flash_attention=lr)
    # the result's float32 copies: the gradient, SecondMoment, Variance and
    # DiagGGN-MC of every parameter, BatchGrad (N of them) off the experts,
    # which carry no per-sample entry
    pbytes = _nbytes(params)
    ebytes = sum(_nbytes(p) for k, p in params[1].items() if k.startswith("e_"))
    reckoned = 4 * pbytes + nr * (pbytes - ebytes)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    res = run(model, params, toks, labels, loss, extensions=exts, cfg=fused, rng=draws)
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t0
    launches = ops.launch_counts()
    peak = torch.cuda.max_memory_allocated() - base
    if launches != want:
        fail(f"{tag} run launched {launches}, derived {want}")
    # the experts' moments at the path's own data against float64 (a spy on
    # BatchedDense.backward: the kernel's moment and the tape's x and g)
    real_backward, moments = BatchedDense.backward, []

    def backward_spy(self, p, tape, g, exts_, cfg_):
        g_in, grads, stats = real_backward(self, p, tape, g, exts_, cfg_)
        want64 = (tape.double().square().transpose(1, 2) @ g.double().square())
        moments.append(f64_readings(torch, "fused_first_order",
                                    {"moment": stats["_sum_grad2"]["w"]}, {"moment": want64}))
        return g_in, grads, stats

    BatchedDense.backward = backward_spy
    try:
        run(model, params, toks, labels, loss, extensions=(by_name("second_moment"),),
            cfg=fused)
    finally:
        BatchedDense.backward = real_backward
    moment64 = {k: max(m[k] for m in moments) for k in ("rel64", "entry_median")}
    tracked = tree_map(lambda p: p.detach().clone().requires_grad_(True), params)
    with torch.enable_grad():
        auto = torch.autograd.grad(loss.value(model.call(tracked, toks), labels),
                                   tree_leaves(tracked))
    del tracked
    grad_err = max(_rel(a, b) for a, b in zip(tree_leaves(res.grads), auto, strict=True))
    grads = _by_path(res.grads)
    bgs = _by_path(res.ext["batch_grad"])  # the experts have none, as in JAX
    sum_err = max(_rel(bg.sum(0), grads[k]) for k, bg in bgs.items())
    moment = _by_path(res.ext["second_moment"])
    exact64 = _vs_float64_of_batch_grad(torch, list(bgs.values()), res,
                                        moments=[moment[k] for k in bgs])
    # Variance ≥ 0 off the experts: theirs is JAX's N·Σ_slots g² − (Σ g)², a
    # token-level sum against the sequence count N, below 0 where more than N
    # slots of an expert carry a gradient (as in JAX)
    var_min = min((v.min() / moment[k].abs().max()).item()
                  for k, v in _by_path(res.ext["variance"]).items() if "/e_" not in k)
    mc_min = min(v.min().item() for v in tree_leaves(res.ext["diag_ggn_mc"]))
    finite = all(torch.isfinite(v).all() for v in tree_leaves(res.ext))
    layer = res.ext["second_moment"][1]
    expert_shapes = {k: list(layer[k]["w"].shape) for k in ("e_gate", "e_up", "e_down")}
    no_expert_batch_grad = all(res.ext["batch_grad"][1][k] == () for k in expert_shapes)
    del auto, res, grads, moment, bgs
    torch.cuda.empty_cache()
    step_s = []
    for _ in range(2):
        t0 = time.perf_counter()
        run(model, params, toks, labels, loss, extensions=exts, cfg=fused, rng=draws)
        torch.cuda.synchronize()
        step_s.append(time.perf_counter() - t0)
    prof = profiled(lambda: run(model, params, toks, labels, loss, extensions=exts, cfg=fused,
                                rng=draws),
                    groups=TRAIN_GROUPS, ranges={"attention_backward": "flash_attention_backward"})
    prof["idle_share"] = 1 - prof["device_ms"] / prof["wall_ms"]
    row = dict(arch=rcfg.name, layers=lr, batch=nr, seq=tr, masked=spec["masked"],
               vocab=rcfg.vocab, capacity=capacity(nr * tr, E, top_k, cfg.capacity_factor),
               extensions=names, param_bytes=pbytes, expert_bytes=ebytes,
               reckoned_result_bytes=reckoned, first_call_s=first_s, step_s=step_s,
               ms=medians_ms({"s": step_s})["s"], peak_bytes_above_start=peak,
               launches=launches, launches_derived=want, expert_launches=rexperts,
               wall_ms=prof["wall_ms"], device_ms=prof["device_ms"],
               idle_share=prof["idle_share"],
               split_device_ms={k: prof[f"{k}_device_ms"] for k in (
                   *TRAIN_GROUPS, "attention_backward")},
               top=prof["top"][:8], grads_vs_autograd=grad_err,
               batch_grad_sum_vs_grads=sum_err, vs_float64_of_batch_grad=exact64,
               variance_min_over_second_moment=var_min, diag_ggn_mc_min=mc_min,
               finite=bool(finite), expert_second_moment_shapes=expert_shapes,
               expert_moment_vs_float64=moment64, f64_tol=F64_TOL, entry_tol=ENTRY_TOL,
               tol=TOL)
    say(f"{tag}_run", **row)
    if not grad_err <= TOL or not sum_err <= TOL:
        fail(f"{tag} run: grads vs autograd {grad_err:.3e}, Σ batch_grad vs grads "
             f"{sum_err:.3e} (limit {TOL})")
    if max(e for e, _ in exact64.values()) > F64_TOL:
        fail(f"{tag} run against float64 of batch_grad: {exact64} (limit {F64_TOL})")
    if not (finite and var_min >= -1e-6 and mc_min >= 0 and no_expert_batch_grad):
        fail(f"{tag} run: non-finite, or variance {var_min:.3e} or diag_ggn_mc {mc_min:.3e} "
             "below 0, or an expert BatchGrad entry")
    if expert_shapes["e_gate"] != [lr, E, cfg.d_model, cfg.d_expert]:
        fail(f"{tag} run: expert SecondMoment shapes {expert_shapes}")
    if len(moments) != rexperts or not (moment64["rel64"] <= F64_TOL
                                        and moment64["entry_median"] <= ENTRY_TOL):
        fail(f"{tag} run: the experts' moments against float64 {moment64} "
             f"({len(moments)} of {rexperts} read)")
    del model, params, toks
    torch.cuda.empty_cache()

    # the reduced config, card against CPU, the draws passed in
    ccfg, model, params = model32(reduced=True)
    toks, labels, draws = batch(ccfg, spec["cpu_batch"], spec["cpu_seq"], 3)
    cnames = names + ("kfac",)
    cexts = tuple(by_name(e) for e in cnames)
    card = run(model, params, toks, labels, loss, extensions=cexts, cfg=fused, rng=draws)
    cpu = run(model, tree_map(lambda p: p.cpu(), params), toks.cpu(), labels.cpu(), loss,
              extensions=cexts, cfg=fused, rng=draws.cpu())
    errs = _ext_errs(card, cpu, cnames)
    say(f"{tag}_run_card_vs_cpu", reduced=True, rel_err=errs, tol=TOL)
    if max(errs.values()) > TOL:
        fail(f"{tag} run reduced card vs CPU: {errs}")
    return row, errs


def _phase_launches(out, *rows):
    """A phase's launches: the counted prefill call's, generate's, the
    decode rows' and those of ``rows``."""
    rows = (out["prefill"], out["generate"], *rows)
    return {k: sum(r["launches"][k] for r in rows) for k in out["prefill"]["launches"]}


def moe_phase(torch, ops):
    """Granite-3.0-1B-A400M (``MOE``), the mixture of experts, at full width
    through the entry points a user calls, random weights drawn on the card,
    each call with the launch counts set to 0 just before and read just
    after, against the counts derived from the module tree:

    * serving in bf16 at full depth (``_moe_serving``): ``make_prefill_step``
      on 4 × 2048 tokens (flash_attention once a layer, nothing else; the
      (token, slot) pairs each layer drops at capacity 2560), tokens/s,
      profiled; greedy ``generate`` from 4 prompts of 32 tokens to 128
      (flash_attention once a layer a serve_step); 16 decode steps timed at
      32 cached tokens and one profiled (device ms, idle share);
    * in float32 at capacity factor E / top_k (``_moe_agreement``): the
      serve_step chain over 64 tokens against the forward at full depth,
      and 2 of the 24 layers card against CPU;
    * BackPACK ``run`` in float32 on 4 layers at 4 × 512 tokens
      (``_moe_run``) and the reduced config card against CPU;
    * the training launcher in bf16 at full depth, 4 × 512, AdamW and
      DiagGGN-MC with ``--track-variance`` (``launcher_runs``)."""
    from repro_torch.configs import get_config
    from repro_torch.nn.moe import capacity

    spec = MOE
    cfg = get_config(spec["arch"])
    L, n = cfg.n_layers, spec["batch"]
    # q, k, v, o and the router a layer
    out, model, params = _moe_serving(torch, ops, cfg, spec, "moe", 5, L,
                                      kv_heads=cfg.kv_heads)
    dense, experts = out["model"]["dense_layers"], out["model"]["batched_dense_layers"]
    del model, params
    torch.cuda.empty_cache()
    out["agreement"] = _moe_agreement(torch, cfg, spec, "moe", L)
    out["run"], out["run_card_vs_cpu"] = _moe_run(torch, ops, cfg, spec, "moe")
    mc = _counts(ops, flash_attention=L, fused_first_order=dense + experts,
                 fused_second_order=dense)
    out["launcher"] = launcher_runs(
        torch, ops, "moe_train", ["--arch", spec["arch"], "--full", "--seq", str(spec["seq"]),
                                  "--batch", str(n)], (
            ("adamw", spec["adamw_steps"], [], _counts(ops, flash_attention=L)),
            ("diag_ggn_mc", spec["mc_steps"], ["--track-variance"], mc)),
        dict(layers=L, experts=cfg.n_experts, top_k=cfg.top_k, dtype=cfg.dtype, batch=n,
             seq=spec["seq"],
             capacity=capacity(n * spec["seq"], cfg.n_experts, cfg.top_k, cfg.capacity_factor)))
    out["launches"] = _phase_launches(out, out["decode"], out["run"],
                                      *out["launcher"].values())
    return out


def mla_phase(torch, ops):
    """DeepSeek-V2-Lite (``MLA``), MLA attention over a compressed cache with
    routed and shared experts, at full width through the entry points a
    user calls, random weights drawn on the card, each call with the launch
    counts set to 0 just before and read just after, against the counts
    derived from the module tree:

    * serving in bf16 at full depth (``_moe_serving``): ``make_prefill_step``
      on 4 × 2048 tokens (flash_attention once a layer at q, k 192 and v
      128, nothing else; the pairs each layer drops at capacity 960),
      tokens/s, profiled; greedy ``generate`` from 4 prompts of 32 tokens to
      128 and 16 decode steps timed at 32 cached tokens, one profiled: no
      kernel a serve_step, the absorbed decode is float32 einsums; 16 decode
      steps at 1500 cached tokens on 4 of the layers, the compressed cache
      written directly;
    * in float32 at capacity factor E / top_k (``_moe_agreement``): the
      absorbed serve_step chain over 64 tokens on 4 layers against the
      unabsorbed forward, and 2 layers card against CPU;
    * BackPACK ``run`` in float32 on 2 layers at 4 × 512 tokens
      (``_moe_run``) and the reduced config card against CPU;
    * training in bf16 at full width on 4 layers through ``fit`` with the
      launcher's ``make_optimizer``: AdamW, and DiagGGN-MC with Variance
      (``launcher_runs``); KFAC refused on the stacked per-expert factors;
      the training launcher itself on the reduced config."""
    import dataclasses

    from repro_torch.configs import SHAPES, get_config
    from repro_torch.core.module import Dense
    from repro_torch.launch import train as train_launch
    from repro_torch.nn.layers import BatchedDense
    from repro_torch.nn.models import build_model
    from repro_torch.nn.moe import capacity
    from repro_torch.train import loop as loop_mod

    spec = MLA
    cfg = get_config(spec["arch"])
    L, E, top_k, n = cfg.n_layers, cfg.n_experts, cfg.top_k, spec["batch"]
    # dq, dkv, uk, uv, wo, the router and the shared experts' three a layer
    out, model, params = _moe_serving(
        torch, ops, cfg, spec, "mla", 9, 0, kv_lora=cfg.kv_lora, qk_nope=cfg.qk_nope,
        qk_rope=cfg.qk_rope, v_head_dim=cfg.v_head_dim, shared_experts=cfg.n_shared_experts)
    # 1500 cached tokens on 4 layers: the compressed cache written directly
    gen = _card_gen(torch, spec["seed"] + 3)
    lmodel = build_model(dataclasses.replace(cfg, n_layers=spec["long_layers"]), device="meta")
    lparams = _cut_params(torch, params, spec["long_layers"])
    caches = lmodel.init_serve_cache(lparams, n, spec["long_len"], torch.float32)
    c, k = caches[0], spec["long_cached"]
    c["ckv"][:, :, :k] = torch.randn(c["ckv"][:, :, :k].shape, device="cuda", generator=gen)
    c["kpe"][:, :, :k] = torch.randn(c["kpe"][:, :, :k].shape, device="cuda", generator=gen)
    c["pos"][:, :k] = torch.arange(k, device="cuda", dtype=torch.int32)
    logits = torch.randn(n, cfg.vocab, device="cuda", generator=gen)
    out["decode_long"] = _timed_decode(
        torch, ops, lmodel, lparams, caches, logits, k, spec["decode_steps"], "mla_decode_long",
        _counts(ops), batch=n, cached=k, layers=spec["long_layers"],
        cache_slots=spec["long_len"],
        cache_bytes_per_layer=_nbytes({"ckv": c["ckv"][0], "kpe": c["kpe"][0]}))
    del caches, c, logits, params, model, lparams, lmodel
    torch.cuda.empty_cache()
    out["agreement"] = _moe_agreement(torch, cfg, spec, "mla", spec["chain_layers"])
    out["run"], out["run_card_vs_cpu"] = _moe_run(torch, ops, cfg, spec, "mla")

    # -- training, bf16, full width, cut in depth, through fit ----------------------------
    tcfg = dataclasses.replace(cfg, n_layers=spec["train_layers"])
    shape = dataclasses.replace(SHAPES["train_4k"], seq_len=spec["seq"], global_batch=n)
    tmeta = build_model(tcfg, device="meta")
    tdense, texperts = _layers_of(tmeta, Dense), _layers_of(tmeta, BatchedDense)

    def fit_cut(opt, steps, extra):
        model = build_model(tcfg, device="cuda", generator=_card_gen(torch, 0))
        kw = train_launch.make_optimizer(opt, model,
                                         track_variance="--track-variance" in extra)
        params, _, hist, _ = loop_mod.fit(model, tcfg, shape, kw.pop("opt"),
                                          loop_mod.LoopConfig(steps=steps, log_every=10), **kw)
        return dict(model=model, params=params, history=hist)

    lt = tcfg.n_layers
    out["train"] = launcher_runs(
        torch, ops, "mla_train", [], (
            ("adamw", spec["adamw_steps"], [], _counts(ops, flash_attention=lt)),
            ("diag_ggn_mc", spec["mc_steps"], ["--track-variance"],
             _counts(ops, flash_attention=lt, fused_first_order=tdense + texperts,
                     fused_second_order=tdense))),
        dict(layers=lt, experts=E, top_k=top_k, dtype=tcfg.dtype, batch=n, seq=spec["seq"],
             param_count=tcfg.param_count(tmeta),
             capacity=capacity(n * spec["seq"], E, top_k, cfg.capacity_factor)), train=fit_cut)
    # KFAC: the stacked per-expert factors [L, E, b, b] are refused, as the
    # reference's preconditioner fails on them
    lv = ["--arch", spec["arch"], "--seq", str(spec["launcher_seq"]),
          "--batch", str(spec["launcher_batch"])]
    try:
        train_launch.main(lv + ["--optimizer", "kfac", "--steps", "1"])
        fail("mla: KFAC on the stacked per-expert factors was not refused")
    except NotImplementedError as e:
        if "precond.py:62-64" not in str(e):
            fail(f"mla: KFAC refused for another reason: {e}")
        out["kfac_refused"] = str(e)
    say("mla_kfac_refused", reason=out["kfac_refused"])
    # the training launcher itself, on the reduced config
    rcfg = cfg.reduced()
    rmeta = build_model(rcfg, device="meta")
    rd, rx = _layers_of(rmeta, Dense), _layers_of(rmeta, BatchedDense)
    out["launcher"] = launcher_runs(
        torch, ops, "mla_launcher", lv, (
            ("adamw", spec["launcher_steps"], [], _counts(ops, flash_attention=rcfg.n_layers)),
            ("diag_ggn_mc", spec["launcher_steps"], ["--track-variance"],
             _counts(ops, flash_attention=rcfg.n_layers, fused_first_order=rd + rx,
                     fused_second_order=rd))),
        dict(layers=rcfg.n_layers, reduced=True, batch=spec["launcher_batch"],
             seq=spec["launcher_seq"]))
    out["launches"] = _phase_launches(out, out["decode"], out["decode_long"], out["run"],
                                      *out["train"].values(), *out["launcher"].values())
    return out


def _layers_of(m, cls):
    """The ``cls`` layers a sweep of module ``m`` meets, counted on the
    module tree."""
    from repro_torch.core.module import ScanStack, Sequential
    from repro_torch.nn.wired import Wired

    if isinstance(m, cls):
        return 1
    if isinstance(m, ScanStack):
        return m.L * _layers_of(m.block, cls)
    kids = (m.children_map.values() if isinstance(m, Wired) else
            m.mods if isinstance(m, Sequential) else ())
    return sum(_layers_of(c, cls) for c in kids)


def _drop_spy():
    """Each ``moe_apply`` call's tokens, capacity and dropped pairs (a spy on
    the blocks' ``moe_apply``), into the returned list until ``unpatch()``."""
    from repro_torch.nn import blocks as blocks_mod
    from repro_torch.nn.moe import capacity, dropped

    real, seen = blocks_mod.moe_apply, []

    def spy(call, h, logits, n_experts, k, factor, act):
        m = h.shape[0] * h.shape[1]
        seen.append(dict(tokens=m, capacity=capacity(m, n_experts, k, factor),
                         dropped=dropped(logits, k, factor)))
        return real(call, h, logits, n_experts, k, factor, act)

    blocks_mod.moe_apply = spy
    return seen, lambda: setattr(blocks_mod, "moe_apply", real)


def _by_path(tree):
    """{"i/name/w": leaf} of a parameter-shaped tree."""
    from repro_torch.core.tree import tree_leaves, tree_map_with_path

    paths = tree_leaves(tree_map_with_path(lambda p, _: "/".join(map(str, p)), tree))
    return dict(zip(paths, tree_leaves(tree), strict=True))


def _rel(a, b):
    """max |a − b| / max |b|, b moved to a's device."""
    return ((a.float() - b.float().to(a.device)).abs().max()
            / b.float().abs().max().clamp_min(1e-30)).item()


def _ext_errs(got, want, names):
    """``_rel`` of the grads and of each extension of two ``run`` results,
    the worst leaf; Variance against the second moment's scale."""
    from repro_torch.core.tree import tree_leaves

    errs = {"grads": max(_rel(a, b) for a, b in zip(tree_leaves(got.grads),
                                                     tree_leaves(want.grads), strict=True))}
    for name in names:
        pairs = list(zip(tree_leaves(got.ext[name]), tree_leaves(want.ext[name]), strict=True))
        if name == "variance":  # N·Σg² − (Σg)²: its rounding scales with N·Σg²
            sm = tree_leaves(want.ext["second_moment"])
            errs[name] = max(((a - b.to(a.device)).abs().max() / m.abs().max()).item()
                             for (a, b), m in zip(pairs, sm))
        else:
            errs[name] = max(_rel(a, b) for a, b in pairs)
    return errs


def _vs_float64_of_batch_grad(torch, bgs, res, moments=None):
    """BatchL2, BatchDot and SecondMoment (N · Σ_n g_n²) of a ``run`` result
    against their float64 formula on the per-sample gradients ``bgs`` (a
    batch_grad's leaves), leaf by leaf: {name: (the worst leaf's max |got − want| / max
    |want|, its index in tree_leaves order)}.  A stacked leaf is [N, L, ...]
    (BatchL2 [N, L], BatchDot [N, L, N]).  ``moments``: the SecondMoment
    leaves that ``bgs`` have, where the tree has more (a mixture's experts)."""
    from repro_torch.core.tree import tree_leaves

    if moments is None:
        moments = tree_leaves(res.ext["second_moment"])
    worst = {}
    for i, (bg, l2, dot, sm) in enumerate(zip(
            bgs, *(tree_leaves(res.ext[k]) for k in ("batch_l2", "batch_dot")), moments,
            strict=True)):
        g64 = bg.double()
        flat = g64.reshape(bg.shape[0], l2[0].numel(), -1)
        for key, got, want in (("batch_l2", l2, (flat * flat).sum(-1).reshape(l2.shape)),
                               ("batch_dot", dot, torch.einsum(
                                   "nlp,mlp->nlm", flat, flat).reshape(dot.shape)),
                               ("second_moment", sm, len(g64) * sum(x * x for x in g64))):
            e = ((got.double() - want).abs().max() / want.abs().max()).item()
            if e > worst.get(key, (0.0, -1))[0]:
                worst[key] = (e, i)
        del g64, flat
    return worst


def lm_run_phase(torch, ops):
    """BackPACK ``run`` on StableLM-2-1.6B at full width with 4 of its 24
    layers (``LM_RUN``), float32, from random weights drawn on the card:
    the five first-order extensions and DiagGGN-MC at the full vocabulary in
    one call (fused_first_order and fused_second_order 7 a layer plus the
    head, flash_attention once a layer, nothing else), timed, profiled
    (device time by kernels, GEMMs, attention's backward in plain torch and
    the rest) and checked: the gradient against autograd through ``call``,
    Σ_n batch_grad against it, variance ≥ 0, diag_ggn_mc ≥ 0, the
    per-extension route against the fused one; then KFAC with DiagGGN-MC
    with the vocabulary cut to 8192; then the card against the CPU on the
    reduced StableLM-2 and Gemma-3 with the draws passed in."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.core import CrossEntropyLoss, ExtensionConfig, by_name, run
    from repro_torch.core.tree import tree_leaves, tree_map
    from repro_torch.nn.models import build_model

    out = {}
    L, n, t = LM_RUN["n_layers"], LM_RUN["batch"], LM_RUN["seq"]
    loss = CrossEntropyLoss()
    gen = torch.Generator(device="cuda").manual_seed(9)

    def lm(vocab=None):
        cfg = dataclasses.replace(get_config(LM_RUN["arch"]), n_layers=L, dtype="float32",
                                  **({} if vocab is None else dict(vocab=vocab)))
        model = build_model(cfg, device="cuda",
                            generator=torch.Generator(device="cuda").manual_seed(1))
        return cfg, model, model.params()

    def batch(cfg, n, t, masked):
        toks = torch.randint(0, cfg.vocab, (n, t), device="cuda", generator=gen)
        labels = torch.randint(0, cfg.vocab, (n, t), device="cuda", generator=gen)
        flat = labels.view(-1)
        flat[torch.randperm(n * t, device="cuda", generator=gen)[:masked]] = -1
        draws = torch.randint(0, cfg.vocab, (1, n, t), device="cuda", generator=gen)
        return toks, labels, draws

    cfg, model, params = lm()
    toks, labels, draws = batch(cfg, n, t, LM_RUN["masked"])
    names = LM_FIRST + ("diag_ggn_mc",)
    exts = tuple(by_name(e) for e in names)
    fused = ExtensionConfig(mc_samples=1)
    per_ext = ExtensionConfig(mc_samples=1, use_fused=False)
    want = {k: {"fused_first_order": 7 * L + 1, "fused_second_order": 7 * L + 1,
                "flash_attention": L}.get(k, 0) for k in ops.KERNELS}
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    res = run(model, params, toks, labels, loss, extensions=exts, cfg=fused, rng=draws)
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t0
    launches = ops.launch_counts()
    peak = torch.cuda.max_memory_allocated() - base
    if launches != want:
        fail(f"lm_run must launch {want}, got {launches}")
    step_s = []
    for _ in range(2):
        t0 = time.perf_counter()
        run(model, params, toks, labels, loss, extensions=exts, cfg=fused, rng=draws)
        torch.cuda.synchronize()
        step_s.append(time.perf_counter() - t0)
    prof = profiled(lambda: run(model, params, toks, labels, loss, extensions=exts, cfg=fused,
                                rng=draws),
                    groups={"backpack_kernels": ("xty", "gram", "rowprod", "sum_partials",
                                                 "diagonal"),
                            "attention_forward": ("flash_",), "gemm": ("gemm", "Gemm")},
                    ranges={"attention_backward": "flash_attention_backward"})
    prof["idle_share"] = 1 - prof["device_ms"] / prof["wall_ms"]
    prof["rest_device_ms"] = prof["device_ms"] - sum(
        prof[f"{k}_device_ms"] for k in ("backpack_kernels", "attention_forward", "gemm",
                                         "attention_backward"))
    # checks: autograd's gradient through call, Σ_n batch_grad, signs, routes
    tracked = tree_map(lambda p: p.detach().clone().requires_grad_(True), params)
    with torch.enable_grad():
        lv = loss.value(model.call(tracked, toks), labels)
        auto = torch.autograd.grad(lv, tree_leaves(tracked))
    del tracked, lv
    grad_err = max(_rel(a, b) for a, b in zip(tree_leaves(res.grads), auto, strict=True))
    sum_err = max(_rel(bg.sum(0), g) for bg, g in zip(tree_leaves(res.ext["batch_grad"]),
                                                     tree_leaves(res.grads), strict=True))
    var_min = min((v.min() / m.abs().max()).item() for v, m in zip(
        tree_leaves(res.ext["variance"]), tree_leaves(res.ext["second_moment"])))
    mc_min = min(v.min().item() for v in tree_leaves(res.ext["diag_ggn_mc"]))
    del auto
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    res_pe = run(model, params, toks, labels, loss, extensions=exts, cfg=per_ext, rng=draws)
    torch.cuda.synchronize()
    pe_s = time.perf_counter() - t0
    pe_launches = ops.launch_counts()
    route_errs = _ext_errs(res_pe, res, names)
    exact64 = {name: _vs_float64_of_batch_grad(torch, tree_leaves(res.ext["batch_grad"]), r_)
               for name, r_ in (("fused", res), ("per_extension", res_pe))}
    del res_pe
    out["run"] = dict(arch=cfg.name, layers=L, d_model=cfg.d_model, vocab=cfg.vocab, batch=n,
                      seq=t, masked=LM_RUN["masked"], extensions=names,
                      param_count=cfg.param_count(model), first_call_s=first_s,
                      step_s=step_s, ms=medians_ms({"s": step_s})["s"],
                      peak_bytes_above_start=peak, launches=launches,
                      wall_ms=prof["wall_ms"], device_ms=prof["device_ms"],
                      idle_share=prof["idle_share"],
                      split_device_ms={k: prof[f"{k}_device_ms"] for k in (
                          "backpack_kernels", "attention_forward", "gemm",
                          "attention_backward", "rest")},
                      grads_vs_autograd=grad_err, batch_grad_sum_vs_grads=sum_err,
                      variance_min_over_second_moment=var_min, diag_ggn_mc_min=mc_min,
                      per_extension_s=pe_s, per_extension_launches=pe_launches,
                      per_extension_vs_fused=route_errs, vs_float64_of_batch_grad=exact64,
                      tol=TOL, profile=prof)
    say("lm_run", **{k: v for k, v in out["run"].items() if k != "profile"})
    say("profile_lm_run", **prof)
    del res
    if not grad_err <= TOL or not sum_err <= TOL:
        fail(f"lm_run: grads vs autograd {grad_err:.3e}, Σ batch_grad vs grads {sum_err:.3e} "
             f"(limit {TOL})")
    if not (var_min >= -1e-6 and mc_min >= 0):
        fail(f"lm_run: variance {var_min:.3e} or diag_ggn_mc {mc_min:.3e} below 0")
    if max(route_errs.values()) > TOL:
        fail(f"lm_run: per-extension vs fused route {route_errs}")
    pe_want = {k: {"per_sample_moment": 2 * (7 * L + 1), "batch_l2": 7 * L + 1,
                   "flash_attention": L}.get(k, 0) for k in ops.KERNELS}
    if pe_launches != pe_want:
        fail(f"lm_run per-extension route launched {pe_launches}, not {pe_want}")
    del model, params
    torch.cuda.empty_cache()

    # KFAC + DiagGGN-MC at the vocabulary of 8192
    cfg, model, params = lm(LM_RUN["kfac_vocab"])
    toks, labels, draws = batch(cfg, n, t, LM_RUN["masked"])
    kexts = (by_name("kfac"), by_name("diag_ggn_mc"))
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    kres = run(model, params, toks, labels, loss, extensions=kexts, cfg=fused, rng=draws)
    torch.cuda.synchronize()
    kfac_s = time.perf_counter() - t0
    kfac_launches = ops.launch_counts()
    head = kres.ext["kfac"][-1]["w"]
    emb = kres.ext["kfac"][0]["emb"]["w"]
    finite = all(torch.isfinite(v).all() for v in tree_leaves(kres.ext))
    out["kfac"] = dict(vocab=cfg.vocab, s=kfac_s, launches=kfac_launches,
                       head_factors=[list(head["A"].shape), list(head["B"].shape)],
                       embedding_factors=sorted(emb), finite=bool(finite),
                       diag_ggn_mc_min=min(v.min().item() for v in tree_leaves(
                           kres.ext["diag_ggn_mc"])))
    say("lm_run_kfac", **out["kfac"])
    kwant = {k: {"fused_second_order": 7 * L + 1, "flash_attention": L}.get(k, 0)
             for k in ops.KERNELS}
    if kfac_launches != kwant:
        fail(f"lm_run kfac must launch {kwant}, got {kfac_launches}")
    if (not finite or out["kfac"]["diag_ggn_mc_min"] < 0
            or out["kfac"]["head_factors"] != [[cfg.d_model] * 2, [cfg.vocab] * 2]):
        fail(f"lm_run kfac: {out['kfac']}")
    del kres, model, params
    torch.cuda.empty_cache()

    # the card against the CPU on the reduced configs, the draws passed in
    out["card_vs_cpu"] = {}
    for arch, names_c in (("stablelm-1.6b", names), ("gemma3-12b", ("kfac", "diag_ggn_mc"))):
        cfg = get_config(arch).reduced()
        model = build_model(cfg, device="cuda", generator=torch.Generator().manual_seed(2))
        params = model.params()
        toks, labels, draws = batch(cfg, LM_RUN["cpu_batch"], LM_RUN["cpu_seq"], 3)
        exts_c = tuple(by_name(e) for e in names_c)
        card = run(model, params, toks, labels, loss, extensions=exts_c, cfg=fused, rng=draws)
        cpu = run(model, tree_map(lambda p: p.cpu(), params), toks.cpu(), labels.cpu(), loss,
                  extensions=exts_c, cfg=fused, rng=draws.cpu())
        errs = _ext_errs(card, cpu, names_c)
        out["card_vs_cpu"][arch] = errs
        say("lm_run_card_vs_cpu", arch=arch, reduced=True, rel_err=errs, tol=TOL)
        if max(errs.values()) > TOL:
            fail(f"lm_run {arch} reduced card vs CPU: {errs}")
    out["launches"] = {k: launches[k] + kfac_launches[k] for k in ops.KERNELS}
    return out


def _steps_profiled(at, out, **kw):
    """Wrap the loop's step factories so the step of index ``at`` runs under
    :func:`profiled` (its figures into ``out``); the other steps run as built."""
    def wrap(step):
        def wrapped(params, opt_state, batch, step_idx, *rest):
            if step_idx != at:
                return step(params, opt_state, batch, step_idx, *rest)
            box = {}
            out.update(profiled(lambda: box.setdefault(
                "r", step(params, opt_state, batch, step_idx, *rest)), **kw))
            out["idle_share"] = 1 - out["device_ms"] / out["wall_ms"]
            return box["r"]
        return wrapped

    return wrap


def _measured(torch, ops, fn):
    """(fn's result, seconds, launches, peak bytes above the start)."""
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    res = fn()
    torch.cuda.synchronize()
    return (res, time.perf_counter() - t0, ops.launch_counts(),
            torch.cuda.max_memory_allocated() - base)


def _profile_steps(loop_mod, at, prof, kept=None, **kw):
    """Profile the step of index ``at`` of the loop's next ``fit`` (into
    ``prof``); into ``kept`` its input weights and batch (a step returns new
    tensors: they stay as they were).  Returns the function that restores
    the loop's step factories."""
    factories = (loop_mod.make_train_step, loop_mod.make_extended_train_step)
    profiled_ = _steps_profiled(at, prof, **kw)

    def wrap(step):
        inner = profiled_(step)

        def wrapped(params, opt_state, batch, step_idx, *rest):
            if kept is not None and step_idx == at:
                kept.update(params=params, batch=batch)
            return inner(params, opt_state, batch, step_idx, *rest)
        return wrapped

    loop_mod.make_train_step = lambda *a, **k: wrap(factories[0](*a, **k))
    loop_mod.make_extended_train_step = lambda *a, **k: wrap(factories[1](*a, **k))

    def unpatch():
        loop_mod.make_train_step, loop_mod.make_extended_train_step = factories

    return unpatch


def _last_step_check(torch, run_, kept, loss):
    """The last step's batch through the weights it started from
    (``kept``) and those it returned: the two losses, and for each
    parameter (by its path) the share of its entries that the step moved
    and max |Δ| / max |p|."""
    from repro_torch.core.tree import tree_leaves, tree_map_with_path
    from repro_torch.train.step import make_loss_fn

    loss_fn = make_loss_fn(run_["model"], loss)
    before, batch = kept["params"], kept["batch"]
    with torch.no_grad():
        res = {f"loss_{k}": loss_fn(p, batch["inputs"], batch["labels"]).item()
               for k, p in (("before", before), ("after", run_["params"]))}
    paths = tree_leaves(tree_map_with_path(lambda p_, _: "/".join(map(str, p_)), before))
    res["moved_share"], res["max_rel_change"] = {}, {}
    for path, a, b in zip(paths, tree_leaves(before), tree_leaves(run_["params"]),
                          strict=True):
        res["moved_share"][path] = (a != b).float().mean().item()
        res["max_rel_change"][path] = ((b.float() - a.float()).abs().max()
                                       / a.float().abs().max().clamp_min(1e-30)).item()
    return res


TRAIN_GROUPS = {"backpack_kernels": ("xty", "gram", "rowprod", "sum_partials", "diagonal"),
                "attention_forward": ("flash_",), "gemm": ("gemm", "Gemm", "nvjet")}
TRAIN_RANGES = {"attention_backward": "flash_attention_backward",
                "attention_jvp": "flash_attention_jvp"}


def launcher_runs(torch, ops, tag, argv, runs, meta, train=None):
    """The training launcher, ``launch.train.main(argv + ["--optimizer",
    opt, "--steps", steps] + extra)`` (or ``train(opt, steps, extra)``,
    which returns the launcher's dict) for each (opt, steps, extra, launches
    derived a step) of ``runs``, the launch counts set to 0 before and read
    after: the last step lowers the loss of its own batch (the weights
    before and after it, one deterministic forward each; the share of each
    parameter's entries that moved printed); steps 2..n−1 timed, the last
    profiled, the peak above the start.  ``meta`` goes into each row."""
    from repro_torch.core import CrossEntropyLoss
    from repro_torch.launch import train as train_launch
    from repro_torch.train import loop as loop_mod

    if train is None:
        def train(opt, steps, extra):
            return train_launch.main(argv + ["--optimizer", opt, "--steps", str(steps)] + extra)
    loss = CrossEntropyLoss()
    launcher = {}
    for opt, steps, extra, want in runs:
        prof, kept = {}, {}
        # the host's operators recorded on AdamW's step alone (attention's
        # backward is a range of them); a step of the MC sweep's thousands of
        # operators would take the profiler minutes to summarize
        unpatch = _profile_steps(loop_mod, steps - 1, prof, kept, groups=TRAIN_GROUPS,
                                 ranges=TRAIN_RANGES if opt == "adamw" else None,
                                 host_ops=opt == "adamw")
        try:
            run_, s, launches, peak = _measured(torch, ops, lambda: train(opt, steps, extra))
        finally:
            unpatch()
        hist = run_["history"]
        last = _last_step_check(torch, run_, kept, loss)
        del run_, kept
        torch.cuda.empty_cache()
        losses = [h["loss"] for h in hist]
        want = {k: v * steps for k, v in want.items()}
        row = dict(optimizer=opt, **meta, steps=steps,
                   losses=losses, step_s=[h["dur_s"] for h in hist],
                   ms=medians_ms({"s": [h["dur_s"] for h in hist[1:-1]]})["s"],
                   call_s=s, peak_bytes_above_start=peak, launches=launches,
                   launches_derived=want, wall_ms=prof["wall_ms"], device_ms=prof["device_ms"],
                   idle_share=prof["idle_share"],
                   split_device_ms={k: prof[f"{k}_device_ms"]
                                    for k in (*TRAIN_GROUPS, *TRAIN_RANGES)
                                    if f"{k}_device_ms" in prof},
                   variance_mean=[h.get("variance_mean") for h in hist], last_step=last,
                   profile=prof)
        launcher[opt] = row
        say(f"{tag}_launcher", top_kernels=prof["top"][:8],
            **{k: v for k, v in row.items() if k != "profile"})
        if launches != want:
            fail(f"{tag} launcher {opt}: launched {launches}, derived {want}")
        # Each step's loss is on a fresh batch whose offset moves with the
        # step: the batches alone move it by ≈ 0.04, and what a step learns
        # of its offset can raise the loss of another's (AdamW's six steps
        # raise step 0's batch's).  The last step's own batch
        # is read before and after it, by one deterministic forward each: a
        # step that left the weights as they were reads the same loss.
        if not all(math.isfinite(v) for v in losses):
            fail(f"{tag} launcher {opt}: losses {losses}")
        if not last["loss_after"] < last["loss_before"]:
            fail(f"{tag} launcher {opt}: the last step did not lower its batch's loss: "
                 f"{last}")
    return launcher


def train_lm_phase(torch, ops):
    """Training language models (``TRAIN_LM``) through the entry points a
    user calls, each with the launch counts set to 0 just before and read
    just after, against the counts derived from the code:

    * the training launcher ``repro_torch.launch.train.main`` on StableLM-2
      at full width and depth in bf16 (``--full``), AdamW and DiagGGN-MC
      with ``--track-variance``: the last step lowers the loss of its own
      batch (the weights before and after it, one deterministic forward
      each; the share of each parameter's entries that moved printed);
      steps 2..n−1 timed, the last profiled, the peak above the start;
    * ``remat``: a plain step through ``fit`` with ``build_model(cfg,
      remat=True)`` at the same size, its loss the non-remat step's and its
      peak lower;
    * ``cg_ngd`` at full width, 4 layers, float32 (``fit(step_fn=...)``):
      flash_attention under ``torch.func``'s transforms, the GGN symmetric
      on two random directions;
    * KFAC at full depth with the vocabulary cut to 8192;
    * card against CPU on the reduced StableLM-2 in float32: one ``fit``
      step of each optimizer (MC draws passed in), ``ggn_vp`` and ``hvp``;
    * restart: the launcher with ``--fail-at-step`` and ``fit_with_restarts``
      resuming from a checkpoint repeat the uninterrupted losses bit for bit;
    * ``launch.serve --full --uncertainty`` and the three LM examples."""
    import dataclasses
    import shutil

    from repro_torch.configs import SHAPES, get_config
    from repro_torch.core import CrossEntropyLoss
    from repro_torch.core.tree import tree_leaves, tree_map
    from repro_torch.curv import GGNOperator, ggn_vp, hvp
    from repro_torch.examples import curvature_training, laplace_uncertainty, noise_scale
    from repro_torch.launch import serve as serve_launch
    from repro_torch.launch import train as train_launch
    from repro_torch.nn.models import build_model
    from repro_torch.optim import Optimizer, adamw, make_cg_ngd_step
    from repro_torch.train import loop as loop_mod
    from repro_torch.train.fault import FailureInjector

    spec = TRAIN_LM
    out = {}
    loss = CrossEntropyLoss()
    full_cfg = get_config(spec["arch"])
    L = full_cfg.n_layers
    dense = 7 * L + 1  # Dense layers a sweep meets: q, k, v, o, gate, up, down a block; the head
    n_seq = ["--seq", str(spec["seq"]), "--batch", str(spec["batch"])]
    shape = dataclasses.replace(SHAPES["train_4k"], seq_len=spec["seq"],
                                global_batch=spec["batch"])
    ckpt_root = ROOT / "build" / "train_lm_ckpt"
    shutil.rmtree(ckpt_root, ignore_errors=True)

    def counts(**want):
        return {k: want.get(k, 0) for k in ops.KERNELS}

    def card_gen(seed):  # the launchers' weights: a generator on the device
        return torch.Generator(device="cuda").manual_seed(seed)

    # -- the launcher at full width and depth, bf16 ------------------------------
    out["launcher"] = launcher_runs(
        torch, ops, "train_lm", ["--arch", spec["arch"], "--full"] + n_seq, (
            ("adamw", spec["adamw_steps"], [], counts(flash_attention=L)),
            ("diag_ggn_mc", spec["mc_steps"], ["--track-variance"],
             counts(flash_attention=L, fused_first_order=dense, fused_second_order=dense))),
        dict(layers=L, d_model=full_cfg.d_model, vocab=full_cfg.vocab, dtype=full_cfg.dtype,
             batch=spec["batch"], seq=spec["seq"]))
    launcher = out["launcher"]

    # -- remat: the same plain step with build_model(cfg, remat=True) -----------
    # The step's peak is its optimizer update's (AdamW's new float32 moments
    # beside the old, 2 × 13.1 GB; SGD's float32 updates, 6.6 GB), which remat
    # does not touch: the first step's gradient pass (forward and backward) is
    # read where its update begins.  (A later step's reading would start beside
    # the previous update's old and new moments.)
    remat = {}
    for flag in (False, True):
        model = build_model(full_cfg, remat=flag, device="cuda", generator=card_gen(0))
        inner, grad_peaks = adamw(1e-3), []

        def update(grads, state, params_, **kw):
            torch.cuda.synchronize()
            grad_peaks.append(torch.cuda.max_memory_allocated() - start)
            return inner.update(grads, state, params_, **kw)

        start = torch.cuda.memory_allocated()
        (params, _, hist, _), s, launches, peak = _measured(torch, ops, lambda: loop_mod.fit(
            model, full_cfg, shape, Optimizer(inner.init, update),
            loop_mod.LoopConfig(steps=2, log_every=10)))
        remat[flag] = dict(losses=[h["loss"] for h in hist], step_s=[h["dur_s"] for h in hist],
                           peak_bytes_above_start=peak, launches=launches, params=params,
                           gradient_pass_peak_bytes_above_start=grad_peaks[0])
        del model
    a, b = remat[False], remat[True]
    param_diff = max(((x.float() - y.float()).abs().max() / x.float().abs().max()).item()
                     for x, y in zip(tree_leaves(a.pop("params")), tree_leaves(b.pop("params"))))
    loss_rel = max(abs(x - y) / abs(x) for x, y in zip(a["losses"], b["losses"]))
    out["remat"] = dict(plain=a, remat=b, loss_rel_diff=loss_rel,
                        params_after_2_steps_rel_diff=param_diff,
                        gradient_pass_peak_saved_bytes=a["gradient_pass_peak_bytes_above_start"]
                        - b["gradient_pass_peak_bytes_above_start"])
    say("train_lm_remat", **out["remat"])
    torch.cuda.empty_cache()
    # the recompute runs each layer's forward again in the backward pass
    if a["launches"] != counts(flash_attention=2 * L) or \
            b["launches"] != counts(flash_attention=4 * L):
        fail(f"remat: launched {a['launches']} / {b['launches']}, derived "
             f"flash_attention {2 * L} / {4 * L}")
    # the forward is the same operations on the same inputs: the losses equal
    if not loss_rel <= 1e-6:
        fail(f"remat: the loss moved {loss_rel:.3e} relative (limit 1e-6)")
    if not out["remat"]["gradient_pass_peak_saved_bytes"] > 0:
        fail(f"remat: the gradient pass's peak did not fall: "
             f"{a['gradient_pass_peak_bytes_above_start']} → "
             f"{b['gradient_pass_peak_bytes_above_start']}")

    # -- cg_ngd at full width, cut in depth, float32 ------------------------------
    ccfg = dataclasses.replace(full_cfg, n_layers=spec["cg_layers"], dtype="float32")
    Lc = ccfg.n_layers
    model = build_model(ccfg, device="cuda", generator=card_gen(0))
    params = model.params()
    opt, step = make_cg_ngd_step(model, loss, lr=spec["cg_lr"], damping=spec["cg_damping"],
                                 cg_iters=spec["cg_iters"])
    prof = {}
    wrap = _steps_profiled(spec["cg_steps"] - 1, prof, host_ops=False)
    (_, _, hist, _), s, launches, peak = _measured(torch, ops, lambda: loop_mod.fit(
        model, ccfg, shape, opt, loop_mod.LoopConfig(steps=spec["cg_steps"], log_every=10),
        step_fn=wrap(step)))
    iters = [int(h["cg_iters"]) for h in hist]
    want = counts(flash_attention=sum(Lc + 2 * Lc * (1 + i) for i in iters))
    losses = [h["loss"] for h in hist]
    batch = loop_mod.batch_for(ccfg, shape, 0, device="cuda")
    op = GGNOperator(model, params, batch["inputs"], batch["labels"], loss)
    gen = torch.Generator(device="cuda").manual_seed(11)
    u, v = (tree_map(lambda p: torch.randn(p.shape, device="cuda", generator=gen), params)
            for _ in range(2))
    ops.reset_launch_counts()
    Gu, Gv = op.mv(u), op.mv(v)
    product_launches = ops.launch_counts()

    def dot(x, y):
        return sum((a_.double() * b_.double()).sum() for a_, b_ in
                   zip(tree_leaves(x), tree_leaves(y), strict=True)).item()

    uGv, Guv, uGu, vGv = dot(u, Gv), dot(Gu, v), dot(u, Gu), dot(v, Gv)
    asym = abs(uGv - Guv) / math.sqrt(uGu * vGv)
    out["cg_ngd"] = dict(layers=Lc, d_model=ccfg.d_model, vocab=ccfg.vocab, dtype=ccfg.dtype,
                         steps=spec["cg_steps"], cg_iters=iters, losses=losses,
                         loss_change=[y - x for x, y in zip(losses, losses[1:])],
                         cg_resid=[h["cg_resid"] for h in hist],
                         step_s=[h["dur_s"] for h in hist], call_s=s,
                         peak_bytes_above_start=peak, launches=launches,
                         launches_derived=want, wall_ms=prof["wall_ms"],
                         device_ms=prof["device_ms"], idle_share=prof["idle_share"],
                         ggn_symmetry=dict(uGv=uGv, Guv=Guv, uGu=uGu, vGv=vGv, rel=asym),
                         product_launches=product_launches, tol=TOL)
    say("train_lm_cg_ngd", **out["cg_ngd"])
    del model, params, op, u, v, Gu, Gv, batch
    torch.cuda.empty_cache()
    if launches != want:
        fail(f"cg_ngd: launched {launches}, derived {want}")
    if product_launches != counts(flash_attention=4 * Lc):
        fail(f"cg_ngd: two ggn_vp products launched {product_launches}, derived "
             f"flash_attention {4 * Lc}")
    if not (asym <= TOL and uGu > 0 and vGv > 0):
        fail(f"cg_ngd: the GGN is not symmetric positive on two directions: "
             f"{out['cg_ngd']['ggn_symmetry']}")
    if not all(math.isfinite(x) for x in losses):
        fail(f"cg_ngd: losses {losses}")

    # -- KFAC at full depth, the vocabulary cut to 8192 ---------------------------
    kcfg = dataclasses.replace(full_cfg, vocab=spec["kfac_vocab"])
    model = build_model(kcfg, device="cuda", generator=card_gen(0))
    kw = train_launch.make_optimizer("kfac", model)
    (_, _, hist, _), s, launches, peak = _measured(torch, ops, lambda: loop_mod.fit(
        model, kcfg, shape, kw.pop("opt"), loop_mod.LoopConfig(steps=spec["kfac_steps"],
                                                               log_every=10), **kw))
    del model
    torch.cuda.empty_cache()
    losses = [h["loss"] for h in hist]
    want = counts(flash_attention=L * spec["kfac_steps"],
                  fused_second_order=dense * spec["kfac_steps"])
    out["kfac"] = dict(layers=L, vocab=kcfg.vocab, dtype=kcfg.dtype, losses=losses,
                       step_s=[h["dur_s"] for h in hist], call_s=s, peak_bytes_above_start=peak,
                       launches=launches, launches_derived=want)
    say("train_lm_kfac", **out["kfac"])
    if launches != want:
        fail(f"train_lm kfac: launched {launches}, derived {want}")
    if not all(math.isfinite(x) for x in losses):
        fail(f"train_lm kfac: losses {losses}")

    # -- card against CPU on the reduced config, float32 --------------------------
    rcfg = get_config(spec["arch"]).reduced()
    rshape = dataclasses.replace(shape, seq_len=spec["cpu_seq"], global_batch=spec["cpu_batch"])
    model = build_model(rcfg, device="cuda", generator=torch.Generator().manual_seed(3))
    params = model.params()
    cpu_params = tree_map(lambda p: p.cpu(), params)
    draws = torch.randint(0, rcfg.vocab, (1, spec["cpu_batch"], spec["cpu_seq"]),
                          generator=torch.Generator().manual_seed(4))
    step_rng = loop_mod.step_rng
    loop_mod.step_rng = lambda seed, step, device: draws.to(device)
    # Each step's update, card against CPU, over the whole tree's largest
    # entry: a gradient that is zero but for rounding (the key bias's unrotated
    # dims, which the softmax ignores) is noise on either side.  AdamW's first
    # update is ±lr where g ≠ 0, its sign that noise's there: its new moments
    # m and v carry the step's gradient and are compared instead.
    card_vs_cpu = {}
    try:
        for name in ("adamw", "momentum", "diag_ggn_mc", "kfac", "cg_ngd"):
            res = {}
            for dev, p in (("cuda", params), ("cpu", cpu_params)):
                kw = train_launch.make_optimizer(name, model)
                new, state, hist, _ = loop_mod.fit(
                    model, rcfg, rshape, kw.pop("opt"), loop_mod.LoopConfig(steps=1,
                                                                            log_every=10),
                    params=p, **kw)
                moved = ([state["m"], state["v"]] if name == "adamw" else
                         [[n_.float() - o.float() for n_, o in
                           zip(tree_leaves(new), tree_leaves(p))]])
                res[dev] = (hist[0]["loss"], [[x.float().cpu() for x in tree_leaves(t)]
                                              for t in moved])
            errs = [max((a_ - b_).abs().max().item() for a_, b_ in zip(got, want, strict=True))
                    / max(b_.abs().max().item() for b_ in want)
                    for got, want in zip(res["cuda"][1], res["cpu"][1], strict=True)]
            card_vs_cpu[name] = dict(loss_rel=abs(res["cuda"][0] - res["cpu"][0])
                                     / abs(res["cpu"][0]), update_rel=max(errs))
    finally:
        loop_mod.step_rng = step_rng
    batch = loop_mod.batch_for(rcfg, rshape, 0, device="cuda")
    gen = torch.Generator().manual_seed(5)
    vdir = tree_map(lambda p: torch.randn(p.shape, generator=gen), cpu_params)
    for name, fn, per_call in (("ggn_vp", ggn_vp, 2), ("hvp", hvp, 1)):
        ops.reset_launch_counts()
        card = fn(model, params, batch["inputs"], batch["labels"], loss,
                  tree_map(lambda x: x.cuda(), vdir))
        launched = ops.launch_counts()
        cpu = fn(model, cpu_params, batch["inputs"].cpu(), batch["labels"].cpu(), loss, vdir)
        card_vs_cpu[name] = dict(rel=max(
            ((a_.cpu() - b_).abs().max() / b_.abs().max()).item()
            for a_, b_ in zip(tree_leaves(card), tree_leaves(cpu), strict=True)),
            launches=launched)
        if launched != counts(flash_attention=per_call * rcfg.n_layers):
            fail(f"{name} on the reduced config launched {launched}, derived "
                 f"flash_attention {per_call * rcfg.n_layers}")
    out["card_vs_cpu"] = card_vs_cpu
    say("train_lm_card_vs_cpu", arch=rcfg.name, reduced=True, tol=TOL, **card_vs_cpu)
    bad = {k: v for k, v in card_vs_cpu.items()
           if max(x for key, x in v.items() if key != "launches") > TOL}
    if bad:
        fail(f"train_lm card vs CPU above {TOL}: {bad}")
    del model, params, cpu_params

    # -- restart: the launcher, and fit_with_restarts from a checkpoint ----------
    rs = ["--arch", spec["arch"], "--steps", str(spec["restart_steps"]), "--seq",
          str(spec["cpu_seq"]), "--batch", str(spec["cpu_batch"])]
    plain_hist = train_launch.main(rs + ["--ckpt", str(ckpt_root / "plain")])["history"]
    restarted = train_launch.main(rs + ["--ckpt", str(ckpt_root / "restart"),
                                        "--fail-at-step", str(spec["restart_fail"]),
                                        "--max-restarts", "1"])["history"]
    # the launcher's weights: a generator seeded 0 on the device
    model = build_model(rcfg, device="cuda", generator=card_gen(0))
    loop = loop_mod.LoopConfig(steps=spec["restart_steps"], ckpt_dir=str(ckpt_root / "resume"),
                               ckpt_every=2, log_every=10)
    (_, _, resumed, _), restarts = loop_mod.fit_with_restarts(
        model, rcfg, rshape, adamw(1e-3), loop, max_restarts=1,
        injector=FailureInjector(fail_at_step=spec["restart_fail"]))
    uninterrupted = [h["loss"] for h in plain_hist]
    out["restart"] = dict(uninterrupted=uninterrupted,
                          launcher_restarted=[h["loss"] for h in restarted],
                          resumed_from_checkpoint=[h["loss"] for h in resumed],
                          restarts=restarts)
    say("train_lm_restart", **out["restart"])
    shutil.rmtree(ckpt_root, ignore_errors=True)
    if (out["restart"]["launcher_restarted"] != uninterrupted or restarts != 1
            or out["restart"]["resumed_from_checkpoint"]
            != uninterrupted[len(uninterrupted) - len(resumed):]
            or len(resumed) != spec["restart_steps"] - 2):
        fail(f"train_lm restart: the losses differ from the uninterrupted run: {out['restart']}")

    # -- serve --full --uncertainty --------------------------------------------------
    (mean, var), s, launches, peak = _measured(torch, ops, lambda: serve_launch.main(
        ["--arch", spec["arch"], "--full", "--uncertainty"]))
    want = counts(flash_attention=2 * L, fused_second_order=1)
    out["uncertainty"] = dict(shape=list(mean.shape), dtype=str(var.dtype), call_s=s,
                              var_min=var.min().item(), var_mean=var.float().mean().item(),
                              finite=bool(torch.isfinite(mean).all() and torch.isfinite(var).all()),
                              launches=launches, launches_derived=want,
                              peak_bytes_above_start=peak)
    say("train_lm_uncertainty", **out["uncertainty"])
    del mean, var
    if launches != want:
        fail(f"serve --uncertainty: launched {launches}, derived {want}")
    if not (out["uncertainty"]["finite"] and out["uncertainty"]["var_min"] >= 0):
        fail(f"serve --uncertainty: {out['uncertainty']}")

    # -- the three LM examples ------------------------------------------------------
    examples = {}
    hists, s, launches, _ = _measured(torch, ops, lambda: curvature_training.main(
        ["--steps", str(spec["example_steps"]), "--seq", str(spec["example_seq"]),
         "--batch", str(spec["example_batch"])]))
    examples["curvature_training"] = dict(
        final_losses={k: h[-1]["loss"] for k, h in hists.items()},
        first_losses={k: h[0]["loss"] for k, h in hists.items()}, s=s, launches=launches)
    rows, s, launches, _ = _measured(torch, ops, lambda: noise_scale.main([]))
    examples["noise_scale"] = dict(rows=rows, s=s, launches=launches)
    (mean, var), s, launches, _ = _measured(torch, ops, lambda: laplace_uncertainty.main([]))
    examples["laplace_uncertainty"] = dict(var_min=var.min().item(), s=s, launches=launches,
                                           finite=bool(torch.isfinite(mean).all()
                                                       and torch.isfinite(var).all()))
    out["examples"] = examples
    say("train_lm_examples", **examples)
    if not all(math.isfinite(v) for v in examples["curvature_training"]["final_losses"].values()):
        fail(f"curvature_training: {examples['curvature_training']}")
    if not all(math.isfinite(r[1]) and math.isfinite(r[2]) for r in rows):
        fail("noise_scale: a non-finite loss or noise scale")
    if not (examples["laplace_uncertainty"]["finite"]
            and examples["laplace_uncertainty"]["var_min"] >= 0):
        fail(f"laplace_uncertainty: {examples['laplace_uncertainty']}")
    if any(e["launches"]["sq_matmul"] for e in examples.values()):
        fail("the LM examples launched sq_matmul: every Dense layer has R = T > 1")
    out["launches"] = {k: sum(launcher[o]["launches"][k] for o in launcher)
                       + out["cg_ngd"]["launches"][k] + out["kfac"]["launches"][k]
                       + out["uncertainty"]["launches"][k] for k in ops.KERNELS}
    return out


def whisper_phase(torch, ops):
    """Whisper (``WHISPER``): whisper-tiny at full width and depth through
    the entry points a user calls, random weights drawn on the card, each
    call with the launch counts set to 0 just before and read just after,
    against the counts derived from the module tree:

    * serving in bf16: ``encode`` of 4 × 1500 frames (flash_attention once an
      encoder layer, nothing else), ``generate_whisper`` greedy over the 448
      decoder positions (encode, then self- and cross-attention a decoder
      layer a serve_step), decode steps timed from positions 32 and 439 and
      the next step profiled (device ms, attention's, the idle share); a
      float32 copy's serve_step chain over the 448 positions against the
      forward (``CHAIN_TOL``), the card against the CPU (``TOL``); the
      launcher ``launch.serve --arch whisper-tiny --full``;
    * BackPACK ``run`` in float32 at 4 × 1500 frames, 448 tokens: the
      first-order extensions and DiagGGN-MC at the full vocabulary
      (fused_first_order and fused_second_order once a Dense layer of the
      tree, flash_attention 12, nothing else), timed, profiled, the
      gradient against autograd, Σ_n batch_grad against it; KFAC with
      DiagGGN-MC at the vocabulary cut to 8192; the reduced config card
      against CPU with the MC draws passed in;
    * the training launcher in bf16 (``--seq 1500 --batch 4``), AdamW and
      DiagGGN-MC with ``--track-variance`` (``launcher_runs``);
    * the serving example (``repro_torch.examples.serving``) on the card."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.core import CrossEntropyLoss, ExtensionConfig, by_name, run
    from repro_torch.core.module import Dense
    from repro_torch.core.tree import tree_leaves, tree_map
    from repro_torch.examples import serving as serving_example
    from repro_torch.nn.models import build_model
    from repro_torch.serve import ServeConfig, generate_whisper

    spec = WHISPER
    out = {}
    loss = CrossEntropyLoss()
    cfg = get_config(spec["arch"])
    n, s_len, d = spec["batch"], spec["frames"], cfg.d_model
    gen = torch.Generator(device="cuda").manual_seed(12)

    def counts(**want):
        return {k: want.get(k, 0) for k in ops.KERNELS}

    def dense_layers(m):
        return _layers_of(m, Dense)

    by_path = _by_path

    # -- serving, bf16 -------------------------------------------------------------
    t0 = time.perf_counter()
    model = build_model(cfg, device="cuda", generator=torch.Generator(device="cuda").manual_seed(0))
    params = model.params()
    torch.cuda.synchronize()
    dense = dense_layers(model)
    attn = cfg.enc_layers + 2 * cfg.dec_layers  # a forward: self and cross a decoder layer
    out["model"] = dict(arch=cfg.name, dtype=cfg.dtype, enc_layers=cfg.enc_layers,
                        dec_layers=cfg.dec_layers, d_model=d, heads=cfg.n_heads, vocab=cfg.vocab,
                        max_dec=model.max_dec, param_count=cfg.param_count(model),
                        build_s=time.perf_counter() - t0, dense_layers=dense,
                        attention_a_forward=attn)
    say("whisper_model", **out["model"])
    # q, k, v, o and the two feed-forward layers an encoder layer; self q, k,
    # v, o, cross q, k, v, o and the two feed-forward layers a decoder layer
    if dense != 6 * cfg.enc_layers + 10 * cfg.dec_layers + 1:
        fail(f"whisper: {dense} Dense layers in the tree, not 6 an encoder layer, 10 a "
             "decoder layer and the head")
    frames = torch.randn(n, s_len, d, device="cuda", generator=gen).to(torch.bfloat16)
    torch.cuda.synchronize()
    ops.reset_launch_counts()
    enc = model.encode(params, frames)
    torch.cuda.synchronize()
    enc_launches = ops.launch_counts()
    if enc_launches != counts(flash_attention=cfg.enc_layers):
        fail(f"whisper encode launched {enc_launches}, not flash_attention {cfg.enc_layers}")
    if tuple(enc.shape) != (n, s_len, d) or not torch.isfinite(enc.float()).all():
        fail(f"whisper encode: {tuple(enc.shape)} not a finite [N, S, d]")
    enc_s = []
    for _ in range(3):
        t0 = time.perf_counter()
        model.encode(params, frames)
        torch.cuda.synchronize()
        enc_s.append(time.perf_counter() - t0)
    prof = profiled(lambda: model.encode(params, frames), groups={"attention": "flash_"})
    out["encode"] = dict(batch=n, frames=s_len, launches=enc_launches, step_s=enc_s,
                         ms=medians_ms({"e": enc_s})["e"], wall_ms=prof["wall_ms"],
                         device_ms=prof["device_ms"],
                         attention_device_ms=prof["attention_device_ms"],
                         idle_share=1 - prof["device_ms"] / prof["wall_ms"], top=prof["top"][:6])
    say("whisper_encode", **out["encode"])

    sc = ServeConfig(max_len=model.max_dec)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    toks = generate_whisper(model, params, frames, sc)
    torch.cuda.synchronize()
    gen_s = time.perf_counter() - t0
    gen_launches = ops.launch_counts()
    want = counts(flash_attention=cfg.enc_layers + 2 * cfg.dec_layers * sc.max_len)
    if gen_launches != want:
        fail(f"generate_whisper launched {gen_launches}, derived {want}")
    if (tuple(toks.shape) != (n, sc.max_len) or toks.dtype != torch.int32 or toks.min() < 0
            or toks.max() >= cfg.vocab):
        fail(f"generate_whisper: tokens {tuple(toks.shape)} {toks.dtype} out of [0, V)")
    out["generate"] = dict(batch=n, steps=sc.max_len, s=gen_s,
                           ms_per_serve_step=gen_s / sc.max_len * 1e3, launches=gen_launches,
                           max_memory_allocated=torch.cuda.max_memory_allocated(),
                           first_row=toks[0, :16].tolist())
    say("whisper_generate", **out["generate"])

    # decode steps timed from two positions; the step after them profiled
    caches = model.init_serve_cache(params, n, model.max_dec, torch.float32, enc_out=enc)
    tok = torch.zeros((n,), device="cuda", dtype=torch.int32)
    pos, out["decode"] = 0, {}
    for at in spec["decode_at"]:
        while pos < at:
            logits, caches = model.serve_step(params, caches, tok, pos)
            tok, pos = logits.argmax(-1).int(), pos + 1
        step_s = []
        ops.reset_launch_counts()
        for _ in range(spec["decode_steps"]):
            t0 = time.perf_counter()
            logits, caches = model.serve_step(params, caches, tok, pos)
            torch.cuda.synchronize()
            step_s.append(time.perf_counter() - t0)
            tok, pos = logits.argmax(-1).int(), pos + 1
        step_launches = ops.launch_counts()
        if step_launches != counts(flash_attention=2 * cfg.dec_layers * spec["decode_steps"]):
            fail(f"whisper decode launched {step_launches}, not flash_attention "
                 f"{2 * cfg.dec_layers} a step")
        prof = profiled(lambda: model.serve_step(params, caches, tok, pos),
                        groups={"attention": "flash_"})
        row = dict(batch=n, position=at, profiled_position=pos, step_s=step_s,
                   ms_per_token=medians_ms({"d": step_s})["d"], launches=step_launches,
                   wall_ms=prof["wall_ms"], device_ms=prof["device_ms"],
                   attention_device_ms=prof["attention_device_ms"],
                   idle_share=1 - prof["device_ms"] / prof["wall_ms"], top=prof["top"][:6])
        out["decode"][at] = row
        say("whisper_decode", **row)
        if not torch.isfinite(logits).all():
            fail(f"whisper decode at {at}: non-finite logits")
    del caches, logits, enc, toks

    # float32: the 448-position chain against the forward, the card against the CPU
    params32 = tree_map(lambda p: p.float(), params)
    del params
    frames32 = frames[:1].float()
    seq = torch.randint(0, cfg.vocab, (1, model.max_dec), device="cuda", generator=gen)
    caches = model.init_serve_cache(params32, 1, model.max_dec, torch.float32,
                                    enc_out=model.encode(params32, frames32))
    chain = torch.empty((model.max_dec, cfg.vocab), device="cuda")
    t0 = time.perf_counter()
    for t in range(model.max_dec):
        step_logits, caches = model.serve_step(params32, caches, seq[:, t], t)
        chain[t] = step_logits[0]
    torch.cuda.synchronize()
    chain_s = time.perf_counter() - t0
    full = model.call(params32, {"frames": frames32, "tokens": seq})[0]
    chain_err = _rel(chain, full)
    del chain, caches, full
    xc = {"frames": torch.randn(1, spec["cpu_frames"], d, device="cuda", generator=gen),
          "tokens": torch.randint(0, cfg.vocab, (1, spec["cpu_tokens"]), device="cuda",
                                  generator=gen)}
    card = model.call(params32, xc)
    t0 = time.perf_counter()
    cpu = model.call(tree_map(lambda p: p.cpu(), params32), tree_map(lambda a: a.cpu(), xc))
    cpu_s = time.perf_counter() - t0
    cpu_err = _rel(card.cpu(), cpu)
    del card, cpu, params32, model
    out["agreement"] = dict(chain_len=seq.shape[1], chain_s=chain_s,
                            chain_vs_forward_rel_err=chain_err, chain_tol=CHAIN_TOL,
                            cpu_frames=spec["cpu_frames"], cpu_tokens=spec["cpu_tokens"],
                            card_vs_cpu_rel_err=cpu_err, cpu_forward_s=cpu_s, cpu_tol=TOL)
    say("whisper_agreement", **out["agreement"])
    if not chain_err <= CHAIN_TOL:
        fail(f"whisper decode chain vs forward: {chain_err:.3e} above {CHAIN_TOL}")
    if not cpu_err <= TOL:
        fail(f"whisper card vs CPU logits: {cpu_err:.3e} above {TOL}")
    torch.cuda.empty_cache()
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(filter(None, [str(ROOT / "src"), env.get("PYTHONPATH")]))
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, "-m", "repro_torch.launch.serve", "--arch",
                           spec["arch"], "--full"], env=env, cwd=ROOT, capture_output=True,
                          text=True, timeout=600)
    out["serve_launcher"] = dict(returncode=proc.returncode, s=time.perf_counter() - t0,
                                 stdout=proc.stdout.strip().splitlines()[:1])
    say("whisper_serve_launcher", **out["serve_launcher"])
    if proc.returncode != 0:
        fail(f"the launcher exited {proc.returncode}: {proc.stderr[-2000:]}")

    # -- BackPACK run, float32 -------------------------------------------------------
    def whisper32(vocab=None, reduced=False):
        c = dataclasses.replace(cfg.reduced() if reduced else cfg, dtype="float32",
                                **({} if vocab is None else dict(vocab=vocab)))
        m = build_model(c, device="cuda", generator=torch.Generator(device="cuda").manual_seed(1))
        return c, m, m.params()

    def batch(c, nb, frames_len, masked):
        x = {"frames": torch.randn(nb, frames_len, c.d_model, device="cuda", generator=gen),
             "tokens": torch.randint(0, c.vocab, (nb, c.dec_len), device="cuda", generator=gen)}
        labels = torch.randint(0, c.vocab, (nb, c.dec_len), device="cuda", generator=gen)
        labels.view(-1)[torch.randperm(labels.numel(), device="cuda", generator=gen)[:masked]] = -1
        draws = torch.randint(0, c.vocab, (1, nb, c.dec_len), device="cuda", generator=gen)
        return x, labels, draws

    rcfg, model, params = whisper32()
    x, labels, draws = batch(rcfg, n, s_len, spec["masked"])
    names = LM_FIRST + ("diag_ggn_mc",)
    exts = tuple(by_name(e) for e in names)
    fused = ExtensionConfig(mc_samples=1)
    want = counts(fused_first_order=dense, fused_second_order=dense, flash_attention=attn)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    res = run(model, params, x, labels, loss, extensions=exts, cfg=fused, rng=draws)
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t0
    launches = ops.launch_counts()
    peak = torch.cuda.max_memory_allocated() - base
    if launches != want:
        fail(f"whisper run launched {launches}, derived {want}")
    step_s = []
    for _ in range(2):
        t0 = time.perf_counter()
        run(model, params, x, labels, loss, extensions=exts, cfg=fused, rng=draws)
        torch.cuda.synchronize()
        step_s.append(time.perf_counter() - t0)
    prof = profiled(lambda: run(model, params, x, labels, loss, extensions=exts, cfg=fused,
                                rng=draws),
                    groups=TRAIN_GROUPS, ranges={"attention_backward": "flash_attention_backward"})
    prof["idle_share"] = 1 - prof["device_ms"] / prof["wall_ms"]
    prof["rest_device_ms"] = prof["device_ms"] - sum(
        prof[f"{k}_device_ms"] for k in (*TRAIN_GROUPS, "attention_backward"))
    tracked = tree_map(lambda p: p.detach().clone().requires_grad_(True), params)
    with torch.enable_grad():
        auto = torch.autograd.grad(loss.value(model.call(tracked, x), labels),
                                   tree_leaves(tracked))
    del tracked
    grad_err = max(_rel(a, b) for a, b in zip(tree_leaves(res.grads), auto, strict=True))
    # pos_dec (a Param) has no per-sample statistics, as in JAX: by path
    grads = by_path(res.grads)
    sum_err = max(_rel(bg.sum(0), grads[k]) for k, bg in by_path(res.ext["batch_grad"]).items())
    var_min = min((v.min() / m.abs().max()).item() for v, m in zip(
        tree_leaves(res.ext["variance"]), tree_leaves(res.ext["second_moment"]), strict=True))
    mc_min = min(v.min().item() for v in tree_leaves(res.ext["diag_ggn_mc"]))
    finite = all(torch.isfinite(v).all() for v in tree_leaves(res.ext))
    # the kernels' outputs at the path's own shapes, against float64
    exact64 = _vs_float64_of_batch_grad(torch, tree_leaves(res.ext["batch_grad"]), res)
    del auto, res, grads
    out["run"] = dict(arch=rcfg.name, batch=n, frames=s_len, tokens=rcfg.dec_len,
                      masked=spec["masked"], vocab=rcfg.vocab, extensions=names,
                      first_call_s=first_s, step_s=step_s, ms=medians_ms({"s": step_s})["s"],
                      peak_bytes_above_start=peak, launches=launches, launches_derived=want,
                      wall_ms=prof["wall_ms"], device_ms=prof["device_ms"],
                      idle_share=prof["idle_share"],
                      split_device_ms={k: prof[f"{k}_device_ms"] for k in (
                          *TRAIN_GROUPS, "attention_backward", "rest")},
                      grads_vs_autograd=grad_err, batch_grad_sum_vs_grads=sum_err,
                      variance_min_over_second_moment=var_min, diag_ggn_mc_min=mc_min,
                      finite=bool(finite), vs_float64_of_batch_grad=exact64,
                      f64_tol=F64_TOL, tol=TOL, profile=prof)
    say("whisper_run", **{k: v for k, v in out["run"].items() if k != "profile"})
    if not grad_err <= TOL or not sum_err <= TOL:
        fail(f"whisper run: grads vs autograd {grad_err:.3e}, Σ batch_grad vs grads "
             f"{sum_err:.3e} (limit {TOL})")
    if not (finite and var_min >= -1e-6 and mc_min >= 0):
        fail(f"whisper run: non-finite, or variance {var_min:.3e} or diag_ggn_mc "
             f"{mc_min:.3e} below 0")
    if max(e for e, _ in exact64.values()) > F64_TOL:
        fail(f"whisper run against float64 of batch_grad: {exact64} (limit {F64_TOL})")
    del model, params, x
    torch.cuda.empty_cache()

    # KFAC with DiagGGN-MC at the vocabulary of 8192
    kcfg, model, params = whisper32(spec["kfac_vocab"])
    x, labels, draws = batch(kcfg, n, s_len, spec["masked"])
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    kres = run(model, params, x, labels, loss, extensions=(by_name("kfac"),
                                                           by_name("diag_ggn_mc")),
               cfg=fused, rng=draws)
    torch.cuda.synchronize()
    kfac_s = time.perf_counter() - t0
    kfac_launches = ops.launch_counts()
    head = kres.ext["kfac"]["head"]["w"]
    finite = all(torch.isfinite(v).all() for v in tree_leaves(kres.ext))
    out["kfac"] = dict(vocab=kcfg.vocab, s=kfac_s, launches=kfac_launches,
                       head_factors=[list(head["A"].shape), list(head["B"].shape)],
                       finite=bool(finite), diag_ggn_mc_min=min(
                           v.min().item() for v in tree_leaves(kres.ext["diag_ggn_mc"])))
    say("whisper_run_kfac", **out["kfac"])
    kwant = counts(fused_second_order=dense, flash_attention=attn)
    if kfac_launches != kwant:
        fail(f"whisper kfac launched {kfac_launches}, derived {kwant}")
    if (not finite or out["kfac"]["diag_ggn_mc_min"] < 0
            or out["kfac"]["head_factors"] != [[d, d], [kcfg.vocab] * 2]):
        fail(f"whisper kfac: {out['kfac']}")
    del kres, model, params, x
    torch.cuda.empty_cache()

    # the reduced config, card against CPU, the draws passed in
    ccfg, model, params = whisper32(reduced=True)
    x, labels, draws = batch(ccfg, spec["cpu_batch"], spec["cpu_seq"], 3)
    cnames = names + ("kfac",)
    cexts = tuple(by_name(e) for e in cnames)
    card = run(model, params, x, labels, loss, extensions=cexts, cfg=fused, rng=draws)
    cpu = run(model, tree_map(lambda p: p.cpu(), params), tree_map(lambda a: a.cpu(), x),
              labels.cpu(), loss, extensions=cexts, cfg=fused, rng=draws.cpu())
    errs = _ext_errs(card, cpu, cnames)
    out["run_card_vs_cpu"] = errs
    say("whisper_run_card_vs_cpu", reduced=True, rel_err=errs, tol=TOL)
    if max(errs.values()) > TOL:
        fail(f"whisper run reduced card vs CPU: {errs}")
    del card, cpu, model, params

    # -- the training launcher, bf16 ---------------------------------------------------
    out["launcher"] = launcher_runs(
        torch, ops, "whisper_train", ["--arch", spec["arch"], "--full", "--seq", str(s_len),
                                      "--batch", str(n)], (
            ("adamw", spec["adamw_steps"], [], counts(flash_attention=attn)),
            ("diag_ggn_mc", spec["mc_steps"], ["--track-variance"],
             counts(flash_attention=attn, fused_first_order=dense, fused_second_order=dense))),
        dict(enc_layers=cfg.enc_layers, dec_layers=cfg.dec_layers, d_model=d, vocab=cfg.vocab,
             dtype=cfg.dtype, batch=n, frames=s_len, tokens=cfg.dec_len))

    # -- the serving example ---------------------------------------------------------
    # the reduced configs' 24 serve_steps (StableLM-2: 2 layers, RWKV6: 2);
    # Whisper's encode (2 layers) and 16 steps of 2 decoder layers
    rows, s, launches, _ = _measured(torch, ops, lambda: serving_example.main([]))
    want = counts(flash_attention=24 * 2 + 2 + 16 * 2 * 2, wkv=24 * 2)
    out["example"] = dict(s=s, launches=launches, launches_derived=want,
                          shapes={k: list(v.shape) for k, v in rows.items()})
    say("whisper_serving_example", **out["example"])
    if launches != want:
        fail(f"the serving example launched {launches}, derived {want}")
    out["launches"] = {k: enc_launches[k] + gen_launches[k] + launches[k]
                       + out["run"]["launches"][k] + kfac_launches[k]
                       + sum(r["launches"][k] for r in out["launcher"].values())
                       for k in ops.KERNELS}
    return out


# The observability layer (obs_phase): 3C3D's fused and per-extension
# run with repro_torch.obs off and on (results bit for bit, kernel.calls.*
# against the launch counts, 5 timed in turns); the training launcher with its
# obs flags at StableLM-2's full size in bf16, DiagGGN-MC with Variance (its
# moment is fused_first_order's: the train phase's MC run), 3 steps at the
# train phase's 4 × 512 (and the same 3 steps without them); one more Hymba-1.5B
# generate (4 × 32 → 128); the ntk_apps launcher's GP on c2d2 with
# --trace-jsonl.  The symbols by which the profiler's trace names each kernel
# the launcher runs (tf32x3::xty_kernel, rowprod::kernel, the anonymous
# namespace's flash_tc_kernel).
OBS = dict(turns=5, launcher_steps=3, ntk_argv=["--gp", "--model", "c2d2"],
           symbols={"fused_first_order": "xty_kernel", "fused_second_order": "rowprod::kernel",
                    "flash_attention": "flash_tc_kernel"})


def obs_phase(torch, ops, record):
    """``repro_torch.obs`` on the card, outside every other profiler window,
    each part's launches read as the change of the launch counts over it:

    * 3C3D at batch 128 with the ten extensions, ``SweepPlan.run`` on the
      fused and the per-extension route: twice with obs off, once under an
      ``ObsRegistry`` with a JSONL sink; each output leaf with obs on equal
      bit for bit to obs off wherever the two runs with obs off are (the
      others named); ``kernel.calls.*`` equal to the launches and to the
      route's counts; the rendered span tree printed; the fused run timed
      off and on in turns, the ratio printed (no limit);
    * ``launch.train.main`` on StableLM-2-1.6B (``--full``, bf16) with
      DiagGGN-MC and Variance, 3 steps, without the obs flags and then with
      ``--trace-jsonl``, ``--metrics-report`` and ``--profile-dir``: 3
      ``train/step`` spans and ``train.steps``, ``kernel.calls.*`` equal to
      the launches, the Chrome trace holding fused_first_order's,
      fused_second_order's and flash_attention's kernels by their symbols
      and the ``train/step`` ranges; the steps' times with and without;
    * Hymba-1.5B's ``generate`` under a registry: ``serve/prefill`` and
      ``serve/decode``, ``serve.tokens`` = 4 · 96, ``kernel.calls.wkv`` and
      ``flash_attention`` equal to the launches, ``serve.decode.s_per_token``
      beside the serve phase's own time a token;
    * ``launch.ntk_apps.main`` (GP on c2d2) with ``--trace-jsonl``: its
      ``ntk_apps/*`` spans, ``kernel.calls.cross_dot`` equal to the launches.
    """
    import tempfile

    from repro_torch import obs
    from repro_torch.configs import get_config, papernets
    from repro_torch.core import CrossEntropyLoss, ExtensionConfig, by_name, plan_sweeps
    from repro_torch.launch import ntk_apps as ntk_launch
    from repro_torch.launch import train as train_launch
    from repro_torch.nn.models import build_model
    from repro_torch.obs.profile import TRACE_FILE
    from repro_torch.obs.reporting import load_jsonl, render
    from repro_torch.serve import ServeConfig, generate

    card = record["device"]["nvidia_smi"]
    out = {}

    def delta(before):
        now = ops.launch_counts()
        return {k: now[k] - before[k] for k in ops.KERNELS}

    def calls_of(counters):
        """kernel.calls.* as {kernel: count}, every kernel named."""
        return {k: counters.get(f"kernel.calls.{k}", 0) for k in ops.KERNELS}

    def summed(events):
        counters = {}
        for e in events:
            if e["kind"] == "count":
                counters[e["name"]] = counters.get(e["name"], 0) + e["value"]
        return counters

    def spans(events, name):
        return [e for e in events if e["kind"] == "span" and e["name"] == name]

    def report(label, text):
        say("obs_report", label=label, card=card)
        print(text, flush=True)

    torch.cuda.synchronize()
    ops.reset_launch_counts()
    with tempfile.TemporaryDirectory(prefix="obs_phase_") as tmp:
        # -- 3C3D: results bit for bit with obs on, the counters, the cost -----
        model = papernets.c3d3(device="cuda", generator=torch.Generator().manual_seed(0))
        params = model.params()
        gen = torch.Generator(device="cuda").manual_seed(31)
        x = torch.randn(N, 32, 32, 3, device="cuda", generator=gen)
        y = torch.randint(0, 10, (N,), device="cuda", generator=gen)
        loss = CrossEntropyLoss()
        exts = tuple(by_name(n) for n in FIRST + EXACT + MC)
        fused_counts = {"fused_first_order": 3, "fused_second_order": 6, "sq_matmul": 9}
        out["c3d3"] = {}
        for route, cfg, per_call in (
                ("fused", ExtensionConfig(mc_seed=0), fused_counts),
                ("per_extension", ExtensionConfig(mc_seed=0, use_fused=False),
                 PER_EXTENSION_LAUNCHES)):
            plan = plan_sweeps(exts, cfg)

            def call(plan=plan, cfg=cfg):
                res = plan.run(model, params, x, y, loss, cfg=cfg)
                torch.cuda.synchronize()
                return _by_path(dict(loss=res.loss, grads=res.grads, logits=res.logits,
                                     ext=res.ext))

            off1, off2 = call(), call()
            trace = os.path.join(tmp, f"c3d3_{route}.jsonl")
            reg = obs.ObsRegistry(trace_jsonl=trace)
            before = ops.launch_counts()
            with obs.use(reg):
                on = call()
            launches = delta(before)
            reg.close()
            unstable = sorted(k for k in off1 if not torch.equal(off1[k], off2[k]))
            differ = sorted(k for k in off1
                            if k not in unstable and not torch.equal(off1[k], on[k]))
            calls = calls_of(reg.counters)
            want = {k: per_call.get(k, 0) for k in ops.KERNELS}
            row = dict(route=route, leaves=len(off1), not_bit_stable_off=unstable,
                       differ_on=differ, kernel_calls=calls, launches=launches,
                       events=len(reg.events), card=card)
            del off1, off2, on
            if route == "fused":  # obs off and on in turns: what the spans cost
                times = {"off": [], "on": []}
                for _ in range(OBS["turns"]):
                    for mode in ("off", "on"):
                        t0 = time.perf_counter()
                        if mode == "on":
                            with obs.use(obs.ObsRegistry()):
                                call()
                        else:
                            call()
                        times[mode].append(time.perf_counter() - t0)
                med = medians_ms(times)
                row.update(step_s=times, median_ms=med, on_over_off=med["on"] / med["off"])
            out["c3d3"][route] = row
            say("obs_c3d3", **row)
            report(f"c3d3 {route}", render(load_jsonl(trace)))
            if differ:
                fail(f"obs c3d3 {route}: leaves differ with obs on: {differ}")
            if calls != launches or launches != want:
                fail(f"obs c3d3 {route}: kernel.calls {calls}, launches {launches}, "
                     f"the route's {want}")
        del model, params, x, y

        # -- the training launcher: its three obs flags, and the same steps without --
        t = TRAIN_LM
        argv = ["--arch", t["arch"], "--full", "--seq", str(t["seq"]), "--batch",
                str(t["batch"]), "--optimizer", "diag_ggn_mc", "--track-variance", "--steps",
                str(OBS["launcher_steps"])]
        plain = [h["dur_s"] for h in train_launch.main(argv)["history"]]
        torch.cuda.empty_cache()
        trace, prof_dir = os.path.join(tmp, "train.jsonl"), os.path.join(tmp, "prof")
        before = ops.launch_counts()
        t0 = time.perf_counter()
        run_ = train_launch.main(argv + ["--trace-jsonl", trace, "--metrics-report",
                                         "--profile-dir", prof_dir])
        call_s = time.perf_counter() - t0
        launches = delta(before)
        hist = [h["dur_s"] for h in run_["history"]]
        del run_
        torch.cuda.empty_cache()
        events = load_jsonl(trace)
        counters = summed(events)
        chrome_path = os.path.join(prof_dir, TRACE_FILE)
        chrome_bytes = os.path.getsize(chrome_path)
        t0 = time.perf_counter()
        with open(chrome_path) as fh:
            chrome = json.load(fh)["traceEvents"]
        load_s = time.perf_counter() - t0
        kernels = [e["name"] for e in chrome if str(e.get("cat", "")).lower() == "kernel"]
        found = {k: sum(sym in name for name in kernels) for k, sym in OBS["symbols"].items()}
        ranges = sum(e.get("name") == "train/step" for e in chrome)
        del chrome
        steps = [e["attrs"]["step"] for e in spans(events, "train/step")]
        row = dict(argv=argv, steps=steps, train_steps=counters.get("train.steps"),
                   kernel_calls=calls_of(counters), launches=launches, step_s=hist,
                   step_s_without_obs=plain,
                   median_ms=medians_ms({"with_obs_and_profiler": hist[1:],
                                         "without": plain[1:]}),
                   call_s=call_s, chrome_trace_bytes=chrome_bytes, chrome_load_s=load_s,
                   device_kernel_events=len(kernels), kernel_events_by_symbol=found,
                   train_step_ranges=ranges, card=card)
        out["launcher"] = row
        say("obs_launcher", **row)
        if steps != list(range(OBS["launcher_steps"])) or row["train_steps"] != len(steps):
            fail(f"obs launcher: train/step spans {steps}, train.steps {row['train_steps']}")
        if row["kernel_calls"] != launches or not launches["fused_first_order"]:
            fail(f"obs launcher: kernel.calls {row['kernel_calls']}, launches {launches}")
        if not all(found.values()) or ranges < len(steps):
            fail(f"obs launcher: the Chrome trace's kernels by symbol {found}, "
                 f"train/step ranges {ranges}")

        # -- Hymba-1.5B's generate under a registry ---------------------------------
        cfg = get_config(SERVE["arch"])
        model = build_model(cfg, device="cuda",
                            generator=torch.Generator(device="cuda").manual_seed(0))
        params = model.params()
        n, p = SERVE["batch"], SERVE["prompt_len"]
        prompts = torch.randint(0, cfg.vocab, (n, p), device="cuda",
                                generator=torch.Generator(device="cuda").manual_seed(7))
        sc = ServeConfig(max_len=SERVE["max_len"])
        reg = obs.ObsRegistry()
        before = ops.launch_counts()
        t0 = time.perf_counter()
        with obs.use(reg):
            toks = generate(model, params, prompts, sc)
        torch.cuda.synchronize()
        gen_s = time.perf_counter() - t0
        launches = delta(before)
        ok = tuple(toks.shape) == (n, sc.max_len) and torch.equal(toks[:, :p], prompts.int())
        del model, params, toks
        torch.cuda.empty_cache()
        tree = {e["name"]: e["attrs"] for e in reg.events if e["kind"] == "span"}
        serve = record["serve"]
        row = dict(spans=tree, counters={k: v for k, v in reg.counters.items()
                                         if not k.startswith("kernel.")},
                   kernel_calls=calls_of(reg.counters), launches=launches, s=gen_s,
                   s_per_token=reg.gauges.get("serve.decode.s_per_token"),
                   serve_phase_ms_per_token=serve["decode"]["ms_per_token"],
                   serve_phase_ms_per_serve_step=serve["generate"]["ms_per_serve_step"],
                   card=card)
        out["generate"] = row
        say("obs_generate", **row)
        report("hymba generate", reg.report())
        want_tree = {"serve/prefill": {"n": n, "tokens": p},
                     "serve/decode": {"n": n, "tokens": sc.max_len - p}}
        if (not ok or tree != want_tree
                or row["counters"].get("serve.tokens") != n * (sc.max_len - p)
                or row["counters"].get("serve.requests") != n
                or not row["s_per_token"] or row["s_per_token"] <= 0):
            fail(f"obs generate: spans {tree}, counters {row['counters']}, tokens ok {ok}")
        if row["kernel_calls"] != launches or not (launches["wkv"]
                                                  and launches["flash_attention"]):
            fail(f"obs generate: kernel.calls {row['kernel_calls']}, launches {launches}")

        # -- the ntk_apps launcher with --trace-jsonl ---------------------------------
        trace = os.path.join(tmp, "ntk.jsonl")
        before = ops.launch_counts()
        ntk_launch.main(OBS["ntk_argv"] + ["--trace-jsonl", trace])
        launches = delta(before)
        events = load_jsonl(trace)
        names = sorted({e["name"] for e in events if e["kind"] == "span"})
        row = dict(argv=OBS["ntk_argv"], spans=names, kernel_calls=calls_of(summed(events)),
                   launches=launches, card=card)
        out["ntk_apps"] = row
        say("obs_ntk_apps", **row)
        report("ntk_apps --gp", render(events))
        if not {"ntk_apps/gp_predict", "ntk_apps/kernel", "ntk_apps/kernel_solve"} <= set(names):
            fail(f"obs ntk_apps: spans {names}")
        if row["kernel_calls"] != launches or not launches["cross_dot"]:
            fail(f"obs ntk_apps: kernel.calls {row['kernel_calls']}, launches {launches}")
    out["launches"] = ops.launch_counts()
    if obs.enabled():
        fail("obs: a launcher left its registry enabled")
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
    t_script = time.perf_counter()
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
    cases += dense_kernel_cases(torch)
    cases += whisper_kernel_cases(torch)
    cases += moe_kernel_cases(torch)
    cases += mla_kernel_cases(torch)

    wrapper = {k: getattr(ops, k) for k in ops.KERNELS}
    plain = {k: getattr(ref, k) for k in ops.KERNELS}
    # [N, R, a] rows get a group axis of 1; the experts' rows come with theirs
    plain["fused_first_order"] = lambda A, B, **w: ref.fused_first_order(
        A if A.dim() == 4 else A[None], B if B.dim() == 4 else B[None], **w)
    plain["batch_l2"] = lambda A, B, form, **w: ref.batch_l2(A, B, **w)
    plain["cross_dot"] = lambda A1, B1, A2, B2, **w: ref.cross_dot(
        ops.full_a_side(A1, B1), B1, ops.full_a_side(A2, B2), B2, **w)
    library = {"sq_matmul": lambda A, B: torch.matmul(A.square().T, B.square()),
               "flash_attention": library_attention(torch)}

    def library_of(kernel, args, kw):
        """The row's library call: the kernel's (every row of it has one), or
        for fused_first_order's expert rows (R = 1, moment alone) ``bmm`` of
        the squares; None where there is none."""
        if kernel in library:
            return library[kernel]
        if (kernel == "fused_first_order" and args[0].dim() == 4 and args[0].shape[2] == 1
                and not kw.get("want_l2", True) and not kw.get("want_dot", False)):
            return expert_moment_library(torch)
        return None
    per_kernel = {k: dict(ms=0.0, plain_ms=0.0, bound_ms=0.0, bound_tf32_ms=0.0,
                          library_ms=0.0, ops_ms=0.0, bytes_ms=0.0, max_abs_err=0.0,
                          max_rel_err=0.0, shapes=[], library_rows=[])
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

        lib = library_of(kernel, args, kw)

        def run_library():
            return lib(*args, **kw)

        if lib is not None:  # in turns: kernel, library, library, kernel
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
        if lib is not None or kernel == "wkv" or kernel in F64_CHECKED:
            profiled_rows.append((row, args, kw, lib))
        # A float32 plain version may sit farther from the formula in float64
        # than ``tol`` (cuBLAS's sum over the LM head's K = 2048 · 100352 for
        # fused_first_order's dot reads 1.3e-4): the row is then held to
        # float64 alone (F64_TOL and ENTRY_TOL, 33× and 40× tighter than tol).
        plain_off = kernel in F64_CHECKED and extra["plain"]["rel64"] > tol
        row["held_to"] = "float64" if plain_off else "plain and float64" if (
            kernel in F64_CHECKED) else "plain"
        if not rel_err <= tol and not plain_off:
            fail(f"{kernel} {label}: relative error {rel_err:.3e} above {tol}")
        if kernel in F64_CHECKED and not (extra["rel64"] <= F64_TOL
                                          and extra["entry_median"] <= ENTRY_TOL):
            fail(f"{kernel} {label}: against float64 {extra['rel64']:.3e} (limit {F64_TOL}), "
                 f"entry median {extra['entry_median']:.3e} (limit {ENTRY_TOL})")
        if kernel == "cross_dot" and "two row sets" not in label and not torch.equal(
                got["out"], got["out"].transpose(1, 2)):
            fail(f"cross_dot {label}: one row set, but not symmetric bit for bit")
        if kernel == "fused_first_order" and "dot" in got and not (
                torch.equal(got["dot"], got["dot"].T)
                and torch.equal(got["l2"], torch.diagonal(got["dot"]))):
            fail(f"fused_first_order {label}: dot not symmetric, or l2 not its diagonal, "
                 "bit for bit")
        if kernel in ROW_CHECKED and tol == BF16_TOL and not extra["row_rel_err"] <= ROW_TOL:
            fail(f"{kernel} {label}: row error {extra['row_rel_err']:.3e} above {ROW_TOL}")
        # decode takes the split-KV design; bf16 prefill and training forward,
        # at every width the configs use, the tensor cores; float32 "simt"
        want_design = ("split" if "decode" in label.split()
                       else "wgmma" if label.startswith(("prefill bf16", "wide prefill bf16",
                                                         "train_lm bf16", "whisper bf16"))
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
        if lib_ms is not None and kernel in library:
            agg["library_ms"] += weight * lib_ms
        elif lib_ms is not None:  # a library call for some of the kernel's rows only
            agg["library_rows"].append(dict(shape=label, ms=ms, library_ms=lib_ms))
    # Device time a call, each from a profiler window of its own.
    for row, args, kw, lib in profiled_rows:
        kernel = row["kernel"]
        extra = dict(device_ms=device_per_call(torch, lambda: wrapper[kernel](*args, **kw))[0])
        extra["device_share"] = row["bound_ms"] / extra["device_ms"]
        if lib is not None:
            extra["library_device_ms"], extra["library_kernels"] = device_per_call(
                torch, lambda: lib(*args, **kw))
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

    def compare(label, mdl, prm, xx, yy, names, rng, cfg_k=cfg_fused):
        """``card_vs_cpu``'s line, printed; fails on a sub-batch that flips
        again or an output above ``TOL``."""
        line = card_vs_cpu(torch, run, mdl, prm, xx, yy, loss, names, rng, cfg_k)
        errs, refl = line.pop("rel_err"), line.pop("reflipped")
        line.pop("bad")
        if refl:
            say("compare", label=label, tol=TOL, rel_err=errs, reflipped=refl, **line)
            fail(f"{label}: the sub-batch without the flipped samples flips again: {refl}")
        return check_errs(label, errs, **line)

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

    # -- 9b. the accumulated lane: the main path and the Gram family in slices
    record["accumulated"] = accumulated_phase(torch, ops, model, params, loss, exts, gram_exts)

    # -- 9c. the matrix-free lane and its NTK consumers --------------------------
    record["matfree"] = matfree_phase(torch, ops, model, params, x, y, loss)

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

    # -- 11. the language models' paths, each phase's seconds recorded ---------
    record["phase_s"] = {"before_serve": time.perf_counter() - t_script}
    for name, phase in (
            ("serve", lambda: serve_phase(torch, ops)),  # Hymba-1.5B
            ("serve_dense", lambda: serve_phase(torch, ops, SERVE_DENSE)),  # StableLM-2
            ("dense_heads", lambda: dense_heads_phase(torch, ops)),  # full width, cut depth
            ("lm_run", lambda: lm_run_phase(torch, ops)),  # BackPACK on StableLM-2
            ("train_lm", lambda: train_lm_phase(torch, ops)),  # training LMs
            ("whisper", lambda: whisper_phase(torch, ops)),  # the encoder-decoder
            ("moe", lambda: moe_phase(torch, ops)),  # the mixture of experts
            ("mla", lambda: mla_phase(torch, ops)),  # MLA with routed and shared experts
            ("obs", lambda: obs_phase(torch, ops, record))):  # the observability layer
        t0 = time.perf_counter()
        record[name] = phase()
        record["phase_s"][name] = time.perf_counter() - t0
    say("phase_s", **record["phase_s"])

    # -- 12. the kernel table -------------------------------------------------
    # launches: each kernel's count on its path (the fused main path's three
    # run calls; the per-extension route's three for its own kernels; the
    # gram path's one run call and the accumulated main path's pair passes;
    # the matrix-free phase's NTK and GGNGram calls and its 'kernel' NGD steps;
    # the Laplace path's diag and kron predictives;
    # the serving paths' checked prefill call and their generate call; the
    # dense heads' prefill and generate calls; the LM run's full-vocabulary
    # and KFAC calls; the LM training phase's launcher runs, cg_ngd, KFAC and
    # --uncertainty calls; Whisper's encode, generate, run, KFAC, launcher
    # runs and the serving example; Granite's checked prefill call, generate,
    # run and launcher runs; DeepSeek-V2-Lite's checked prefill call, run and
    # training runs; the observability phase, whole).
    lm_launches = {k: record["lm_run"]["launches"][k] + record["train_lm"]["launches"][k]
                   + record["whisper"]["launches"][k] + record["moe"]["launches"][k]
                   + record["mla"]["launches"][k] for k in ops.KERNELS}
    attn = sum(record[p]["launches"]["flash_attention"]
               for p in ("serve", "serve_dense", "dense_heads", "lm_run", "train_lm",
                         "whisper", "moe", "mla"))
    path_launches = dict(launches,
                         fused_first_order=launches["fused_first_order"]
                         + lm_launches["fused_first_order"],
                         fused_second_order=launches["fused_second_order"]
                         + lm_launches["fused_second_order"],
                         per_sample_moment=pe_launches["per_sample_moment"],
                         batch_l2=pe_launches["batch_l2"],
                         cross_dot=gram_launches["cross_dot"]
                         + record["accumulated"]["launches"]["cross_dot"]
                         + record["matfree"]["cross_dot_launches"],
                         predictive_var=laplace_launches["predictive_var"],
                         flash_attention=attn,
                         wkv=record["serve"]["launches"]["wkv"]
                         + record["whisper"]["launches"]["wkv"])
    # the observability phase's path: each kernel it runs, over the whole phase
    path_launches = {k: v + record["obs"]["launches"][k] for k, v in path_launches.items()}
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
            library_rows=agg["library_rows"], shapes=agg["shapes"]))
    record["kernels"] = table
    out = ROOT / "build"
    out.mkdir(exist_ok=True)
    record["script_s"] = time.perf_counter() - t_script
    say("script", seconds=record["script_s"])
    (out / "chip_smoke.json").write_text(json.dumps(record, indent=1, default=str))
    if not all(math.isfinite(r["ms"]) for r in table):
        fail("a kernel time is not finite")
    print(json.dumps({"kernels": table}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
