"""What the CPU can check of the kernels' wrappers: which design a
flash_attention call takes, and the refusals every wrapper makes before it
touches a card.

``flash_attention.design`` is pure (shapes, dtypes, positions, window,
alignment): fewer than 64 query rows a KV head (decode, short prompts) go to
the split-KV design ("split"), bf16 prefill at every head width the
configs use (64, 128, 120, MLA's 192/128, 240) to the tensor-core design
("wgmma"), the rest to the CUDA-core one ("simt"); ``split_keys`` sizes the
"split" design's grid.  The wrappers check dtypes, dimensions and the pairing of shapes before the device
(``_build.check_input``, then ``_build.check_devices``), so CPU tensors
reach those checks; a CPU tensor of a good shape is refused for its
device.  No JAX here: the kernels'
arithmetic is held against JAX in ``tests/test_torch_kernels.py`` and
``tests/test_torch_lm.py`` through their plain versions, and on the card in
``tests/test_torch_card.py``.
"""
import importlib

import pytest
import torch

from repro_torch.kernels import ops
from repro_torch.kernels import wkv as wkv_mod
from repro_torch.kernels.flash_attention import (
    SPLIT_KEY_STEP,
    design,
    flash_attention_cuda,
    split_keys,
    split_scratch_floats,
)
from repro_torch.kernels.sq_matmul import sq_matmul_cuda

BF, F32 = torch.bfloat16, torch.float32


def _qkv(t=2048, s=None, h=25, kv=5, dh=64, dv=None, dtypes=(BF, BF, BF), n=1):
    s = t if s is None else s
    dv = dh if dv is None else dv
    return (torch.empty(n, t, h, dh, dtype=dtypes[0]), torch.empty(n, s, kv, dh, dtype=dtypes[1]),
            torch.empty(n, s, kv, dv, dtype=dtypes[2]))


def _positions(t, s):
    return dict(q_positions=torch.arange(t, dtype=torch.int32),
                k_positions=torch.arange(s, dtype=torch.int32))


def _decode(s, pos=1500, ring=False):
    """Positions of one decode query at ``pos`` against a cache of ``s``
    slots: a ring that wrapped, or a global cache with slots past ``pos``
    empty (−1)."""
    kp = torch.arange(s, dtype=torch.int32)
    if ring:
        kp = torch.where(kp <= pos % s, kp + s, kp)
    else:
        kp[pos + 1:] = -1
    return dict(q_positions=torch.tensor([pos], dtype=torch.int32), k_positions=kp)


# (inputs, window, positions) → the design; every case of the choice.
DESIGNS = {
    "hymba_prefill_global": (_qkv(), None, {}, "wgmma"),
    "hymba_prefill_window1024": (_qkv(), 1024, {}, "wgmma"),
    "window_1": (_qkv(t=128), 1, {}, "wgmma"),
    "dh128_no_gqa": (_qkv(t=256, h=32, kv=32, dh=128), None, {}, "wgmma"),
    "rows_just_64": (_qkv(t=64, h=1, kv=1), None, {}, "wgmma"),
    "g5_rows_65": (_qkv(t=13, h=5, kv=1), None, {}, "wgmma"),
    "t_below_s": (_qkv(t=100, s=300), None, {}, "wgmma"),
    "float32": (_qkv(dtypes=(F32, F32, F32)), None, {}, "simt"),
    "bf16_queries_fp32_cache": (_qkv(dtypes=(BF, F32, F32)), None, {}, "simt"),
    "fp32_queries_bf16_kv": (_qkv(dtypes=(F32, BF, BF)), None, {}, "simt"),
    "decode_positions": (_qkv(t=1, s=1024), 1024,
                         dict(q_positions=torch.tensor([1500], dtype=torch.int32),
                              k_positions=torch.arange(1024, dtype=torch.int32)), "split"),
    "prefill_with_positions": (_qkv(t=128), None, _positions(128, 128), "simt"),
    "k_positions_only": (_qkv(t=128), None,
                         dict(k_positions=torch.full((128,), -1, dtype=torch.int32)), "simt"),
    "rows_63": (_qkv(t=63, h=1, kv=1), None, {}, "split"),
    "decode_t1": (_qkv(t=1, s=2048), None, {}, "split"),
    "t_above_s": (_qkv(t=300, s=100), None, {}, "simt"),
    "window_0": (_qkv(t=128), 0, {}, "simt"),
    "dh32": (_qkv(t=128, dh=32), None, {}, "simt"),
    "dh96": (_qkv(t=128, dh=96), None, {}, "simt"),
    "dh_ne_dv": (_qkv(t=128, dh=64, dv=128), None, {}, "simt"),
    # "split": T·g < 64, whatever the dtypes, positions, window and widths
    "hymba_decode_ring": (_qkv(t=1, s=1024, n=4, dtypes=(BF, F32, F32)), 1024,
                          _decode(1024, ring=True), "split"),
    "hymba_decode_global": (_qkv(t=1, s=2048, n=4, dtypes=(BF, F32, F32)), None,
                            _decode(2048), "split"),
    "hymba_decode_float32": (_qkv(t=1, s=1024, dtypes=(F32, F32, F32)), 1024,
                             _decode(1024, ring=True), "split"),
    "decode_bf16_cache": (_qkv(t=1, s=1024), 1024, _decode(1024, ring=True), "split"),
    "decode_fp32_queries_bf16_cache": (_qkv(t=1, s=256, dtypes=(F32, BF, BF)), None,
                                       _decode(256, pos=100), "split"),
    "decode_g1": (_qkv(t=1, s=2048, h=32, kv=32, dh=128, dtypes=(BF, F32, F32)), None,
                  _decode(2048), "split"),
    "decode_g8": (_qkv(t=1, s=512, h=32, kv=4, dtypes=(BF, F32, F32)), None,
                  _decode(512, pos=300), "split"),
    "decode_dh128": (_qkv(t=1, s=2048, h=32, kv=32, dh=128, dtypes=(BF, F32, F32)), None,
                     _decode(2048), "split"),
    "decode_dh240": (_qkv(t=1, s=1024, h=16, kv=8, dh=240, dtypes=(BF, F32, F32)), 1024,
                     _decode(1024, ring=True), "split"),
    "decode_dh192_dv128": (_qkv(t=1, s=300, h=16, kv=16, dh=192, dv=128), None,
                           _decode(300, pos=200), "split"),
    "rows_63_g7": (_qkv(t=9, h=7, kv=1), None, {}, "split"),
    "rows_64_g8": (_qkv(t=8, h=8, kv=1), None, {}, "wgmma"),
    "rows_63_float32": (_qkv(t=63, h=1, kv=1, dtypes=(F32, F32, F32)), None, {}, "split"),
    "rows_64_float32": (_qkv(t=64, h=1, kv=1, dtypes=(F32, F32, F32)), None, {}, "simt"),
    "short_prompt_g5": (_qkv(t=12), 1024, {}, "split"),
    "short_prompt_t_above_s": (_qkv(t=12, s=5), None, {}, "split"),
    "short_prompt_window_0": (_qkv(t=4), 0, {}, "split"),
    # the configs' wider heads: "wgmma" in bf16 prefill (instances (128,
    # 128), (192, 128), (256, 256), zero-padded), "simt" with positions or
    # in float32, "split" below 64 rows a KV head
    "dh120_prefill": (_qkv(t=256, h=32, kv=8, dh=120), 8192, {}, "wgmma"),
    "mla_prefill": (_qkv(t=256, h=16, kv=16, dh=192, dv=128), None, {}, "wgmma"),
    "dh240_prefill": (_qkv(t=256, h=16, kv=8, dh=240), 1024, {}, "wgmma"),
    "dh120_t_below_s": (_qkv(t=100, s=300, h=32, kv=8, dh=120), None, {}, "wgmma"),
    "mla_window_1": (_qkv(t=128, h=16, kv=16, dh=192, dv=128), 1, {}, "wgmma"),
    "dh120_positions": (_qkv(t=128, h=32, kv=8, dh=120), None, _positions(128, 128), "simt"),
    "mla_positions": (_qkv(t=128, h=16, kv=16, dh=192, dv=128), None, _positions(128, 128),
                      "simt"),
    "dh240_positions": (_qkv(t=128, h=16, kv=8, dh=240), 1024, _positions(128, 128), "simt"),
    "dh120_float32": (_qkv(t=256, h=32, kv=8, dh=120, dtypes=(F32, F32, F32)), None, {},
                      "simt"),
    "mla_float32": (_qkv(t=256, h=16, kv=16, dh=192, dv=128, dtypes=(F32, F32, F32)), None, {},
                    "simt"),
    "dh240_float32": (_qkv(t=256, h=16, kv=8, dh=240, dtypes=(F32, F32, F32)), None, {},
                      "simt"),
    "dh120_short_prompt": (_qkv(t=15, h=32, kv=8, dh=120), None, {}, "split"),
    "mla_short_prompt": (_qkv(t=63, h=16, kv=16, dh=192, dv=128), None, {}, "split"),
    "dh240_short_prompt": (_qkv(t=31, h=16, kv=8, dh=240), 1024, {}, "split"),
    "dh120_dv64": (_qkv(t=128, dh=120, dv=64), None, {}, "simt"),
    "dh192_dv192": (_qkv(t=128, dh=192), None, {}, "simt"),
}


@pytest.mark.parametrize("case", sorted(DESIGNS))
def test_flash_attention_design(case):
    (q, k, v), window, positions, want = DESIGNS[case]
    assert design(q, k, v, window, **positions) == want


def test_flash_attention_design_needs_16_byte_alignment():
    q, k, v = _qkv(t=128)
    flat = torch.zeros(q.numel() + 8, dtype=BF)
    assert design(flat[1:1 + q.numel()].view(q.shape), k, v) == "simt"  # 2 bytes off
    assert design(flat[8:8 + q.numel()].view(q.shape), k, v) == "wgmma"  # 16 bytes off


@pytest.mark.parametrize("dh,dv", [(120, 120), (192, 128), (240, 240)])
def test_flash_attention_design_wide_heads_need_16_byte_alignment(dh, dv):
    q, k, v = _qkv(t=128, h=8, kv=4, dh=dh, dv=dv)
    flat = torch.zeros(q.numel() + 8, dtype=BF)
    assert design(flat[1:1 + q.numel()].view(q.shape), k, v) == "simt"  # 2 bytes off
    assert design(flat[8:8 + q.numel()].view(q.shape), k, v) == "wgmma"  # 16 bytes off


# (S, N·KV·row groups) of the "split" design's calls: Hymba-1.5B's decode
# (batch 4 × 5 KV heads) against its ring of 1024 and global cache of 2048,
# the wide decode rows (CodeQwen1.5-7B: 4 × 32; gemma3-12b: 4 × 8), a single
# key, ragged S, one pair, and a short prompt's row groups.
SPLIT_SHAPES = {"hymba_ring": (1024, 20), "hymba_global": (2048, 20),
                "codeqwen_global": (2048, 128), "gemma3_ring": (1024, 32),
                "one_key": (1, 20), "ragged_1000": (1000, 20), "ragged_150": (150, 6),
                "one_pair_long": (32768, 1), "many_pairs": (300, 5000),
                "short_prompt_groups": (12, 160)}


@pytest.mark.parametrize("case", sorted(SPLIT_SHAPES))
def test_split_keys(case):
    """Every split holds keys, the last one ragged at most; the keys are a
    multiple of the step; the grid fills the H100's 132 SMs at Hymba's
    decode shapes (4 blocks an SM)."""
    s, pairs = SPLIT_SHAPES[case]
    keys = split_keys(s, pairs, 132)
    splits = -(-s // keys)
    assert keys % SPLIT_KEY_STEP == 0 and keys >= SPLIT_KEY_STEP
    assert 1 <= splits and (splits - 1) * keys < s <= splits * keys
    if s >= keys:
        assert splits * keys - s < keys
    if case.startswith("hymba"):
        assert pairs * splits >= 132
    if pairs >= 4 * 132:  # enough blocks already: one split
        assert splits == 1


def test_split_keys_hymba_decode_pinned():
    """Hymba-1.5B's decode on the H100: 64 keys a split for the ring (16
    splits, 320 blocks), 128 for the global cache (16 splits, 320 blocks);
    its partials are (m, l, acc[64]) for each of 4 × 25 query rows a split."""
    assert split_keys(1024, 20, 132) == 64
    assert split_keys(2048, 20, 132) == 128
    assert split_scratch_floats(4, 1, 25, 64, 16) * 4 == 4 * 25 * 16 * 66 * 4 == 422400


def _wkv(t=4, dk=3, dw=1, k_dtype=F32):
    """r, k, v, log w on the CPU: N 1, H 2, dv 5."""
    return (torch.zeros(1, t, 2, dk), torch.zeros(1, t, 2, dk, dtype=k_dtype),
            torch.zeros(1, t, 2, 5), torch.zeros(1, t, 2, dw))


# wkv's own refusals, before the device's: (r, k, v, log w), kwargs, message.
WKV_REFUSALS = {
    "chunk_not_dividing_t": (_wkv(t=6), dict(chunk=4), "chunk 4 does not divide T = 6"),
    "chunk_zero": (_wkv(), dict(chunk=0), "does not divide"),
    "decay_neither_per_head_nor_per_channel": (_wkv(dw=2), dict(chunk=2), "do not pair"),
    "k_dtype_differs": (_wkv(k_dtype=BF), dict(chunk=2), "do not pair"),
    "u_wrong_shape": (_wkv(), dict(chunk=2, u=torch.zeros(2, 4)), r"u must be \[2, 3\]"),
    "state0_wrong_shape": (_wkv(), dict(chunk=2, state0=torch.zeros(1, 2, 5, 3)),
                           r"state0 must be \[1, 2, 3, 5\]"),
}


@pytest.mark.parametrize("case", sorted(WKV_REFUSALS))
def test_wkv_wrapper_refuses(case):
    args, kw, msg = WKV_REFUSALS[case]
    with pytest.raises(ValueError, match=msg):
        wkv_mod.wkv_cuda(*args, **kw)


# Refusals before any device check: (q, k, v, kwargs, error, message).
FA_REFUSALS = {
    "float16": (*_qkv(t=8, dtypes=(torch.float16, BF, BF)), {}, TypeError, "must be one of"),
    "three_dims": (torch.zeros(1, 8, 64, dtype=BF), *_qkv(t=8)[1:], {}, ValueError,
                   "4 dimensions"),
    "heads_not_multiple_of_kv": (*_qkv(t=8, h=7, kv=2), {}, ValueError, "do not pair"),
    "k_v_dtypes_differ": (*_qkv(t=8, dtypes=(BF, BF, F32)), {}, ValueError, "do not pair"),
    "k_v_lengths_differ": (_qkv(t=8)[0], _qkv(t=8)[1], _qkv(t=8, s=9)[2], {}, ValueError,
                           "do not pair"),
    "dh_not_multiple_of_4": (*_qkv(t=8, dh=66), {}, ValueError, "multiples of 4"),
    "dh264_too_wide": (*_qkv(t=8, dh=264), {}, ValueError, "limit of 256"),
    # widths the "simt" design takes pass every shape check and meet the
    # device's
    "dh128_float32": (*_qkv(t=128, dh=128, dtypes=(F32, F32, F32)), {}, ValueError,
                      "CUDA device"),
    "dh128_decode": (*_qkv(t=1, s=64, dh=128), dict(q_positions=torch.tensor([3]),
                                                    k_positions=torch.arange(64)),
                     ValueError, "CUDA device"),
    "dh192_dv128": (*_qkv(t=16, h=16, kv=16, dh=192, dv=128), {}, ValueError, "CUDA device"),
    "cpu_tensors": (*_qkv(t=128), {}, ValueError, "CUDA device"),
    # calls the "split" design would take: the same refusals
    "split_float16": (*_qkv(t=1, s=64, dtypes=(BF, torch.float16, torch.float16)),
                      _decode(64, pos=40), TypeError, "must be one of"),
    "split_dh_not_multiple_of_4": (*_qkv(t=1, s=64, dh=66), _decode(64, pos=40), ValueError,
                                   "multiples of 4"),
    "split_dv264_too_wide": (*_qkv(t=1, s=64, dv=264), _decode(64, pos=40), ValueError,
                             "limit of 256"),
    "split_kv_heads_not_dividing": (*_qkv(t=1, s=64, h=7, kv=2), _decode(64, pos=40),
                                    ValueError, "do not pair"),
    "split_caches_differ": (_qkv(t=1, s=64)[0], _qkv(t=1, s=64)[1],
                            _qkv(t=1, s=65)[2], _decode(64, pos=40), ValueError, "do not pair"),
    "split_decode_cpu_tensors": (*_qkv(t=1, s=1024, dtypes=(BF, F32, F32)),
                                 _decode(1024, ring=True), ValueError, "CUDA device"),
    "split_short_prompt_cpu_tensors": (*_qkv(t=12), {}, ValueError, "CUDA device"),
}


@pytest.mark.parametrize("case", sorted(FA_REFUSALS))
def test_flash_attention_wrapper_refuses(case):
    q, k, v, kw, err, msg = FA_REFUSALS[case]
    with pytest.raises(err, match=msg):
        flash_attention_cuda(q, k, v, **kw)


SQ_REFUSALS = {
    "float64": (torch.zeros(4, 3, dtype=torch.float64), torch.zeros(4, 2), TypeError, "float32"),
    "bf16": (torch.zeros(4, 3), torch.zeros(4, 2, dtype=BF), TypeError, "float32"),
    "three_dims": (torch.zeros(4, 3, 1), torch.zeros(4, 2), ValueError, "2 dimensions"),
    "rows_differ": (torch.zeros(4, 3), torch.zeros(5, 2), ValueError, "do not pair"),
    "cpu_tensors": (torch.zeros(4, 3), torch.zeros(4, 2), ValueError, "CUDA device"),
}


@pytest.mark.parametrize("case", sorted(SQ_REFUSALS))
def test_sq_matmul_wrapper_refuses(case):
    A, B, err, msg = SQ_REFUSALS[case]
    with pytest.raises(err, match=msg):
        sq_matmul_cuda(A, B)


def _z(*shape):
    return torch.zeros(*shape)


# Each wrapper's inputs that pair, on the CPU, and the keyword arguments.
PAIRED = {
    "fused_first_order": ((_z(1, 4, 3, 5), _z(1, 4, 3, 2)), {}),
    "fused_second_order": ((_z(4, 3, 5), _z(2, 4, 3, 2)), {}),
    "per_sample_moment": ((_z(4, 3, 5), _z(4, 3, 2)), {}),
    "batch_l2": ((_z(4, 3, 5), _z(4, 3, 2)), {}),
    "ggn_diag": ((_z(4, 3, 5), _z(2, 4, 3, 2)), {}),
    "cross_dot": ((_z(1, 4, 3, 5), _z(2, 4, 3, 2), _z(1, 4, 3, 5), _z(2, 4, 3, 2)), {}),
    "predictive_var": ((_z(4, 3, 5), _z(2, 4, 3, 2), _z(5, 2)), {}),
    "wkv": ((_z(1, 4, 2, 3), _z(1, 4, 2, 3), _z(1, 4, 2, 5), _z(1, 4, 2, 1)), dict(chunk=2)),
    "sq_matmul": ((_z(4, 3), _z(4, 2)), {}),
    "flash_attention": ((_z(1, 8, 4, 16), _z(1, 8, 2, 16), _z(1, 8, 2, 16)), {}),
}


def _one_more(x, dim):
    shape = list(x.shape)
    shape[dim] += 1
    return torch.zeros(shape, dtype=x.dtype)


# How each case changes the paired inputs, and the refusal it must meet: the
# first input float64, with a dimension more, not contiguous, empty; the
# second input one longer on the axis it shares with the first (PAIRING_DIM,
# else 0); good inputs refused for the CPU.
PAIRING_DIM = {"fused_second_order": 1, "ggn_diag": 1, "cross_dot": 1, "predictive_var": 1,
               "wkv": 1, "flash_attention": 1, "fused_first_order": 1}
REFUSAL_CASES = {
    "float64": (lambda xs, k: (xs[0].double(), *xs[1:]), TypeError, "must be one of"),
    "extra_dim": (lambda xs, k: (xs[0][..., None], *xs[1:]), ValueError, "dimensions"),
    "not_contiguous": (lambda xs, k: (xs[0].transpose(-1, -2).contiguous().transpose(-1, -2),
                                      *xs[1:]), ValueError, "contiguous"),
    "empty": (lambda xs, k: (xs[0][:0], *xs[1:]), ValueError, "empty"),
    "unpaired": (lambda xs, k: (xs[0], _one_more(xs[1], PAIRING_DIM.get(k, 0)), *xs[2:]),
                 ValueError, "pair"),
    "on_cpu": (lambda xs, k: xs, ValueError, "one CUDA device"),
}


@pytest.mark.parametrize("case", sorted(REFUSAL_CASES))
@pytest.mark.parametrize("kernel", sorted(PAIRED))
def test_every_wrapper_refuses_before_the_card(kernel, case):
    """Dtype, dimensions, layout, emptiness and pairing are refused on CPU
    tensors as on CUDA ones; inputs that pass them are refused for the CPU."""
    fn = getattr(importlib.import_module(f"repro_torch.kernels.{kernel}"), f"{kernel}_cuda")
    args, kw = PAIRED[kernel]
    change, err, msg = REFUSAL_CASES[case]
    with pytest.raises(err, match=msg):
        fn(*change(args, kernel), **kw)


def test_cpu_bf16_prefill_takes_the_plain_version():
    """A call the card would give to the wgmma design runs the plain version
    on the CPU and counts no launch."""
    gen = torch.Generator().manual_seed(0)
    q, k, v = (torch.randn(1, 64, h, 64, generator=gen).to(BF) for h in (5, 1, 1))
    ops.reset_launch_counts()
    out = ops.flash_attention(q, k, v, window=16)
    assert ops.launch_counts()["flash_attention"] == 0
    assert out.dtype == BF and out.shape == q.shape
