"""What the CPU can check of the kernels' wrappers: which design a
flash_attention call takes, and the refusals every wrapper makes before it
touches a card.

``flash_attention.design`` is pure (shapes, dtypes, positions, window,
alignment): bf16 prefill goes to the tensor-core design ("wgmma"), the rest
to the CUDA-core one ("simt").  The wrappers check dtypes, dimensions and
the pairing of shapes before the device (``_build.check_input``, then
``_build.check_devices``), so CPU tensors reach those checks; a CPU tensor
of a good shape is refused for its device.  No JAX here: the kernels'
arithmetic is held against JAX in ``tests/test_torch_kernels.py`` and
``tests/test_torch_lm.py`` through their plain versions, and on the card in
``tests/test_torch_card.py``.
"""
import importlib

import pytest
import torch

from repro_torch.kernels import ops
from repro_torch.kernels.flash_attention import design, flash_attention_cuda
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
                              k_positions=torch.arange(1024, dtype=torch.int32)), "simt"),
    "prefill_with_positions": (_qkv(t=128), None, _positions(128, 128), "simt"),
    "k_positions_only": (_qkv(t=128), None,
                         dict(k_positions=torch.full((128,), -1, dtype=torch.int32)), "simt"),
    "rows_63": (_qkv(t=63, h=1, kv=1), None, {}, "simt"),
    "decode_t1": (_qkv(t=1, s=2048), None, {}, "simt"),
    "t_above_s": (_qkv(t=300, s=100), None, {}, "simt"),
    "window_0": (_qkv(t=128), 0, {}, "simt"),
    "dh32": (_qkv(t=128, dh=32), None, {}, "simt"),
    "dh96": (_qkv(t=128, dh=96), None, {}, "simt"),
    "dh_ne_dv": (_qkv(t=128, dh=64, dv=128), None, {}, "simt"),
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
    "dh128_float32": (*_qkv(t=128, dh=128, dtypes=(F32, F32, F32)), {}, ValueError,
                      "need the wgmma design"),
    "dh128_decode": (*_qkv(t=1, s=64, dh=128), dict(q_positions=torch.tensor([3]),
                                                    k_positions=torch.arange(64)),
                     ValueError, "need the wgmma design"),
    "cpu_tensors": (*_qkv(t=128), {}, ValueError, "CUDA device"),
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
