"""Fused second-order (curvature) statistics on Hopper: wrapper of
``csrc/fused_second_order.cu``.

Replaces the Pallas kernel ``fused_second_order_pallas``
(``src/repro/kernels/fused_second_order.py:109``).  One call emits the masked
{diag, kron, trace} reductions of t[c,n] = A_nᵀS_cn for the exact (C classes)
and the MC (C samples) sweeps, without writing t to device memory.  The
source note in the ``.cu`` file says what bounds it on the H100 and how the
design answers that; the plain version is
:func:`repro_torch.kernels.ref.fused_second_order`.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Dict

import torch

from repro_torch.kernels import _build

SOURCE = "src/repro_torch/kernels/csrc/fused_second_order.cu"
REPLACES = "src/repro/kernels/fused_second_order.py:109"


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = _build.load("fused_second_order")
    P, I, L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.fused_second_order_scratch_floats.argtypes = [I, I, I, I, I, I, I, I]
    lib.fused_second_order_scratch_floats.restype = L
    lib.fused_second_order_launch.argtypes = [P, P, I, I, I, I, I, I, I, I,
                                              P, P, P, P, P]
    lib.fused_second_order_launch.restype = I
    return lib


def fused_second_order_cuda(A: torch.Tensor, S: torch.Tensor, want_diag=True,
                            want_kron=False, want_trace=False
                            ) -> Dict[str, torch.Tensor]:
    """A [N, R, a], S [C, N, R, b] (float32, contiguous, CUDA) → dict of the
    requested diag [a, b], kron [b, b] (unscaled SᵀS), trace [N]."""
    if not (want_diag or want_kron or want_trace):
        raise ValueError("fused_second_order: empty extension mask")
    _build.check_input("fused_second_order", "A", A, 3)
    _build.check_input("fused_second_order", "S", S, 4)
    if A.shape[:2] != S.shape[1:3]:
        raise ValueError(f"fused_second_order: A {tuple(A.shape)} and S {tuple(S.shape)} "
                         "do not pair")
    _build.check_devices("fused_second_order", A=A, S=S)
    c, n, r, b = S.shape
    a = A.shape[-1]
    lib = _lib()
    with torch.cuda.device(A.device):
        def new(*shape):
            return torch.empty(shape, device=A.device, dtype=torch.float32)

        out = {}
        if want_diag:
            out["diag"] = new(a, b)
        if want_kron:
            out["kron"] = new(b, b)
        if want_trace:
            out["trace"] = new(n)
        scratch = new(lib.fused_second_order_scratch_floats(
            c, n, r, a, b, int(want_diag), int(want_kron), int(want_trace)))
        ptr = {k: v.data_ptr() for k, v in out.items()}
        code = lib.fused_second_order_launch(
            A.data_ptr(), S.data_ptr(), c, n, r, a, b,
            int(want_diag), int(want_kron), int(want_trace),
            ptr.get("diag"), ptr.get("kron"), ptr.get("trace"),
            scratch.data_ptr(), torch.cuda.current_stream(A.device).cuda_stream)
    _build.check_status("fused_second_order", code)
    return out
