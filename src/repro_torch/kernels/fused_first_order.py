"""Fused first-order statistics on Hopper: wrapper of
``csrc/fused_first_order.cu``.

Replaces the Pallas kernel ``fused_first_order_pallas``
(``src/repro/kernels/fused_first_order.py:87``).  One launch emits the masked
{l2, moment, dot} reductions of the per-sample gradients G[e,n] = A_nᵀB_n
without writing G to device memory.  The source note in the ``.cu`` file says
what bounds it on the H100 and how the design answers that; the plain version
is :func:`repro_torch.kernels.ref.fused_first_order`.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Dict

import torch

from repro_torch.kernels import _build

SOURCE = "src/repro_torch/kernels/csrc/fused_first_order.cu"
REPLACES = "src/repro/kernels/fused_first_order.py:87"


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = _build.load("fused_first_order")
    P, I, L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.fused_first_order_scratch_floats.argtypes = [I, I, I, I, I, I, I]
    lib.fused_first_order_scratch_floats.restype = L
    lib.fused_first_order_launch.argtypes = [P, P, I, I, I, I, I, I, I, I,
                                             P, P, P, P, P]
    lib.fused_first_order_launch.restype = I
    return lib


def fused_first_order_cuda(A: torch.Tensor, B: torch.Tensor, want_l2=True,
                           want_moment=False, want_dot=False
                           ) -> Dict[str, torch.Tensor]:
    """A [E, N, R, a], B [E, N, R, b] (float32, contiguous, CUDA) → dict of
    the requested l2 [E, N], moment [E, a, b], dot [E, N, N]."""
    if not (want_l2 or want_moment or want_dot):
        raise ValueError("fused_first_order: empty extension mask")
    _build.check_input("fused_first_order", "A", A, 4)
    _build.check_input("fused_first_order", "B", B, 4)
    if A.shape[:3] != B.shape[:3]:
        raise ValueError(f"fused_first_order: A {tuple(A.shape)} and B {tuple(B.shape)} "
                         "do not pair")
    _build.check_devices("fused_first_order", A=A, B=B)
    e, n, r, a = A.shape
    b = B.shape[-1]
    lib = _lib()
    with torch.cuda.device(A.device):
        def new(*shape):
            return torch.empty(shape, device=A.device, dtype=torch.float32)

        out = {}
        if want_l2:
            out["l2"] = new(e, n)
        if want_moment:
            out["moment"] = new(e, a, b)
        if want_dot:
            out["dot"] = new(e, n, n)
        scratch = new(lib.fused_first_order_scratch_floats(
            e, n, a, b, int(want_l2), int(want_moment), int(want_dot)))
        ptr = {k: v.data_ptr() for k, v in out.items()}
        code = lib.fused_first_order_launch(
            A.data_ptr(), B.data_ptr(), e, n, r, a, b,
            int(want_l2), int(want_moment), int(want_dot),
            ptr.get("l2"), ptr.get("moment"), ptr.get("dot"),
            scratch.data_ptr(), torch.cuda.current_stream(A.device).cuda_stream)
    _build.check_status("fused_first_order", code)
    return out
