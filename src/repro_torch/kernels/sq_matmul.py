"""(A∘A)ᵀ(B∘B) on Hopper: wrapper of ``csrc/sq_matmul.cu``.

Replaces the Pallas kernel ``sq_matmul_pallas``
(``src/repro/kernels/sq_matmul.py:36``).  The source note in the ``.cu`` file
says what bounds it on the H100 and how the design answers that; the plain
version is :func:`repro_torch.kernels.ref.sq_matmul`.  A call is one launch:
one output allocation, no scratch.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import _build

SOURCE = "src/repro_torch/kernels/csrc/sq_matmul.cu"
REPLACES = "src/repro/kernels/sq_matmul.py:36"


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = _build.load("sq_matmul")
    P, I, L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.sq_matmul_launch.argtypes = [P, P, L, I, I, P, P]
    lib.sq_matmul_launch.restype = I
    return lib


def sq_matmul_cuda(A: torch.Tensor, B: torch.Tensor) -> torch.Tensor:
    """A [N, a], B [N, b] (float32, contiguous, CUDA) → [a, b] float32."""
    _build.check_input("sq_matmul", "A", A, 2)
    _build.check_input("sq_matmul", "B", B, 2)
    if A.shape[0] != B.shape[0]:
        raise ValueError(f"sq_matmul: A {tuple(A.shape)} and B {tuple(B.shape)} do not pair")
    device = _build.check_devices("sq_matmul", A=A, B=B)
    if device.index != torch.cuda.current_device():
        raise ValueError(f"sq_matmul: A and B lie on {device}, not on the current device "
                         f"cuda:{torch.cuda.current_device()}")
    n, a = A.shape
    b = B.shape[1]
    out = torch.empty((a, b), device=device, dtype=torch.float32)
    code = _lib().sq_matmul_launch(A.data_ptr(), B.data_ptr(), n, a, b, out.data_ptr(),
                                   torch.cuda.current_stream(device).cuda_stream)
    _build.check_status("sq_matmul", code)
    return out
