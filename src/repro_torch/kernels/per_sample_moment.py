"""Sequence second moment Σ_n (A_nᵀB_n)∘² on Hopper: wrapper of
``csrc/per_sample_moment.cu``.

Replaces the Pallas kernel ``per_sample_moment_pallas``
(``src/repro/kernels/per_sample_moment.py:38``): the R > 1 SecondMoment and
Variance of the per-extension route, and its DiagGGN(MC) on the broadcast
``[C·N, R, a]`` input, without writing the N per-sample gradients to device
memory.  The source note in the ``.cu`` file says what bounds it on the H100
and how the design answers that; the plain version is
:func:`repro_torch.kernels.ref.per_sample_moment`.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import _build

SOURCE = "src/repro_torch/kernels/csrc/per_sample_moment.cu"
REPLACES = "src/repro/kernels/per_sample_moment.py:38"


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = _build.load("per_sample_moment")
    P, I, L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.per_sample_moment_scratch_floats.argtypes = [I, I, I]
    lib.per_sample_moment_scratch_floats.restype = L
    lib.per_sample_moment_launch.argtypes = [P, P, I, I, I, I, P, P, P]
    lib.per_sample_moment_launch.restype = I
    return lib


def per_sample_moment_cuda(A: torch.Tensor, B: torch.Tensor) -> torch.Tensor:
    """A [N, R, a], B [N, R, b] (float32, contiguous, CUDA) → [a, b]."""
    _build.check_input("per_sample_moment", "A", A, 3)
    _build.check_input("per_sample_moment", "B", B, 3)
    if A.shape[:2] != B.shape[:2]:
        raise ValueError(f"per_sample_moment: A {tuple(A.shape)} and B {tuple(B.shape)} do not pair")
    _build.check_devices("per_sample_moment", A=A, B=B)
    n, r, a = A.shape
    b = B.shape[-1]
    lib = _lib()
    with torch.cuda.device(A.device):
        out = torch.empty((a, b), device=A.device, dtype=torch.float32)
        scratch = torch.empty(lib.per_sample_moment_scratch_floats(n, a, b),
                              device=A.device, dtype=torch.float32)
        code = lib.per_sample_moment_launch(
            A.data_ptr(), B.data_ptr(), n, r, a, b, out.data_ptr(),
            scratch.data_ptr(), torch.cuda.current_stream(A.device).cuda_stream)
    _build.check_status("per_sample_moment", code)
    return out
