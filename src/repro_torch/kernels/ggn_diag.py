"""GGN diagonal Σ_cn (A_nᵀS_cn)∘² on Hopper: wrapper of ``csrc/ggn_diag.cu``.

Replaces the Pallas kernel ``ggn_diag_pallas``
(``src/repro/kernels/ggn_diag.py:34``).  Neither package's engine calls it
(the fused second-order kernel computes the same diagonal); it is the
diag-only launch of that kernel's 3xTF32 t kernel (``csrc/rowprod.cuh``)
under its own entry and counter.  The source note in the ``.cu`` file says
what bounds it on the H100; the plain version is
:func:`repro_torch.kernels.ref.ggn_diag`.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import _build

SOURCE = "src/repro_torch/kernels/csrc/ggn_diag.cu"
REPLACES = "src/repro/kernels/ggn_diag.py:34"


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = _build.load("ggn_diag")
    P, I, L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.ggn_diag_scratch_floats.argtypes = [I] * 5
    lib.ggn_diag_scratch_floats.restype = L
    lib.ggn_diag_launch.argtypes = [P, P, I, I, I, I, I, P, P, P]
    lib.ggn_diag_launch.restype = I
    return lib


def ggn_diag_cuda(A: torch.Tensor, S: torch.Tensor) -> torch.Tensor:
    """A [N, R, a], S [C, N, R, b] (float32, contiguous, CUDA) → [a, b]."""
    _build.check_input("ggn_diag", "A", A, 3)
    _build.check_input("ggn_diag", "S", S, 4)
    if A.shape[:2] != S.shape[1:3]:
        raise ValueError(f"ggn_diag: A {tuple(A.shape)} and S {tuple(S.shape)} do not pair")
    _build.check_devices("ggn_diag", A=A, S=S)
    c, n, r, b = S.shape
    a = A.shape[-1]
    lib = _lib()
    with torch.cuda.device(A.device):
        out = torch.empty((a, b), device=A.device, dtype=torch.float32)
        scratch = torch.empty(lib.ggn_diag_scratch_floats(c, n, r, a, b),
                              device=A.device, dtype=torch.float32)
        code = lib.ggn_diag_launch(
            A.data_ptr(), S.data_ptr(), c, n, r, a, b, out.data_ptr(),
            scratch.data_ptr(), torch.cuda.current_stream(A.device).cuda_stream)
    _build.check_status("ggn_diag", code)
    return out
