"""GLM predictive variance on Hopper: wrapper of ``csrc/predictive_var.cu``.

Replaces the Pallas kernel ``predictive_var_pallas``
(``src/repro/kernels/predictive_var.py:81``): var[c,n] = Σ_ab (A_nᵀS_cn)²
[· Σ_ab] for one layer of the Laplace GLM predictive, without writing the
per-sample Jacobian [C, N, a, b] to device memory.  A diagonal posterior
passes its covariance diagonal ``Sigma``; a Kronecker posterior passes
half-transformed inputs and no ``Sigma``.  The source note in the ``.cu``
file says what bounds it on the H100; the plain version is
:func:`repro_torch.kernels.ref.predictive_var`.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Optional

import torch

from repro_torch.kernels import _build

SOURCE = "src/repro_torch/kernels/csrc/predictive_var.cu"
REPLACES = "src/repro/kernels/predictive_var.py:81"


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = _build.load("predictive_var")
    P, I, L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.predictive_var_scratch_floats.argtypes = [I, I, I, I]
    lib.predictive_var_scratch_floats.restype = L
    lib.predictive_var_launch.argtypes = [P, P, P, I, I, I, I, I, P, P, P]
    lib.predictive_var_launch.restype = I
    return lib


def predictive_var_cuda(A: torch.Tensor, S: torch.Tensor,
                        Sigma: Optional[torch.Tensor] = None) -> torch.Tensor:
    """A [N, R, a], S [C, N, R, b], Sigma [a, b] or None (float32,
    contiguous, CUDA) → var [C, N]."""
    _build.check_input("predictive_var", "A", A, 3)
    _build.check_input("predictive_var", "S", S, 4)
    c, n, r, b = S.shape
    a = A.shape[-1]
    if A.shape[:2] != (n, r) or A.device != S.device:
        raise ValueError(f"predictive_var: A {tuple(A.shape)} on {A.device} and "
                         f"S {tuple(S.shape)} on {S.device} do not pair")
    if Sigma is not None:
        _build.check_input("predictive_var", "Sigma", Sigma, 2)
        if tuple(Sigma.shape) != (a, b) or Sigma.device != A.device:
            raise ValueError(f"predictive_var: Sigma {tuple(Sigma.shape)} on {Sigma.device}, "
                             f"expected ({a}, {b}) on {A.device}")
    lib = _lib()
    with torch.cuda.device(A.device):
        out = torch.empty((c, n), device=A.device, dtype=torch.float32)
        scratch = torch.empty(lib.predictive_var_scratch_floats(c, n, a, b),
                              device=A.device, dtype=torch.float32)
        code = lib.predictive_var_launch(
            A.data_ptr(), S.data_ptr(), None if Sigma is None else Sigma.data_ptr(),
            c, n, r, a, b, out.data_ptr(), scratch.data_ptr(),
            torch.cuda.current_stream(A.device).cuda_stream)
    _build.check_status("predictive_var", code)
    return out
