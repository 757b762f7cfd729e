"""Per-sample squared gradient norms on Hopper: wrapper of ``csrc/batch_l2.cu``.

Replaces the Pallas kernel ``batch_l2_pallas``
(``src/repro/kernels/batch_l2.py:40``): BatchL2 of the R > 1 layers on the
per-extension route.  The kernel has two forms, the TPU kernel's Gram trick
and the gradient's own square; :func:`batch_l2_form` picks the one with
fewer operations for a shape.  The source note in the ``.cu`` file says what
bounds it on the H100 and how each form is laid out; the plain version is
:func:`repro_torch.kernels.ref.batch_l2`.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Optional

import torch

from repro_torch.kernels import _build

SOURCE = "src/repro_torch/kernels/csrc/batch_l2.cu"
REPLACES = "src/repro/kernels/batch_l2.py:40"
FORMS = ("gram", "g")  # the .cu file's form 0 and form 1


def batch_l2_ops(n: int, r: int, a: int, b: int) -> dict:
    """Operations each form needs: the Gram trick on the upper triangle of
    the R x R Grams (2a + 2b for a pair, 2 to multiply and add), or forming
    G_n = A_nᵀB_n (2·R·a·b) and summing its squares (2·a·b)."""
    return {"gram": n * r * (r + 1) // 2 * (2 * a + 2 * b + 2),
            "g": n * (2 * r * a * b + 2 * a * b)}


def batch_l2_form(r: int, a: int, b: int) -> str:
    """The form with fewer operations: the Gram trick where R·(a+b+1) < 2·a·b."""
    ops = batch_l2_ops(1, r, a, b)
    return "gram" if ops["gram"] < ops["g"] else "g"


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = _build.load("batch_l2")
    P, I, L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.batch_l2_scratch_floats.argtypes = [I, I, I, I, I]
    lib.batch_l2_scratch_floats.restype = L
    lib.batch_l2_launch.argtypes = [P, P, I, I, I, I, I, P, P, P]
    lib.batch_l2_launch.restype = I
    return lib


def batch_l2_cuda(A: torch.Tensor, B: torch.Tensor,
                  form: Optional[str] = None) -> torch.Tensor:
    """A [N, R, a], B [N, R, b] (float32, contiguous, CUDA) → [N].  ``form``
    (``"gram"`` or ``"g"``) overrides :func:`batch_l2_form`."""
    _build.check_input("batch_l2", "A", A, 3)
    _build.check_input("batch_l2", "B", B, 3)
    if A.shape[:2] != B.shape[:2]:
        raise ValueError(f"batch_l2: A {tuple(A.shape)} and B {tuple(B.shape)} do not pair")
    n, r, a = A.shape
    b = B.shape[-1]
    form = batch_l2_form(r, a, b) if form is None else form
    if form not in FORMS:
        raise ValueError(f"batch_l2: form must be one of {FORMS}, got {form!r}")
    _build.check_devices("batch_l2", A=A, B=B)
    code_form = FORMS.index(form)
    lib = _lib()
    with torch.cuda.device(A.device):
        out = torch.empty((n,), device=A.device, dtype=torch.float32)
        scratch = torch.empty(lib.batch_l2_scratch_floats(n, r, a, b, code_form),
                              device=A.device, dtype=torch.float32)
        code = lib.batch_l2_launch(
            A.data_ptr(), B.data_ptr(), n, r, a, b, code_form, out.data_ptr(),
            scratch.data_ptr(), torch.cuda.current_stream(A.device).cuda_stream)
    _build.check_status("batch_l2", code)
    return out
