"""Cross-block pairwise dots on Hopper: wrapper of ``csrc/cross_dot.cu``.

Replaces the Pallas kernel ``cross_dot_pallas``
(``src/repro/kernels/cross_dot.py:64``): out[e,n,m] = ⟨G1[e,n], G2[e,m]⟩ for
the per-sample gradients G = AᵀB, the Gram of the empirical NTK (E = C
classes) and of GGNGram (E = 1, the C·N class-major rows).  The A side may
be given once for all E groups (``A.shape[0] == 1``) and with fewer rows
than B (row p of B pairs with row p mod rows(A) of A), so a broadcast input
is read, never copied.  When the two sides are one row set the kernel
computes the upper triangle only.  The source note in the ``.cu`` file says
what bounds it on the H100; the plain version is
:func:`repro_torch.kernels.ref.cross_dot`.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import _build

SOURCE = "src/repro_torch/kernels/csrc/cross_dot.cu"
REPLACES = "src/repro/kernels/cross_dot.py:64"


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = _build.load("cross_dot")
    P, I, L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.cross_dot_scratch_floats.argtypes = [I, I, I, I, I, I]
    lib.cross_dot_scratch_floats.restype = L
    lib.cross_dot_launch.argtypes = [P, P, P, P] + [I] * 11 + [P, P, P]
    lib.cross_dot_launch.restype = I
    return lib


def _a_layout(name: str, A: torch.Tensor, B: torch.Tensor):
    """(a_per_group, a_rows) of an A side [E_A, N_A, R, a] against B [E, N, R, b]."""
    e, n, r = B.shape[:3]
    ea, na, ra = A.shape[:3]
    if ea not in (1, e) or ra != r or na == 0 or n % na or A.device != B.device:
        raise ValueError(f"cross_dot: {name} {tuple(A.shape)} on {A.device} does not "
                         f"pair with {tuple(B.shape)} on {B.device}")
    return int(ea == e and e > 1), na


def cross_dot_cuda(A1: torch.Tensor, B1: torch.Tensor, A2: torch.Tensor,
                   B2: torch.Tensor) -> torch.Tensor:
    """A1 [E or 1, N1/k, R, a], B1 [E, N1, R, b], A2 [E or 1, N2/k', R, a],
    B2 [E, N2, R, b] (float32, contiguous, CUDA) → [E, N1, N2]."""
    for name, x in (("A1", A1), ("B1", B1), ("A2", A2), ("B2", B2)):
        _build.check_input("cross_dot", name, x, 4)
    e, n1, r, b = B1.shape
    n2, a = B2.shape[1], A1.shape[-1]
    if B2.shape[0] != e or B2.shape[2:] != (r, b) or A2.shape[-1] != a:
        raise ValueError(f"cross_dot: B1 {tuple(B1.shape)}, A2 {tuple(A2.shape)} and "
                         f"B2 {tuple(B2.shape)} do not pair")
    g1, rows1 = _a_layout("A1", A1, B1)
    g2, rows2 = _a_layout("A2", A2, B2)
    sym = int(A1.data_ptr() == A2.data_ptr() and A1.shape == A2.shape
              and B1.data_ptr() == B2.data_ptr() and B1.shape == B2.shape)
    lib = _lib()
    with torch.cuda.device(B1.device):
        out = torch.empty((e, n1, n2), device=B1.device, dtype=torch.float32)
        scratch = torch.empty(lib.cross_dot_scratch_floats(e, n1, n2, a, b, sym),
                              device=B1.device, dtype=torch.float32)
        code = lib.cross_dot_launch(
            A1.data_ptr(), B1.data_ptr(), A2.data_ptr(), B2.data_ptr(), e, n1, n2, r, a, b,
            g1, rows1, g2, rows2, sym, out.data_ptr(), scratch.data_ptr(),
            torch.cuda.current_stream(B1.device).cuda_stream)
    _build.check_status("cross_dot", code)
    return out
