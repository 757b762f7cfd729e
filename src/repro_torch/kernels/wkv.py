"""The chunked RWKV6 / SSD recurrence on Hopper: wrapper of ``csrc/wkv.cu``.

Replaces the Pallas kernel ``wkv_pallas`` (``src/repro/kernels/wkv.py:61``)
and computes ``nn/functional.wkv_chunked`` with the chunk it is given:
r, k [N, T, H, dk], v [N, T, H, dv], ``log_w`` [N, T, H, dk] or
[N, T, H, 1] (Hymba's scalar decay per head), ``u`` [H, dk] or None, and an
optional float32 ``state0`` [N, H, dk, dv]; it returns y in r's dtype and
the final float32 state.  With ``state0=None``, ``u`` given and the state
discarded it is ``wkv_pallas``.  r/k/v are float32 or bfloat16, ``log_w``
likewise on its own.  The source note in the ``.cu`` file says what bounds it
on the H100; the plain version is :func:`repro_torch.kernels.ref.wkv`.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Optional, Tuple

import torch

from repro_torch.kernels import _build

SOURCE = "src/repro_torch/kernels/csrc/wkv.cu"
REPLACES = "src/repro/kernels/wkv.py:61"
DTYPES = (torch.float32, torch.bfloat16)
MAX_SMEM = 232448  # bytes of shared memory a block may use on the H100


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = _build.load("wkv")
    P, I = ctypes.c_void_p, ctypes.c_int
    lib.wkv_smem_bytes.argtypes = [I, I, I, I]
    lib.wkv_smem_bytes.restype = ctypes.c_longlong
    lib.wkv_launch.argtypes = [P] * 8 + [I] * 9 + [P]
    lib.wkv_launch.restype = I
    return lib


def wkv_cuda(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor, log_w: torch.Tensor,
             u: Optional[torch.Tensor] = None, state0: Optional[torch.Tensor] = None,
             chunk: int = 16) -> Tuple[torch.Tensor, torch.Tensor]:
    """(y [N, T, H, dv], state [N, H, dk, dv]) for contiguous CUDA inputs;
    ``chunk`` divides T."""
    for name, x in (("r", r), ("k", k), ("v", v), ("log_w", log_w)):
        _build.check_input("wkv", name, x, 4, DTYPES)
    n, t, h, dk = r.shape
    dv, dw = v.shape[-1], log_w.shape[-1]
    if (k.shape != r.shape or v.shape[:3] != r.shape[:3] or log_w.shape[:3] != r.shape[:3]
            or dw not in (1, dk) or k.dtype != r.dtype or v.dtype != r.dtype):
        raise ValueError(f"wkv: r {tuple(r.shape)}, k {tuple(k.shape)}, v {tuple(v.shape)}, "
                         f"log_w {tuple(log_w.shape)} ({r.dtype}, {k.dtype}, {v.dtype}) "
                         "do not pair")
    if chunk <= 0 or t % chunk:
        raise ValueError(f"wkv: chunk {chunk} does not divide T = {t}")
    if u is not None:
        if tuple(u.shape) != (h, dk):
            raise ValueError(f"wkv: u must be [{h}, {dk}], got {tuple(u.shape)}")
    if state0 is not None:
        _build.check_input("wkv", "state0", state0, 4)
        if tuple(state0.shape) != (n, h, dk, dv):
            raise ValueError(f"wkv: state0 must be [{n}, {h}, {dk}, {dv}], "
                             f"got {tuple(state0.shape)}")
    _build.check_devices("wkv", r=r, k=k, v=v, log_w=log_w, u=u, state0=state0)
    if u is not None:
        u = u.float().contiguous()
    lib = _lib()
    if lib.wkv_smem_bytes(chunk, dk, dv, dw) > MAX_SMEM:
        raise ValueError(f"wkv: chunk {chunk} at dk {dk}, dv {dv} needs more shared memory "
                         f"than a block has")
    with torch.cuda.device(r.device):
        y = torch.empty((n, t, h, dv), device=r.device, dtype=r.dtype)
        state = torch.empty((n, h, dk, dv), device=r.device, dtype=torch.float32)
        code = lib.wkv_launch(
            r.data_ptr(), k.data_ptr(), v.data_ptr(), log_w.data_ptr(),
            None if u is None else u.data_ptr(), None if state0 is None else state0.data_ptr(),
            y.data_ptr(), state.data_ptr(), n, t, h, dk, dv, dw, chunk,
            int(r.dtype == torch.bfloat16), int(log_w.dtype == torch.bfloat16),
            torch.cuda.current_stream(r.device).cuda_stream)
    _build.check_status("wkv", code)
    return y, state
