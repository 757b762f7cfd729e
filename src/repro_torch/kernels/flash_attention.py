"""Causal, sliding-window GQA attention on Hopper: wrapper of
``csrc/flash_attention.cu``.

Replaces the Pallas kernel ``flash_attention_pallas``
(``src/repro/kernels/flash_attention.py:78``) and computes
``nn/functional.sdpa``: q [N, T, H, dh] against k/v [N, S, KV, dh] with
H % KV == 0, causal or not, an optional window, and optional int32 positions
``q_positions`` [T] / ``k_positions`` [S] (the decode path's ring cache;
slots at −1 are empty).  q and k/v are each float32 or bfloat16; the kernel
computes in float32 and writes q's dtype.  The source note in the ``.cu``
file says what bounds it on the H100; the plain version is
:func:`repro_torch.kernels.ref.flash_attention`.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Optional

import torch

from repro_torch.kernels import _build

SOURCE = "src/repro_torch/kernels/csrc/flash_attention.cu"
REPLACES = "src/repro/kernels/flash_attention.py:78"
DTYPES = (torch.float32, torch.bfloat16)


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = _build.load("flash_attention")
    P, I = ctypes.c_void_p, ctypes.c_int
    lib.flash_attention_launch.argtypes = ([P] * 6 + [I] * 9 + [ctypes.c_longlong, ctypes.c_float]
                                           + [I] * 3 + [P])
    lib.flash_attention_launch.restype = I
    return lib


def threads_per_row(t: int, g: int) -> int:
    """Threads given to one query row: 1 when the T·g rows of a KV head fill
    blocks of 128, else 32 (decode's g rows split their keys 32 ways)."""
    return 1 if t * g >= 64 else 32


def _positions(name: str, p: Optional[torch.Tensor], length: int, device) -> Optional[torch.Tensor]:
    if p is None:
        return None
    if p.dim() != 1 or p.shape[0] != length or p.device != device:
        raise ValueError(f"flash_attention: {name} must be [{length}] on {device}, "
                         f"got {tuple(p.shape)} on {p.device}")
    return p.to(torch.int32).contiguous()


def flash_attention_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                         causal: bool = True, window: Optional[int] = None,
                         q_positions: Optional[torch.Tensor] = None,
                         k_positions: Optional[torch.Tensor] = None,
                         scale: Optional[float] = None) -> torch.Tensor:
    """q [N, T, H, dh], k [N, S, KV, dh], v [N, S, KV, dv] (contiguous,
    CUDA; q and k/v each float32 or bfloat16, k and v alike) → [N, T, H, dv]
    in q's dtype."""
    _build.check_input("flash_attention", "q", q, 4, DTYPES)
    _build.check_input("flash_attention", "k", k, 4, DTYPES)
    _build.check_input("flash_attention", "v", v, 4, DTYPES)
    n, t, h, dh = q.shape
    s, kv = k.shape[1], k.shape[2]
    dv = v.shape[-1]
    if (k.shape[0] != n or k.shape[3] != dh or v.shape[:3] != k.shape[:3] or h % kv
            or v.dtype != k.dtype or len({q.device, k.device, v.device}) != 1):
        raise ValueError(f"flash_attention: q {tuple(q.shape)}, k {tuple(k.shape)} and "
                         f"v {tuple(v.shape)} ({q.dtype}, {k.dtype}, {v.dtype}) do not pair")
    if max(dh, dv) > 64 or dh % 4 or dv % 4:
        raise ValueError(f"flash_attention: head widths {dh}, {dv} must be multiples of 4, "
                         "at most 64")
    qp = _positions("q_positions", q_positions, t, q.device)
    kp = _positions("k_positions", k_positions, s, q.device)
    tpr = threads_per_row(t, h // kv)
    scale = dh ** -0.5 if scale is None else scale
    lib = _lib()
    with torch.cuda.device(q.device):
        out = torch.empty((n, t, h, dv), device=q.device, dtype=q.dtype)
        code = lib.flash_attention_launch(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            None if qp is None else qp.data_ptr(), None if kp is None else kp.data_ptr(),
            n, t, s, h, kv, dh, dv, int(causal), int(window is not None),
            0 if window is None else int(window), float(scale),
            int(q.dtype == torch.bfloat16), int(k.dtype == torch.bfloat16), tpr,
            torch.cuda.current_stream(q.device).cuda_stream)
    _build.check_status("flash_attention", code)
    return out
