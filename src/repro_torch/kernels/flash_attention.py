"""Causal, sliding-window GQA attention on Hopper: wrapper of
``csrc/flash_attention.cu``.

Replaces the Pallas kernel ``flash_attention_pallas``
(``src/repro/kernels/flash_attention.py:78``) and computes
``nn/functional.sdpa``: q [N, T, H, dh] against k/v [N, S, KV, dh] with
H % KV == 0, causal or not, an optional window, and optional int32 positions
``q_positions`` [T] / ``k_positions`` [S] (the decode path's ring cache;
slots at −1 are empty).  q and k/v are each float32 or bfloat16; the output
is in q's dtype.  The source holds two designs and :func:`design` picks one:
``"wgmma"`` (bf16 prefill on the tensor cores, TMA-fed) or ``"simt"``
(everything else, float32 on CUDA cores).  The source note in the ``.cu``
file says what bounds each on the H100; the plain version is
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
TC_HEAD_DIMS = (64, 128)  # head widths of the "wgmma" design
SIMT_MAX_HEAD_DIM = 64    # the "simt" design keeps q and acc[dv] in registers


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = _build.load("flash_attention")
    P, I, L, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_float
    lib.flash_attention_launch.argtypes = [P] * 6 + [I] * 9 + [L, F] + [I] * 3 + [P]
    lib.flash_attention_launch.restype = I
    lib.flash_attention_tc_launch.argtypes = [P] * 4 + [I] * 8 + [L, F, P]
    lib.flash_attention_tc_launch.restype = I
    return lib


def threads_per_row(t: int, g: int) -> int:
    """Threads the "simt" design gives one query row: 1 when the T·g rows of
    a KV head fill blocks of 128, else 32 (decode's g rows split their keys
    32 ways)."""
    return 1 if t * g >= 64 else 32


def design(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, window: Optional[int] = None,
           q_positions: Optional[torch.Tensor] = None,
           k_positions: Optional[torch.Tensor] = None) -> str:
    """Which kernel design a call takes: ``"wgmma"`` when q, k and v are all
    bfloat16, no positions are given, dh = dv ∈ {64, 128}, T ≤ S (every row
    then sees its own key), the T·g rows of a KV head are at least 64,
    ``window`` is None or ≥ 1 and the tensors are 16-byte aligned (bf16
    prefill); else ``"simt"``."""
    n, t, h, dh = q.shape
    s, kv, dv = k.shape[1], k.shape[2], v.shape[-1]
    tc = (q.dtype == k.dtype == v.dtype == torch.bfloat16
          and q_positions is None and k_positions is None
          and dh == dv and dh in TC_HEAD_DIMS and t <= s and t * (h // kv) >= 64
          and (window is None or window >= 1)
          and all(x.data_ptr() % 16 == 0 for x in (q, k, v)))
    return "wgmma" if tc else "simt"


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
    for name, x in (("q", q), ("k", k), ("v", v)):
        _build.check_input("flash_attention", name, x, 4, DTYPES)
    n, t, h, dh = q.shape
    s, kv, dv = k.shape[1], k.shape[2], v.shape[-1]
    if (k.shape[0] != n or k.shape[3] != dh or v.shape[:3] != k.shape[:3] or h % kv
            or v.dtype != k.dtype):
        raise ValueError(f"flash_attention: q {tuple(q.shape)}, k {tuple(k.shape)} and "
                         f"v {tuple(v.shape)} ({q.dtype}, {k.dtype}, {v.dtype}) do not pair")
    if dh % 4 or dv % 4:
        raise ValueError(f"flash_attention: head widths {dh}, {dv} must be multiples of 4")
    which = design(q, k, v, window, q_positions, k_positions)
    if which == "simt" and max(dh, dv) > SIMT_MAX_HEAD_DIM:
        raise ValueError(f"flash_attention: head widths {dh}, {dv} above "
                         f"{SIMT_MAX_HEAD_DIM} need the wgmma design (bf16 q, k, v, no "
                         f"positions, dh = dv in {TC_HEAD_DIMS}, T ≤ S, T·g ≥ 64)")
    _build.check_devices("flash_attention", q=q, k=k, v=v)
    qp = _positions("q_positions", q_positions, t, q.device)
    kp = _positions("k_positions", k_positions, s, q.device)
    scale = dh ** -0.5 if scale is None else scale
    lib = _lib()
    with torch.cuda.device(q.device):
        out = torch.empty((n, t, h, dv), device=q.device, dtype=q.dtype)
        stream = torch.cuda.current_stream(q.device).cuda_stream
        common = (int(causal), int(window is not None), 0 if window is None else int(window),
                  float(scale))
        if which == "wgmma":
            code = lib.flash_attention_tc_launch(
                q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                n, t, s, h, kv, dh, *common, stream)
        else:
            code = lib.flash_attention_launch(
                q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                None if qp is None else qp.data_ptr(), None if kp is None else kp.data_ptr(),
                n, t, s, h, kv, dh, dv, *common,
                int(q.dtype == torch.bfloat16), int(k.dtype == torch.bfloat16),
                threads_per_row(t, h // kv), stream)
    _build.check_status("flash_attention", code)
    return out
