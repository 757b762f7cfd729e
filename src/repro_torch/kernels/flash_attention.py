"""Causal, sliding-window GQA attention on Hopper: wrapper of
``csrc/flash_attention.cu``.

Replaces the Pallas kernel ``flash_attention_pallas``
(``src/repro/kernels/flash_attention.py:78``) and computes
``nn/functional.sdpa``: q [N, T, H, dh] against k/v [N, S, KV, dh] with
H % KV == 0, causal or not, an optional window, and optional int32 positions
``q_positions`` [T] / ``k_positions`` [S] (the decode path's ring cache;
slots at −1 are empty).  q and k/v are each float32 or bfloat16; the output
is in q's dtype.  The head widths dh (q, k) and dv (v) are multiples of 4,
at most ``SIMT_MAX_HEAD_DIM`` = 256, and may differ.  The source holds three
designs and :func:`design` picks one: ``"split"`` (fewer than 64 query rows
a KV head: decode and short prompts, the keys split over blocks whose
partials the last block to arrive merges, float32 on CUDA cores), ``"wgmma"`` (bf16
prefill with dh = dv ∈ {64, 128}, on the tensor cores, TMA-fed) or
``"simt"`` (everything else, float32 on CUDA cores); the CUDA-core designs
have instances for widths up to 64, 128 and 256.  The source note in the
``.cu`` file says what bounds each on the H100; the plain version is
:func:`repro_torch.kernels.ref.flash_attention`.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Dict, Optional, Tuple

import torch

from repro_torch.kernels import _build

SOURCE = "src/repro_torch/kernels/csrc/flash_attention.cu"
REPLACES = "src/repro/kernels/flash_attention.py:78"
DTYPES = (torch.float32, torch.bfloat16)
TC_HEAD_DIMS = (64, 128)  # head widths of the "wgmma" design
SIMT_MAX_HEAD_DIM = 256   # the widest CUDA-core instance (q and acc split over lanes above 64)
SPLIT_BELOW_ROWS = 64     # T·g below this takes the "split" design
# "split": each block takes a split of the keys; the splits are sized so that
# the grid holds SPLIT_BLOCKS_PER_SM blocks an SM, in multiples of
# SPLIT_KEY_STEP keys (a stage of 16 keys for each of the four warps at dh 64).
SPLIT_BLOCKS_PER_SM = 4
SPLIT_KEY_STEP = 64
SPLIT_ROWS = 8            # query rows a block
# The "split" design's arrival counters, one buffer a (device, stream): zeros
# when made, and zeros again after every launch (the last block of each
# group wraps its counter back to 0).
_TICKETS: Dict[Tuple[int, int], torch.Tensor] = {}


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = _build.load("flash_attention")
    P, I, L, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_float
    lib.flash_attention_launch.argtypes = [P] * 6 + [I] * 9 + [L, F] + [I] * 2 + [P]
    lib.flash_attention_launch.restype = I
    lib.flash_attention_split_launch.argtypes = [P] * 8 + [I] * 9 + [L, F] + [I] * 3 + [P]
    lib.flash_attention_split_launch.restype = I
    lib.flash_attention_tc_launch.argtypes = [P] * 4 + [I] * 8 + [L, F, P]
    lib.flash_attention_tc_launch.restype = I
    return lib


def split_keys(s: int, blocks_per_split: int, sms: int) -> int:
    """Keys a split of the "split" design takes, for S = ``s`` keys and
    ``blocks_per_split`` blocks a split (N·KV times the row groups of 8):
    enough splits that the grid holds ``SPLIT_BLOCKS_PER_SM`` blocks on each
    of ``sms`` SMs, rounded up to ``SPLIT_KEY_STEP`` keys.  ⌈s / keys⌉
    splits, none empty."""
    want = max(1, -(-SPLIT_BLOCKS_PER_SM * sms // blocks_per_split))
    return -(-max(1, -(-s // want)) // SPLIT_KEY_STEP) * SPLIT_KEY_STEP


def split_scratch_floats(n: int, t: int, h: int, dv: int, splits: int) -> int:
    """Floats of the "split" design's partials: (m, l, acc[dv]) for each
    query row of each split."""
    return n * t * h * splits * (dv + 2)


def design(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, window: Optional[int] = None,
           q_positions: Optional[torch.Tensor] = None,
           k_positions: Optional[torch.Tensor] = None) -> str:
    """Which kernel design a call takes: ``"split"`` when the T·g rows of a
    KV head are fewer than 64 (decode, short prompts; any dtypes, positions
    and window); ``"wgmma"`` when q, k and v are all bfloat16, no positions
    are given, dh = dv ∈ {64, 128}, T ≤ S (every row then sees its own key),
    ``window`` is None or ≥ 1 and the tensors are 16-byte aligned (bf16
    prefill); else ``"simt"``."""
    n, t, h, dh = q.shape
    s, kv, dv = k.shape[1], k.shape[2], v.shape[-1]
    if t * (h // kv) < SPLIT_BELOW_ROWS:
        return "split"
    tc = (q.dtype == k.dtype == v.dtype == torch.bfloat16
          and q_positions is None and k_positions is None
          and dh == dv and dh in TC_HEAD_DIMS and t <= s
          and (window is None or window >= 1)
          and all(x.data_ptr() % 16 == 0 for x in (q, k, v)))
    return "wgmma" if tc else "simt"


def _tickets(device: torch.device, stream: int, count: int) -> torch.Tensor:
    """At least ``count`` zeroed int32 counters for the "split" design on
    ``device`` and ``stream``."""
    buf = _TICKETS.get((device.index, stream))
    if buf is None or buf.numel() < count:
        buf = _TICKETS[(device.index, stream)] = torch.zeros(
            max(count, 1024), device=device, dtype=torch.int32)
    return buf


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
    CUDA; q and k/v each float32 or bfloat16, k and v alike; dh and dv
    multiples of 4 up to 256) → [N, T, H, dv] in q's dtype."""
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
    if max(dh, dv) > SIMT_MAX_HEAD_DIM:
        raise ValueError(f"flash_attention: head widths {dh}, {dv} above the kernel's limit "
                         f"of {SIMT_MAX_HEAD_DIM}")
    which = design(q, k, v, window, q_positions, k_positions)
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
        pos = (None if qp is None else qp.data_ptr(), None if kp is None else kp.data_ptr())
        dtypes = (int(q.dtype == torch.bfloat16), int(k.dtype == torch.bfloat16))
        if which == "wgmma":
            code = lib.flash_attention_tc_launch(
                q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                n, t, s, h, kv, dh, *common, stream)
        elif which == "split":
            groups = -(-t * (h // kv) // SPLIT_ROWS)
            chunk = split_keys(s, n * kv * groups,
                               torch.cuda.get_device_properties(q.device).multi_processor_count)
            part = torch.empty(split_scratch_floats(n, t, h, dv, -(-s // chunk)),
                               device=q.device, dtype=torch.float32)
            tickets = _tickets(q.device, stream, n * kv * groups)
            code = lib.flash_attention_split_launch(
                q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), *pos, part.data_ptr(),
                tickets.data_ptr(), n, t, s, h, kv, dh, dv, *common, *dtypes, chunk, stream)
        else:
            code = lib.flash_attention_launch(
                q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), *pos,
                n, t, s, h, kv, dh, dv, *common, *dtypes, stream)
    _build.check_status("flash_attention", code)
    return out
