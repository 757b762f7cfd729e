"""Kernel dispatch: the one entry point of every reduction kernel.

The counterpart of the JAX registry's ``dispatch`` and ``_interpret``
(``src/repro/kernels/ops.py:102-200``).  The device of the inputs decides:

* a CPU tensor takes the plain version in :mod:`repro_torch.kernels.ref`;
* a CUDA tensor launches the Hopper kernel (built from ``csrc/`` at first
  use), or raises — there is no fallback;
* any other device raises.

Each kernel has a launch counter, a plain integer that the wrapper raises by
one where it launches the kernel and nowhere else; :func:`launch_counts`
reads them and :func:`reset_launch_counts` sets them to 0, so a run can show
that it went through the kernels.

The TPU registry's padding policy (``_pad_to``, ``_auto_block``,
``_auto_class_chunk``, ``_pad_factor_pair``) served the (8, 128) tiling and
VMEM; the CUDA kernels mask their ragged edges themselves.  Its jit cache has
no counterpart either: PyTorch runs eagerly.
"""
from __future__ import annotations

from typing import Dict

import torch

from repro_torch.kernels import ref
from repro_torch.kernels.fused_first_order import fused_first_order_cuda
from repro_torch.kernels.fused_second_order import fused_second_order_cuda
from repro_torch.kernels.sq_matmul import sq_matmul_cuda

KERNELS = ("fused_first_order", "fused_second_order", "sq_matmul")
_LAUNCHES: Dict[str, int] = {k: 0 for k in KERNELS}


def launch_counts() -> Dict[str, int]:
    """Kernel launches per kernel since the last :func:`reset_launch_counts`."""
    return dict(_LAUNCHES)


def reset_launch_counts() -> None:
    for k in _LAUNCHES:
        _LAUNCHES[k] = 0


def _on_card(kernel: str, *xs: torch.Tensor) -> bool:
    """True for CUDA inputs, False for CPU inputs; raise otherwise."""
    devices = {x.device for x in xs}
    if len(devices) != 1:
        raise ValueError(f"{kernel}: inputs lie on several devices {devices}")
    (device,) = devices
    if device.type == "cuda":
        return True
    if device.type == "cpu":
        return False
    raise ValueError(f"{kernel}: no kernel for device {device}")


def sq_matmul(A: torch.Tensor, B: torch.Tensor) -> torch.Tensor:
    """(A∘A)ᵀ(B∘B): A [N, a], B [N, b] → [a, b] float32."""
    if not _on_card("sq_matmul", A, B):
        return ref.sq_matmul(A, B)
    out = sq_matmul_cuda(A, B)
    _LAUNCHES["sq_matmul"] += 1
    return out


def fused_first_order(A, B, want_l2=True, want_moment=False, want_dot=False):
    """Fused first-order stats; A/B may be [N, R, a] (a leading group axis of
    1 is added and stripped) or [E, N, R, a].  Returns the requested keys of
    l2 [E, N] / moment [E, a, b] / dot [E, N, N].  The module sweeps pass
    [N, R, a]; E > 1 is the experts of a mixture-of-experts layer
    (``src/repro/nn/layers.py:125``), not ported yet."""
    squeeze = A.dim() == 3
    if squeeze:
        A, B = A[None], B[None]
    wants = dict(want_l2=want_l2, want_moment=want_moment, want_dot=want_dot)
    if _on_card("fused_first_order", A, B):
        out = fused_first_order_cuda(A, B, **wants)
        _LAUNCHES["fused_first_order"] += 1
    else:
        out = ref.fused_first_order(A, B, **wants)
    if squeeze:
        out = {k: v[0] for k, v in out.items()}
    return out


def fused_second_order(A, S, want_diag=True, want_kron=False,
                       want_trace=False):
    """Fused second-order stats: A [N, R, a], S [C, N, R, b] → the requested
    keys of diag [a, b] / kron [b, b] (unscaled SᵀS) / trace [N]."""
    wants = dict(want_diag=want_diag, want_kron=want_kron,
                 want_trace=want_trace)
    if not _on_card("fused_second_order", A, S):
        return ref.fused_second_order(A, S, **wants)
    out = fused_second_order_cuda(A, S, **wants)
    _LAUNCHES["fused_second_order"] += 1
    return out
