"""Plain PyTorch versions of the kernels: what each kernel computes.

The CPU path of :mod:`repro_torch.kernels.ops` runs these, and the card's
kernels are held against them.  Ports of ``src/repro/kernels/ref.py``.
"""
from __future__ import annotations

from typing import Dict

import torch


def sq_matmul(A: torch.Tensor, B: torch.Tensor) -> torch.Tensor:
    """C[a,b] = Σ_n A²[n,a] B²[n,b] — the paper's (A∘A)ᵀ(B∘B) (App. A.1)."""
    Af, Bf = A.float(), B.float()
    return (Af * Af).T @ (Bf * Bf)


def fused_second_order(A, S, want_diag=True, want_kron=False,
                       want_trace=False) -> Dict[str, torch.Tensor]:
    """t[c,n] = A_nᵀ S_cn, reduced.

    A: [N, R, a], S: [C, N, R, b] → dict of requested float32 stats
    (diag [a, b] · kron [b, b] (unscaled SᵀS) · trace [N]).
    """
    Af, Sf = A.float(), S.float()
    out = {}
    if want_diag or want_trace:
        t = torch.einsum("nra,cnrb->cnab", Af, Sf)
        t2 = t * t
        if want_diag:
            out["diag"] = t2.sum(dim=(0, 1))
        if want_trace:
            out["trace"] = t2.sum(dim=(0, 2, 3))
    if want_kron:
        Sflat = Sf.reshape(-1, Sf.shape[-1])
        out["kron"] = Sflat.T @ Sflat
    return out


def fused_first_order(A, B, want_l2=True, want_moment=False,
                      want_dot=False) -> Dict[str, torch.Tensor]:
    """Materialize G[e,n] = A_nᵀB_n, reduce.

    A: [E, N, R, a], B: [E, N, R, b] → dict of requested stats
    (l2 [E, N] · moment [E, a, b] · dot [E, N, N]), all float32.
    """
    Af, Bf = A.float(), B.float()
    g = torch.einsum("enra,enrb->enab", Af, Bf)
    out = {}
    if want_l2:
        out["l2"] = (g * g).sum(dim=(2, 3))
    if want_moment:
        out["moment"] = (g * g).sum(dim=1)
    if want_dot:
        gf = g.reshape(g.shape[0], g.shape[1], -1)
        out["dot"] = gf @ gf.transpose(1, 2)
    return out
