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


def per_sample_moment(A: torch.Tensor, B: torch.Tensor) -> torch.Tensor:
    """M[a,b] = Σ_n (Σ_r A[n,r,a] B[n,r,b])² — the sequence second moment.

    A: [N, R, a], B: [N, R, b] → [a, b] float32.
    """
    g = torch.einsum("nra,nrb->nab", A.float(), B.float())
    return (g * g).sum(dim=0)


def batch_l2(A: torch.Tensor, B: torch.Tensor) -> torch.Tensor:
    """l2[n] = Σ_rs (A_n A_nᵀ)[r,s] (B_n B_nᵀ)[r,s] — the Gram trick.

    A: [N, R, a], B: [N, R, b] → [N] float32.
    """
    Af, Bf = A.float(), B.float()
    ga = torch.einsum("nra,nsa->nrs", Af, Af)
    gb = torch.einsum("nrb,nsb->nrs", Bf, Bf)
    return (ga * gb).sum(dim=(1, 2))


def ggn_diag(A: torch.Tensor, S: torch.Tensor) -> torch.Tensor:
    """diag[a,b] = Σ_{c,n} (Σ_r A[n,r,a] S[c,n,r,b])² (Eq. 19/22).

    A: [N, R, a], S: [C, N, R, b] → [a, b] float32.
    """
    t = torch.einsum("nra,cnrb->cnab", A.float(), S.float())
    return (t * t).sum(dim=(0, 1))


def cross_dot(A1, B1, A2, B2) -> torch.Tensor:
    """out[e,n,m] = ⟨G1[e,n], G2[e,m]⟩ for G = A_nᵀB_n — cross-block Gram.

    A1/B1: [E, N1, R, a/b], A2/B2: [E, N2, R, a/b] → [E, N1, N2] float32.
    The row-block × row-block generalisation of the BatchDot Gram: two row
    sets, a leading group axis E (classes for the class-wise NTK).
    """
    g1 = torch.einsum("enra,enrb->enab", A1.float(), B1.float())
    g2 = torch.einsum("emra,emrb->emab", A2.float(), B2.float())
    return torch.einsum("enab,emab->enm", g1, g2)


def predictive_var(A, S, Sigma=None) -> torch.Tensor:
    """var[c,n] = Σ_ab (Σ_r A[n,r,a] S[c,n,r,b])² [· Sigma[a,b]].

    A: [N, R, a], S: [C, N, R, b], Sigma: [a, b] → [C, N] float32: the GLM
    predictive variance of one layer, with the per-sample Jacobian
    J[c,n] = A_nᵀS_cn formed, squared, weighted and reduced.
    """
    t = torch.einsum("nra,cnrb->cnab", A.float(), S.float())
    t2 = t * t
    if Sigma is not None:
        t2 = t2 * Sigma.float()
    return t2.sum(dim=(2, 3))


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
