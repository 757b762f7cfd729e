"""Plain PyTorch versions of the kernels: what each kernel computes.

The CPU path of :mod:`repro_torch.kernels.ops` runs these, and the card's
kernels are held against them.  Ports of ``src/repro/kernels/ref.py``.  The
reductions compute in ``dtype``: by default float32, or float64 where every
input is float64 (a reference computed in float64 on the CPU); float64 is
also the exact formula the card checks hold the kernels to.
"""
from __future__ import annotations

from typing import Dict, Optional

import torch


def _dtype(dtype: Optional[torch.dtype], *xs) -> torch.dtype:
    if dtype is not None:
        return dtype
    wide = all(x.dtype == torch.float64 for x in xs if x is not None)
    return torch.float64 if wide else torch.float32


def sq_matmul(A: torch.Tensor, B: torch.Tensor, dtype=None) -> torch.Tensor:
    """C[a,b] = Σ_n A²[n,a] B²[n,b] — the paper's (A∘A)ᵀ(B∘B) (App. A.1),
    in ``dtype`` (float64: the exact formula of the card checks)."""
    dtype = _dtype(dtype, A, B)
    Af, Bf = A.to(dtype), B.to(dtype)
    return (Af * Af).T @ (Bf * Bf)


def per_sample_moment(A: torch.Tensor, B: torch.Tensor, dtype=None) -> torch.Tensor:
    """M[a,b] = Σ_n (Σ_r A[n,r,a] B[n,r,b])² — the sequence second moment.

    A: [N, R, a], B: [N, R, b] → [a, b] in ``dtype`` (float64: the exact
    formula of the card checks).
    """
    dtype = _dtype(dtype, A, B)
    g = torch.einsum("nra,nrb->nab", A.to(dtype), B.to(dtype))
    return (g * g).sum(dim=0)


def batch_l2(A: torch.Tensor, B: torch.Tensor, dtype=None) -> torch.Tensor:
    """l2[n] = Σ_rs (A_n A_nᵀ)[r,s] (B_n B_nᵀ)[r,s] — the Gram trick.

    A: [N, R, a], B: [N, R, b] → [N] in ``dtype`` (float64: the exact
    formula of the card checks).
    """
    dtype = _dtype(dtype, A, B)
    Af, Bf = A.to(dtype), B.to(dtype)
    ga = torch.einsum("nra,nsa->nrs", Af, Af)
    gb = torch.einsum("nrb,nsb->nrs", Bf, Bf)
    return (ga * gb).sum(dim=(1, 2))


def ggn_diag(A: torch.Tensor, S: torch.Tensor, dtype=None) -> torch.Tensor:
    """diag[a,b] = Σ_{c,n} (Σ_r A[n,r,a] S[c,n,r,b])² (Eq. 19/22).

    A: [N, R, a], S: [C, N, R, b] → [a, b] in ``dtype`` (float64: the exact
    formula of the card checks).
    """
    dtype = _dtype(dtype, A, S)
    t = torch.einsum("nra,cnrb->cnab", A.to(dtype), S.to(dtype))
    return (t * t).sum(dim=(0, 1))


def cross_dot(A1, B1, A2, B2, dtype=None) -> torch.Tensor:
    """out[e,n,m] = ⟨G1[e,n], G2[e,m]⟩ for G = A_nᵀB_n — cross-block Gram.

    A1/B1: [E, N1, R, a/b], A2/B2: [E, N2, R, a/b] → [E, N1, N2] in
    ``dtype`` (float32; float64 is the exact formula the card checks hold
    the 3xTF32 kernel to).  The row-block × row-block generalisation of the
    BatchDot Gram: two row sets, a leading group axis E (classes for the
    class-wise NTK).
    """
    dtype = _dtype(dtype, A1, B1, A2, B2)
    g1 = torch.einsum("enra,enrb->enab", A1.to(dtype), B1.to(dtype))
    g2 = torch.einsum("emra,emrb->emab", A2.to(dtype), B2.to(dtype))
    return torch.einsum("enab,emab->enm", g1, g2)


def predictive_var(A, S, Sigma=None, dtype=None) -> torch.Tensor:
    """var[c,n] = Σ_ab (Σ_r A[n,r,a] S[c,n,r,b])² [· Sigma[a,b]].

    A: [N, R, a], S: [C, N, R, b], Sigma: [a, b] → [C, N] in ``dtype``
    (float64: the exact formula of the card checks): the GLM predictive
    variance of one layer, with the per-sample Jacobian J[c,n] = A_nᵀS_cn
    formed, squared, weighted and reduced.
    """
    dtype = _dtype(dtype, A, S, Sigma)
    t = torch.einsum("nra,cnrb->cnab", A.to(dtype), S.to(dtype))
    t2 = t * t
    if Sigma is not None:
        t2 = t2 * Sigma.to(dtype)
    return t2.sum(dim=(2, 3))


def fused_second_order(A, S, want_diag=True, want_kron=False,
                       want_trace=False, dtype=None) -> Dict[str, torch.Tensor]:
    """t[c,n] = A_nᵀ S_cn, reduced.

    A: [N, R, a], S: [C, N, R, b] → dict of requested stats in ``dtype``
    (float32; float64 for the card checks of the 3xTF32 kernel): diag
    [a, b] · kron [b, b] (unscaled SᵀS) · trace [N].
    """
    dtype = _dtype(dtype, A, S)
    Af, Sf = A.to(dtype), S.to(dtype)
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
                      want_dot=False, dtype=None) -> Dict[str, torch.Tensor]:
    """Materialize G[e,n] = A_nᵀB_n, reduce.

    A: [E, N, R, a], B: [E, N, R, b] → dict of requested stats
    (l2 [E, N] · moment [E, a, b] · dot [E, N, N]), all in ``dtype``
    (float32; float64 is the exact formula the card checks hold to).
    At R = 1 G is rank one and every stat has a closed form that never
    forms it: moment (A∘A)ᵀ(B∘B), l2 ‖A_n‖²‖B_n‖², dot (AAᵀ)∘(BBᵀ), each per
    group.  G would take 42.9 GB in float32 at a mixture of experts' 32
    experts × 640 slots × 1024 × 512.
    """
    dtype = _dtype(dtype, A, B)
    Af, Bf = A.to(dtype), B.to(dtype)
    out = {}
    if A.shape[2] == 1:
        a1, b1 = Af[:, :, 0], Bf[:, :, 0]
        if want_l2:
            out["l2"] = (a1 * a1).sum(-1) * (b1 * b1).sum(-1)
        if want_moment:
            out["moment"] = (a1 * a1).transpose(1, 2) @ (b1 * b1)
        if want_dot:
            out["dot"] = (a1 @ a1.transpose(1, 2)) * (b1 @ b1.transpose(1, 2))
        return out
    g = torch.einsum("enra,enrb->enab", Af, Bf)
    if want_l2:
        out["l2"] = (g * g).sum(dim=(2, 3))
    if want_moment:
        out["moment"] = (g * g).sum(dim=1)
    if want_dot:
        gf = g.reshape(g.shape[0], g.shape[1], -1)
        out["dot"] = gf @ gf.transpose(1, 2)
    return out


NEG_INF = -1e30  # the masked logit of src/repro/nn/functional.py


def flash_attention(q, k, v, *, causal=True, window=None, q_positions=None,
                    k_positions=None, scale=None) -> torch.Tensor:
    """Causal, optionally sliding-window GQA attention: what ``sdpa`` computes.

    q: [N, T, H, dh], k/v: [N, S, KV, dh(v)] with H % KV == 0 → [N, T, H, dhv]
    in q's dtype.  The key s is seen by the query t when qp[t] ≥ kp[s]
    (``causal``), qp[t] − kp[s] < ``window`` and kp[s] ≥ 0 (ring slots not
    yet written); positions default to ``arange``.  Masked logits are
    −1e30, so a query with no key seen takes the uniform average of all S
    values, as ``jax.nn.softmax`` gives it.  Float32 throughout.
    """
    n, t, h, dh = q.shape
    s, kv = k.shape[1], k.shape[2]
    g = h // kv
    scale = scale if scale is not None else dh ** -0.5
    qp = q_positions if q_positions is not None else torch.arange(t, device=q.device)
    kp = k_positions if k_positions is not None else torch.arange(s, device=q.device)
    qg = q.reshape(n, t, kv, g, dh)
    logits = torch.einsum("ntkgd,nskd->nkgts", qg.float(), k.float()) * scale
    qp, kp = qp.long(), kp.long()
    mask = torch.ones((t, s), dtype=torch.bool, device=q.device)
    if causal:
        mask &= qp[:, None] >= kp[None, :]
    if window is not None:
        mask &= (qp[:, None] - kp[None, :]) < window
    mask &= kp[None, :] >= 0
    logits = torch.where(mask, logits, torch.full_like(logits, NEG_INF))
    p = torch.softmax(logits, dim=-1)
    out = torch.einsum("nkgts,nskd->ntkgd", p, v.float())
    return out.reshape(n, t, h, v.shape[-1]).to(q.dtype)


def wkv(r, k, v, log_w, u=None, state0=None, chunk=16):
    """The chunked RWKV6 / SSD recurrence, chunk by chunk:

        S_t = diag(w_t) S_{t-1} + k_t v_tᵀ ;   y_t = r_tᵀ S_{t-1} + (r·u·k)_t v_t

    r, k: [N, T, H, dk]; v: [N, T, H, dv]; log_w: [N, T, H, dk] or
    [N, T, H, 1] (a scalar decay per head), clipped to [−60, −1e−6]; u:
    [H, dk] or None; state0: [N, H, dk, dv] float32 or None; ``chunk``
    divides T.  Returns (y [N, T, H, dv] in r's dtype, state [N, H, dk, dv]
    float32), with ``wkv_chunked``'s algebra (``src/repro/nn/functional.py``):
    within a chunk the decays are cumulative sums P, r̃ = r·exp(P − log_w),
    k̃ = k·exp(−P).
    """
    n, t, h, dk = r.shape
    dv = v.shape[-1]
    if t % chunk:
        raise ValueError(f"wkv: chunk {chunk} does not divide T = {t}")
    nc = t // chunk
    rs = r.reshape(n, nc, chunk, h, dk).float()
    ks = k.reshape(n, nc, chunk, h, dk).float()
    vs = v.reshape(n, nc, chunk, h, dv).float()
    lw = log_w.reshape(n, nc, chunk, h, -1).float().clamp(-60.0, -1e-6)
    lw = lw.expand(n, nc, chunk, h, dk)
    S = (torch.zeros((n, h, dk, dv), dtype=torch.float32, device=r.device)
         if state0 is None else state0.float())
    strict = torch.tril(torch.ones((chunk, chunk), dtype=torch.float32, device=r.device),
                        diagonal=-1)
    ys = []
    for c in range(nc):
        rc, kc, vc, lwc = rs[:, c], ks[:, c], vs[:, c], lw[:, c]
        P = torch.cumsum(lwc, dim=1)
        E = P - lwc
        r_t = rc * torch.exp(E)
        k_t = kc * torch.exp(-P)
        A = torch.einsum("nthd,nshd->nhts", r_t, k_t) * strict
        y = torch.einsum("nhts,nshd->nthd", A, vc)
        if u is not None:
            diag = torch.einsum("nthd,hd,nthd->nth", rc, u.float(), kc)
            y = y + diag[..., None] * vc
        y = y + torch.einsum("nthd,nhde->nthe", r_t, S)
        decay_end = torch.exp(P[:, -1])
        k_end = kc * torch.exp(P[:, -1][:, None] - P)
        S = decay_end[..., None] * S + torch.einsum("nthd,nthe->nhde", k_end, vc)
        ys.append(y)
    y = torch.stack(ys, dim=1).reshape(n, t, h, dv)
    return y.to(r.dtype), S
