"""Module protocol + generalized-backprop combinators (paper §2.1, Fig. 2).

BackPACK's central abstraction: *a module only needs to know how to multiply
by its Jacobians*.  Every module exposes

  ``call(params, x)``                        forward with explicit parameters
  ``forward_tape(params, x)``                forward + what the sweeps need
  ``backward(params, tape, g, exts, cfg)``   one cotangent sweep step:
      returns ``(g_in, param_grads, stats)`` where ``stats[ext]`` mirrors the
      params (first-order extensions, Eq. 5/9–11 + KFAC A-factors)
  ``jac_t_mat(params, tape, M)``             transposed Jacobian applied to a
      stack of cotangents ``M``: ``[C̃, *out] → [C̃, *in]``
  ``curv_backward(params, tape, S, exts, cfg, ext_prefix)``  GGN-factor sweep
      step (Eq. 18): returns ``(S_in, curv_stats)``
  ``kfra_backward`` / ``hess_backward``      the chain-only sweeps (Eq. 24-26)

Port of ``src/repro/core/module.py`` (single-device branches).  Modules are
``torch.nn.Module``s that hold their parameters in the JAX package's layout
(Dense ``w`` is ``[d_in, d_out]``); :meth:`Module.params` returns them as the
pytree the JAX ``Sequential.init`` returns, and the sweeps take that pytree
explicitly, so the same module can run with other parameters (the weight
bridge, the parity tests).  The backward passes are written by hand, as in
JAX; parameter-free modules without formulas fall back to ``torch.func.vjp``.

Axis convention: activations are ``[N, *reduce_axes, feature]``; axis 0 is
the sample axis.
"""
from __future__ import annotations

from typing import Callable, Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.kernels import ops as kops

from .extensions import (
    ExtensionConfig,
    FusedMask,
    FusedSecondMask,
    first_order_mask,
    second_order_mask,
)
from .loss_hessian import _f32
from .tree import tree_leaves, tree_map, tree_map_with_path


def _nra(x):
    """Reshape [N, *R, d] -> [N, R, d] (R = prod of middle axes)."""
    return x.reshape(x.shape[0], -1, x.shape[-1])


def resolve_device(device) -> torch.device:
    """``torch.device(device)``, raising when CUDA is asked for and absent."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("a CUDA device was requested but torch.cuda.is_available() "
                           "is False; pass device='cpu' to run on the CPU")
    return device


def normal_param(shape, scale, device, generator=None,
                 dtype=torch.float32) -> nn.Parameter:
    """A frozen parameter of N(0, scale²) entries drawn from ``generator``
    (a CPU generator; the draws do not depend on ``device``), drawn in
    float32 and cast to ``dtype`` as JAX's ``init`` does.  On the ``meta``
    device nothing is drawn (shapes only: ``ModelConfig.param_count``)."""
    device = resolve_device(device)
    if device.type == "meta":
        return nn.Parameter(torch.empty(shape, dtype=dtype, device=device), requires_grad=False)
    w = torch.randn(shape, generator=generator) * scale
    return nn.Parameter(w.to(dtype).to(device), requires_grad=False)


def zeros_param(shape, device, dtype=torch.float32) -> nn.Parameter:
    return nn.Parameter(torch.zeros(shape, dtype=dtype, device=resolve_device(device)),
                        requires_grad=False)


def full_param(shape, value, device, dtype=torch.float32) -> nn.Parameter:
    return nn.Parameter(torch.full(shape, value, dtype=dtype, device=resolve_device(device)),
                        requires_grad=False)


class UnsupportedSweep(Exception):
    """Raised when a sweep (KFRA / DiagHessian) hits a non-chain module."""


# ---------------------------------------------------------------------------
# shared moment helpers (the paper's App. A.1 formulas, sequence-generalized)
# ---------------------------------------------------------------------------


def per_sample_sq_sum(A, B, chunk=8, use_kernels=False):
    """Σ_n (A_nᵀ B_n)∘² without keeping all N [a×b] matrices.

    A: [N, R, a], B: [N, R, b]  →  [a, b] float32.
    R == 1 reduces to the paper's ``(A∘A)ᵀ(B∘B)`` (App. A.1).
    """
    A, B = _f32(A), _f32(B)
    n, r, a = A.shape
    b = B.shape[-1]
    if r == 1:
        if use_kernels:
            return kops.sq_matmul(A[:, 0, :].contiguous(), B[:, 0, :].contiguous())
        return torch.einsum("na,nb->ab", A[:, 0, :] ** 2, B[:, 0, :] ** 2)
    if use_kernels:
        return kops.per_sample_moment(A.contiguous(), B.contiguous())
    out = torch.zeros((a, b), dtype=torch.float32, device=A.device)
    for i in range(0, n, max(1, chunk)):
        g = torch.einsum("nra,nrb->nab", A[i:i + chunk], B[i:i + chunk])
        out += (g * g).sum(0)
    return out


def _pairwise_rows(ps):
    """Gram rows G Gᵀ for per-sample rows ``ps`` [N, ...] → [N, N] f32."""
    f = _f32(ps).reshape(ps.shape[0], -1)
    return f @ f.T


def per_sample_dots(A, B):
    """D[n,m] = ⟨g_n, g_m⟩ for g = A_nᵀB_n.

    A: [N, R, a], B: [N, R, b] → [N, N] float32.  Takes the pairwise Gram
    trick where its [N, N, R, R] products are fewer than the per-sample
    gradients' N·a·b entries (dense layers), else forms g and its Gram: the
    trick would need 137 GB at 3C3D's first convolution at N = 128.
    """
    A, B = _f32(A), _f32(B)
    n, r, a = A.shape
    if n * r * r > a * B.shape[-1]:
        return _pairwise_rows(torch.einsum("nra,nrb->nab", A, B))
    ga = torch.einsum("nra,msa->nmrs", A, A)
    gb = torch.einsum("nrb,msb->nmrs", B, B)
    return (ga * gb).sum(dim=(2, 3))


def per_sample_l2(A, B, use_kernels=False):
    """‖g_n‖² for g_n = A_nᵀ B_n — Gram trick (App. A.1).

    A: [N, R, a], B: [N, R, b]  →  [N] float32.
    """
    A, B = _f32(A), _f32(B)
    if A.shape[1] == 1:
        return (A[:, 0, :] ** 2).sum(-1) * (B[:, 0, :] ** 2).sum(-1)
    if use_kernels:
        return kops.batch_l2(A.contiguous(), B.contiguous())
    ga = torch.einsum("nra,nsa->nrs", A, A)
    gb = torch.einsum("nrb,nsb->nrs", B, B)
    return (ga * gb).sum(dim=(1, 2))


def dense_first_order_stats(A, B, exts, cfg: ExtensionConfig, bias: bool):
    """First-order extension stats for y = x @ W (+ b).

    A: [N, R, a] inputs, B: [N, R, b] output cotangents (already / m).
    Returns ``{ext_name: {'w': ..., 'b': ...}}``.  With ``cfg.use_kernels``
    every requested weight reduction comes out of ONE fused kernel launch
    over (A, B); rank-1 (R == 1) layers take the cheaper closed forms (the
    moment through the ``sq_matmul`` kernel).  Bias stats are row sums.
    """
    names = {e.name for e in exts}
    mask = first_order_mask(names)
    out = {}
    Af, Bf = _f32(A).contiguous(), _f32(B).contiguous()
    rank1 = A.shape[1] == 1
    kmask = FusedMask() if rank1 else mask
    fused = None
    if cfg.use_kernels and cfg.use_fused and kmask.any():
        fused = kops.fused_first_order(Af, Bf, **kmask.wants())
    if "batch_grad" in names:
        d = {"w": torch.einsum("nra,nrb->nab", Af, Bf)}
        if bias:
            d["b"] = Bf.sum(dim=1)
        out["batch_grad"] = d
    if mask.moment:
        w = (fused["moment"] if fused is not None and kmask.moment
             else per_sample_sq_sum(Af, Bf, use_kernels=cfg.use_kernels))
        d = {"w": w}
        if bias:
            bsum = Bf.sum(dim=1)
            d["b"] = (bsum * bsum).sum(dim=0)
        out["_sum_grad2"] = d
    if mask.l2:
        l2w = (fused["l2"] if fused is not None and kmask.l2
               else per_sample_l2(Af, Bf, use_kernels=cfg.use_kernels))
        d = {"w": l2w}
        if bias:
            bsum = Bf.sum(dim=1)
            d["b"] = (bsum * bsum).sum(-1)
        out["batch_l2"] = d
    if mask.dot:
        dw = (fused["dot"] if fused is not None and kmask.dot
              else per_sample_dots(Af, Bf))
        d = {"w": dw}
        if bias:
            d["b"] = _pairwise_rows(Bf.sum(dim=1))
        out["batch_dot"] = d
    if "kfac" in names or "kflr" in names:
        n, r, a = A.shape
        Aflat = Af.reshape(-1, a)
        out["_kron_a"] = {"w": Aflat.T @ Aflat / float(n * r)}
    return out


def _gram_of_g(G1, G2):
    """T[c, n, m] = ⟨G1[c, n], G2[c, m]⟩ for per-row matrices G [C, N, a, b]."""
    return torch.einsum("cnk,cmk->cnm", G1.flatten(2), G2.flatten(2))


def _dense_ntk_stats(A, S, names, cfg: ExtensionConfig, bias: bool):
    """Empirical-NTK blocks for y = x @ W (+ b) from raw-Jacobian factors.

    A: [N, R, a] inputs, S: [C, N, R, b] identity-cotangent factors (the raw
    output Jacobian backpropagated to this layer, no loss weighting).  The
    per-class per-sample weight Jacobian is G[c,n] = A_nᵀS[c,n]; the
    class-diagonal block T[c, n, m] = ⟨G[c,n], G[c,m]⟩ is emitted as
    [N, N, C] (``ntk_classwise``) or summed over classes, [N, N] (``ntk``).
    Rank-1 layers take the closed form (A Aᵀ) ∘ (S_c S_cᵀ); with
    ``use_kernels`` and ``use_fused`` the class axis goes through one
    ``cross_dot`` launch (E = C, the input read once for all classes).
    Without kernels T comes from whichever form has fewer elements: JAX's
    pairwise products [N, N, R, R] and [C, N, N, R, R], or G [C, N, a, b]
    and its Gram (the pairwise form needs more than 69 GB at 3C3D's
    first convolution at N = 128).
    """
    out = {}
    Af, Sf = _f32(A).contiguous(), _f32(S).contiguous()
    c, n, r, b = Sf.shape
    a = Af.shape[-1]
    if r == 1:
        KA = Af[:, 0] @ Af[:, 0].T                                # [N, N]
        KS = torch.einsum("cnb,cmb->cnm", Sf[:, :, 0], Sf[:, :, 0])
        T = KA[None] * KS                                         # [C, N, N]
    elif cfg.use_kernels and cfg.use_fused:
        T = kops.cross_dot(Af[None], Sf, Af[None], Sf)
    elif c * n * a * b < n * n * r * r * (1 + c):
        G = torch.einsum("nra,cnrb->cnab", Af, Sf)
        T = _gram_of_g(G, G)
    else:
        ga = torch.einsum("nra,msa->nmrs", Af, Af)
        gs = torch.einsum("cnrb,cmsb->cnmrs", Sf, Sf)
        T = torch.einsum("nmrs,cnmrs->cnm", ga, gs)
    if bias:
        Sb = Sf.sum(dim=2)                                        # [C, N, b]
    if "ntk" in names:
        d = {"w": T.sum(dim=0)}
        if bias:
            d["b"] = torch.einsum("cnb,cmb->nm", Sb, Sb)
        out["ntk"] = d
    if "ntk_classwise" in names:
        d = {"w": T.movedim(0, -1)}
        if bias:
            d["b"] = torch.einsum("cnb,cmb->nmc", Sb, Sb)
        out["ntk_classwise"] = d
    return out


def _dense_ggn_gram_stats(A, S, cfg: ExtensionConfig, bias: bool):
    """Loss-scaled logit-space Gram blocks for y = x @ W (+ b).

    A: [N, R, a] inputs, S: [C̃, N, R, b] the exact sweep's loss-scaled
    factors.  The half-sandwich row J'[(n,c)] = A_nᵀS[c,n] gives
    T[n, m, c, c'] = ⟨J'[(n,c)], J'[(m,c')]⟩, emitted as [N, N, C̃, C̃].
    Rank-1 layers take the closed form; with ``use_kernels`` and
    ``use_fused`` the C̃·N class-major rows go through one ``cross_dot``
    launch (E = 1, each input row read for its C̃ rows); without kernels
    whichever form has fewer elements: JAX's pairwise products or the
    rows' Gram.
    """
    Af, Sf = _f32(A).contiguous(), _f32(S).contiguous()
    c, n, r, b = Sf.shape
    a = Af.shape[-1]
    if r == 1:
        KA = Af[:, 0] @ Af[:, 0].T                                # [N, N]
        KS = torch.einsum("cnb,dmb->nmcd", Sf[:, :, 0], Sf[:, :, 0])
        T = KA[:, :, None, None] * KS
    else:
        if cfg.use_kernels and cfg.use_fused:
            rows = Sf.reshape(1, c * n, r, b)
            flat = kops.cross_dot(Af[None], rows, Af[None], rows)[0]
        elif c * n * a * b < n * n * r * (r + c * b):
            G = torch.einsum("nra,cnrb->cnab", Af, Sf).reshape(1, c * n, a, b)
            flat = _gram_of_g(G, G)[0]
        else:
            ga = torch.einsum("nra,msa->nmrs", Af, Af)
            flat = torch.einsum("nmrs,cnrb,dmsb->cndm", ga, Sf, Sf)
        # [(c,n), (d,m)] → [n, m, c, d]
        T = flat.reshape(c, n, c, n).permute(1, 3, 0, 2)
    d = {"w": T}
    if bias:
        Sb = Sf.sum(dim=2)                                        # [C, N, b]
        d["b"] = torch.einsum("cnb,dmb->nmcd", Sb, Sb)
    return {"ggn_gram": d}


def dense_curv_stats(A, S, exts, cfg: ExtensionConfig, bias: bool, ext_prefix):
    """Second-order stats for a Dense layer from backpropagated factor ``S``.

    A: [N, R, a], S: [C̃, N, R, b] (leading factor axis, carries 1/√m).
    diag: Σ_{c,n} (Σ_r A[n,r,i] S[c,n,r,j])∘²  (Eq. 19/22).
    Kron B factor: R · Σ_{c,n,r} S Sᵀ (Grosse–Martens spatial scaling).
    Per-sample GGN trace: Σ_{c,a,b} of the squared contribution per n.
    With ``cfg.use_kernels`` every requested statistic of an R > 1 layer
    comes out of ONE fused kernel launch over (A, S); rank-1 layers take the
    closed forms (the diagonal through ``sq_matmul`` on the broadcast input).
    With ``use_fused=False`` the diagonal goes through ``per_sample_sq_sum``
    on the broadcast ``[C·N, R, a]`` input (the ``per_sample_moment``
    kernel), and kron and trace stay einsums, as in the JAX package.
    The MC sweep lands here too, its sample axis standing in for classes;
    the raw-Jacobian (``"ntk"``) sweep takes the NTK blocks instead, and the
    exact sweep adds the GGNGram blocks when they are asked for.
    """
    names = {e.name for e in exts}
    if ext_prefix == "ntk":
        return _dense_ntk_stats(A, S, names, cfg, bias)
    out = {}
    c, n, r, b = S.shape
    Af, Sf = _f32(A).contiguous(), _f32(S).contiguous()
    diag_name = "diag_ggn_mc" if ext_prefix == "mc" else "diag_ggn"
    kron_name = "kfac" if ext_prefix == "mc" else "kflr"
    mask = second_order_mask(names)
    rank1 = A.shape[1] == 1
    kmask = FusedSecondMask() if rank1 else mask
    fused = None
    if cfg.use_kernels and cfg.use_fused and kmask.any():
        fused = kops.fused_second_order(Af, Sf, **kmask.wants())
    if diag_name in names:
        if fused is not None:
            w = fused["diag"]
        else:
            Arep = Af[None].expand((c,) + tuple(Af.shape)).reshape(c * n, r, -1)
            Srep = Sf.reshape(c * n, r, b)
            w = per_sample_sq_sum(Arep, Srep, use_kernels=cfg.use_kernels)
        d = {"w": w}
        if bias:
            ssum = Sf.sum(dim=2)
            d["b"] = (ssum * ssum).sum(dim=(0, 1))
        out[diag_name] = d
    if kron_name in names:
        if fused is not None:
            ssq = fused["kron"]
        else:
            Sflat = Sf.reshape(-1, b)
            ssq = Sflat.T @ Sflat
        b_fac = ssq * float(r)
        out[kron_name] = {"w": {"B": b_fac}}
        if bias:
            out[kron_name]["b"] = {"B": b_fac}
    if "ggn_trace" in names:
        if fused is not None:
            tr = fused["trace"]
        elif rank1:
            # t² = A²[n,a]·S²[c,n,b] separates: trace_n = ‖A_n‖²·Σ_cb S².
            tr = (Af[:, 0] ** 2).sum(-1) * (Sf[:, :, 0] ** 2).sum(dim=(0, 2))
        else:
            t = torch.einsum("nra,cnrb->cnab", Af, Sf)
            tr = (t * t).sum(dim=(0, 2, 3))
        d = {"w": tr}
        if bias:
            ssum = Sf.sum(dim=2)
            d["b"] = (ssum * ssum).sum(dim=(0, 2))
        out["ggn_trace"] = d
    if "ggn_gram" in names:
        out.update(_dense_ggn_gram_stats(A, S, cfg, bias))
    return out


# ---------------------------------------------------------------------------
# base Module
# ---------------------------------------------------------------------------


class Module(nn.Module):
    """Base module: parameter-free, ``torch.func.vjp``-backed fallbacks."""

    def params(self):
        """This module's parameters as the JAX package's pytree."""
        return ()

    def call(self, params, x):
        raise NotImplementedError

    def forward(self, x):
        return self.call(self.params(), x)

    def forward_tape(self, params, x):
        return self.call(params, x), x

    # -- first-order sweep ---------------------------------------------------
    def backward(self, params, tape, g, exts, cfg):
        _, vjp = torch.func.vjp(lambda xx: self.call(params, xx), tape)
        return vjp(g)[0], (), {}

    # -- matrix-Jacobian products --------------------------------------------
    def jac_t_mat(self, params, tape, M):
        _, vjp = torch.func.vjp(lambda xx: self.call(params, xx), tape)
        return torch.func.vmap(lambda m: vjp(m)[0])(M)

    # -- GGN-factor sweep ------------------------------------------------------
    def curv_backward(self, params, tape, S, exts, cfg, ext_prefix):
        return self.jac_t_mat(params, tape, S), {}

    # -- chain-only sweeps ----------------------------------------------------
    def kfra_backward(self, params, tape, Gbar, exts, cfg):
        raise UnsupportedSweep(f"KFRA unsupported for {type(self).__name__}")

    def kfra_partials(self, params, tape, cfg):
        """Batch-mean chain partials of the Ḡ recursion."""
        raise UnsupportedSweep(f"KFRA unsupported for {type(self).__name__}")

    def kfra_apply(self, params, Gbar, partials, exts, cfg):
        """One Ḡ recursion step from chain partials:
        ``kfra_backward(tape) == kfra_apply(kfra_partials(tape))``."""
        raise UnsupportedSweep(f"KFRA unsupported for {type(self).__name__}")

    def hess_backward(self, params, tape, g, factors, exts, cfg):
        raise UnsupportedSweep(
            f"DiagHessian unsupported for {type(self).__name__}")

    # -- serving ----------------------------------------------------------------
    def decode_step(self, params, x, cache):
        """Single-token decode. Stateless modules apply as-is."""
        return self.call(params, x), cache

    def init_cache(self, params, batch, max_len, dtype):
        return ()


class Lambda(Module):
    """Wrap a parameter-free function (reshapes, masking...)."""

    def __init__(self, fn: Callable):
        super().__init__()
        self.fn = fn

    def call(self, params, x):
        return self.fn(x)


# ---------------------------------------------------------------------------
# Dense
# ---------------------------------------------------------------------------


class Dense(Module):
    """y = x @ W (+ b), x: [N, ..., d_in]; ``w`` is ``[d_in, d_out]``."""

    def __init__(self, d_in, d_out, use_bias=True, init_scale=None,
                 device="cuda", generator: Optional[torch.Generator] = None,
                 dtype=torch.float32):
        super().__init__()
        self.d_in, self.d_out, self.use_bias = d_in, d_out, use_bias
        scale = d_in ** -0.5 if init_scale is None else init_scale
        self.w = normal_param((d_in, d_out), scale, device, generator, dtype)
        self.b = zeros_param((d_out,), device, dtype) if use_bias else None

    def params(self):
        p = {"w": self.w}
        if self.use_bias:
            p["b"] = self.b
        return p

    def call(self, params, x):
        y = x @ params["w"]
        if self.use_bias:
            y = y + params["b"]
        return y

    def backward(self, params, tape, g, exts, cfg):
        x = tape
        A, B = _nra(x), _nra(g)
        Af, Bf = _f32(A), _f32(B)
        grads = {"w": Af.reshape(-1, self.d_in).T @ Bf.reshape(-1, self.d_out)}
        if self.use_bias:
            grads["b"] = Bf.sum(dim=(0, 1))
        g_in = (g @ params["w"].T).reshape(x.shape)
        stats = dense_first_order_stats(A, B, exts, cfg, self.use_bias) if exts else {}
        return g_in, grads, stats

    def jac_t_mat(self, params, tape, M):
        return M @ params["w"].T

    def curv_backward(self, params, tape, S, exts, cfg, ext_prefix):
        A = _nra(tape)
        c = S.shape[0]
        Sr = S.reshape((c,) + tuple(A.shape[:2]) + (self.d_out,))
        stats = dense_curv_stats(A, Sr, exts, cfg, self.use_bias, ext_prefix)
        return self.jac_t_mat(params, tape, S), stats

    def kfra_backward(self, params, tape, Gbar, exts, cfg):
        return self.kfra_apply(params, Gbar,
                               self.kfra_partials(params, tape, cfg), exts, cfg)

    def kfra_partials(self, params, tape, cfg):
        A = _f32(_nra(tape))
        n, r, a = A.shape
        Aflat = A.reshape(-1, a)
        return {"a": Aflat.T @ Aflat / float(n * r)}

    def kfra_apply(self, params, Gbar, partials, exts, cfg):
        stats = {}
        if "kfra" in {e.name for e in exts}:
            d = {"w": {"A": partials["a"], "B": Gbar}}
            if self.use_bias:
                d["b"] = {"B": Gbar}
            stats["kfra"] = d
        w = _f32(params["w"])
        return w @ Gbar @ w.T, stats

    def hess_backward(self, params, tape, g, factors, exts, cfg):
        A = _nra(tape)
        n, r, _ = A.shape
        diag_w = torch.zeros((self.d_in, self.d_out), device=A.device)
        diag_b = torch.zeros((self.d_out,), device=A.device)
        new_factors = []
        for S, sign in factors:
            c = S.shape[0]
            Sr = _f32(S).reshape((c, n, r, self.d_out))
            Arep = A[None].expand((c,) + tuple(A.shape)).reshape(c * n, r, -1)
            diag_w = diag_w + sign * per_sample_sq_sum(Arep, Sr.reshape(c * n, r, -1))
            ssum = Sr.sum(dim=2)
            diag_b = diag_b + sign * (ssum * ssum).sum(dim=(0, 1))
            new_factors.append((self.jac_t_mat(params, tape, S), sign))
        g_in, _, _ = self.backward(params, tape, g, (), cfg)
        stats = {"diag_hessian": {"w": diag_w}}
        if self.use_bias:
            stats["diag_hessian"]["b"] = diag_b
        return g_in, new_factors, stats


# ---------------------------------------------------------------------------
# Embedding and RMSNorm (the language models' serving side; their BackPACK
# sweeps come with BackPACK on language models)
# ---------------------------------------------------------------------------


class Embedding(Module):
    """Token embedding lookup; input int tokens [N, T] -> [N, T, d]; ``w``
    is ``[vocab, d]``, drawn at scale d^-1/2 unless ``scale`` is given."""

    def __init__(self, vocab, d, dtype=torch.float32, scale=None, device="cuda",
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.vocab, self.d = vocab, d
        self.scale = scale if scale is not None else d ** -0.5
        self.w = normal_param((vocab, d), self.scale, device, generator, dtype)

    def params(self):
        return {"w": self.w}

    def call(self, params, x):
        return params["w"][x]


class RMSNorm(Module):
    """x / rms(x) · g, the mean square taken in float32 and the normalised x
    cast back to x's dtype before the gain, as JAX's ``_norm`` does."""

    def __init__(self, d, eps=1e-6, dtype=torch.float32, device="cuda"):
        super().__init__()
        self.d, self.eps = d, eps
        self.g = full_param((d,), 1.0, device, dtype)

    def params(self):
        return {"g": self.g}

    def call(self, params, x):
        xf = _f32(x)
        r = torch.rsqrt((xf * xf).mean(dim=-1, keepdim=True) + self.eps)
        return (xf * r).to(x.dtype) * params["g"]


# ---------------------------------------------------------------------------
# activations
# ---------------------------------------------------------------------------


def _pointwise_grad(f, order):
    """x ↦ f^(order)(x) elementwise, by ``torch.func`` (as JAX's jax.grad)."""
    for _ in range(order):
        f = torch.func.grad(f)
    vf = torch.func.vmap(f)
    return lambda x: vf(x.reshape(-1)).reshape(x.shape)


def _gelu(x):
    return F.gelu(x, approximate="tanh")  # jax.nn.gelu's default


_ACTS = {
    "relu": (F.relu, lambda x: (x > 0).float(), lambda x: torch.zeros_like(x)),
    "gelu": (_gelu, _pointwise_grad(_gelu, 1), _pointwise_grad(_gelu, 2)),
    "silu": (F.silu, _pointwise_grad(F.silu, 1), _pointwise_grad(F.silu, 2)),
    "sigmoid": (torch.sigmoid,
                lambda x: torch.sigmoid(x) * (1 - torch.sigmoid(x)),
                lambda x: (torch.sigmoid(x) * (1 - torch.sigmoid(x))
                           * (1 - 2 * torch.sigmoid(x)))),
    "tanh": (torch.tanh,
             lambda x: 1 - torch.tanh(x) ** 2,
             lambda x: -2 * torch.tanh(x) * (1 - torch.tanh(x) ** 2)),
    "identity": (lambda x: x, torch.ones_like, torch.zeros_like),
}


class Activation(Module):
    """Elementwise activation with first & second derivative (Eq. 25/26)."""

    def __init__(self, name):
        super().__init__()
        self.name = name
        self.fn, self.d1, self.d2 = _ACTS[name]

    def call(self, params, x):
        return self.fn(x)

    def backward(self, params, tape, g, exts, cfg):
        return (self.d1(_f32(tape)) * _f32(g)).to(g.dtype), (), {}

    def jac_t_mat(self, params, tape, M):
        return (self.d1(_f32(tape))[None] * _f32(M)).to(M.dtype)

    def kfra_backward(self, params, tape, Gbar, exts, cfg):
        return self.kfra_apply(params, Gbar,
                               self.kfra_partials(params, tape, cfg), exts, cfg)

    def kfra_partials(self, params, tape, cfg):
        d1 = self.d1(_f32(tape)).reshape(tape.shape[0], -1, tape.shape[-1])
        n, r, h = d1.shape
        d1f = d1.reshape(-1, h)
        return {"m": d1f.T @ d1f / float(n * r)}  # E_n[f'_n f'_nᵀ]

    def kfra_apply(self, params, Gbar, partials, exts, cfg):
        # Ḡ_in = Ḡ ∘ E_n[f'_n f'_nᵀ]
        return Gbar * partials["m"], {}

    def hess_backward(self, params, tape, g, factors, exts, cfg):
        x = _f32(tape)
        d1 = self.d1(x)
        new_factors = [((d1[None] * _f32(S)).to(S.dtype), sign)
                       for S, sign in factors]
        # residual: R = diag(f''(x) ∘ δ) per sample-unit (Eq. 26)
        resid = self.d2(x) * _f32(g)
        h = x.shape[-1]
        pos = torch.sqrt(resid.clamp_min(0.0))
        neg = torch.sqrt((-resid).clamp_min(0.0))
        eye = torch.eye(h, device=x.device)
        shape = (h,) + tuple(x.shape)
        P = (pos[..., None] * eye).movedim(-1, 0).reshape(shape)
        Nf = (neg[..., None] * eye).movedim(-1, 0).reshape(shape)
        new_factors.append((P, 1.0))
        new_factors.append((Nf, -1.0))
        g_in = (d1 * _f32(g)).to(g.dtype)
        return g_in, new_factors, {}


# ---------------------------------------------------------------------------
# combinators
# ---------------------------------------------------------------------------


class Sequential(Module):
    def __init__(self, mods: Sequence[Module]):
        super().__init__()
        self.mods = nn.ModuleList(mods)

    def params(self):
        return tuple(m.params() for m in self.mods)

    def call(self, params, x):
        for m, p in zip(self.mods, params):
            x = m.call(p, x)
        return x

    def forward_tape(self, params, x):
        tapes = []
        for m, p in zip(self.mods, params):
            x, t = m.forward_tape(p, x)
            tapes.append(t)
        return x, tuple(tapes)

    def backward(self, params, tape, g, exts, cfg):
        n = len(self.mods)
        grads, stats = [None] * n, [None] * n
        for i in reversed(range(n)):
            g, grads[i], stats[i] = self.mods[i].backward(
                params[i], tape[i], g, exts, cfg)
            if g is None and i > 0:
                raise ValueError("cotangent vanished mid-chain")
        return g, tuple(grads), tuple(stats)

    def jac_t_mat(self, params, tape, M):
        for i in reversed(range(len(self.mods))):
            M = self.mods[i].jac_t_mat(params[i], tape[i], M)
        return M

    def curv_backward(self, params, tape, S, exts, cfg, ext_prefix):
        curv = [None] * len(self.mods)
        for i in reversed(range(len(self.mods))):
            S, curv[i] = self.mods[i].curv_backward(
                params[i], tape[i], S, exts, cfg, ext_prefix)
        return S, tuple(curv)

    def kfra_backward(self, params, tape, Gbar, exts, cfg):
        stats = [None] * len(self.mods)
        for i in reversed(range(len(self.mods))):
            Gbar, stats[i] = self.mods[i].kfra_backward(
                params[i], tape[i], Gbar, exts, cfg)
        return Gbar, tuple(stats)

    def kfra_partials(self, params, tape, cfg):
        return tuple(m.kfra_partials(p, t, cfg)
                     for m, p, t in zip(self.mods, params, tape))

    def kfra_apply(self, params, Gbar, partials, exts, cfg):
        stats = [None] * len(self.mods)
        for i in reversed(range(len(self.mods))):
            Gbar, stats[i] = self.mods[i].kfra_apply(
                params[i], Gbar, partials[i], exts, cfg)
        return Gbar, tuple(stats)

    def hess_backward(self, params, tape, g, factors, exts, cfg):
        stats = [None] * len(self.mods)
        for i in reversed(range(len(self.mods))):
            g, factors, stats[i] = self.mods[i].hess_backward(
                params[i], tape[i], g, factors, exts, cfg)
        return g, factors, tuple(stats)

    def decode_step(self, params, x, cache):
        new_cache = list(cache)
        for i, (m, p) in enumerate(zip(self.mods, params)):
            x, new_cache[i] = m.decode_step(p, x, cache[i])
        return x, tuple(new_cache)

    def init_cache(self, params, batch, max_len, dtype):
        return tuple(m.init_cache(p, batch, max_len, dtype)
                     for m, p in zip(self.mods, params))


def _layer(tree, i):
    return tree_map(lambda t: t[i], tree)


def _stack(trees):
    return tree_map(lambda *ts: torch.stack(ts), *trees)


class ScanStack(Module):
    """L homogeneous blocks with their parameters and decode caches stacked
    on a leading layer axis, as JAX's ``vmap``/``lax.scan`` give them (so a
    ``[L, ...]`` leaf crosses the bridge as it is); the scan is a Python loop
    over ``params[i]``.

    ``make_block(device)`` builds one block; it is called L times on
    ``device`` (each drawing its own weights, which are stacked) and once on
    the ``meta`` device for the template whose ``call`` / ``decode_step`` /
    ``init_cache`` every layer runs with its own slice of the stacked trees.
    The BackPACK sweeps through a stack come with BackPACK on language models.
    """

    def __init__(self, make_block: Callable[[object], Module], n_layers: int,
                 device="cuda"):
        super().__init__()
        self.L = n_layers
        # not a registered child: its meta tensors are never moved or copied
        self.__dict__["block"] = make_block("meta")
        stacked = _stack([make_block(device).params() for _ in range(n_layers)])
        self._names = tree_map_with_path(lambda path, _: "__".join(map(str, path)), stacked)
        for name, leaf in zip(tree_leaves(self._names), tree_leaves(stacked)):
            self.register_parameter(name, nn.Parameter(leaf, requires_grad=False))

    def params(self):
        return tree_map(lambda name: getattr(self, name), self._names)

    def call(self, params, x):
        for i in range(self.L):
            x = self.block.call(_layer(params, i), x)
        return x

    def decode_step(self, params, x, cache):
        caches = []
        for i in range(self.L):
            x, c = self.block.decode_step(_layer(params, i), x, _layer(cache, i))
            caches.append(c)
        return x, _stack(caches)

    def init_cache(self, params, batch, max_len, dtype):
        return _stack([self.block.init_cache(_layer(params, i), batch, max_len, dtype)
                       for i in range(self.L)])
