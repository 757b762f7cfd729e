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


def _f32(x):
    return x.float()


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


def normal_param(shape, scale, device, generator=None) -> nn.Parameter:
    """A frozen parameter of N(0, scale²) entries drawn from ``generator``
    (a CPU generator; the draws do not depend on ``device``)."""
    w = torch.randn(shape, generator=generator) * scale
    return nn.Parameter(w.to(resolve_device(device)), requires_grad=False)


def zeros_param(shape, device) -> nn.Parameter:
    return nn.Parameter(torch.zeros(shape, device=resolve_device(device)),
                        requires_grad=False)


class UnsupportedSweep(Exception):
    """Raised when a sweep (KFRA / DiagHessian) hits a non-chain module."""


# ---------------------------------------------------------------------------
# shared moment helpers (the paper's App. A.1 formulas, sequence-generalized)
# ---------------------------------------------------------------------------


def _not_ported(kernel):
    return ValueError(
        f"use_kernels=True with use_fused=False needs the {kernel} kernel, "
        "which is not ported yet (per_sample_moment, batch_l2): use "
        "use_fused=True or use_kernels=False")


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
        raise _not_ported("per_sample_moment")
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
        raise _not_ported("batch_l2")
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


def dense_curv_stats(A, S, exts, cfg: ExtensionConfig, bias: bool, ext_prefix):
    """Second-order stats for a Dense layer from backpropagated factor ``S``.

    A: [N, R, a], S: [C̃, N, R, b] (leading factor axis, carries 1/√m).
    diag: Σ_{c,n} (Σ_r A[n,r,i] S[c,n,r,j])∘²  (Eq. 19/22).
    Kron B factor: R · Σ_{c,n,r} S Sᵀ (Grosse–Martens spatial scaling).
    Per-sample GGN trace: Σ_{c,a,b} of the squared contribution per n.
    With ``cfg.use_kernels`` every requested statistic of an R > 1 layer
    comes out of ONE fused kernel launch over (A, S); rank-1 layers take the
    closed forms (the diagonal through ``sq_matmul`` on the broadcast input).
    The MC sweep lands here too, its sample axis standing in for classes.
    """
    names = {e.name for e in exts}
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
                 device="cuda", generator: Optional[torch.Generator] = None):
        super().__init__()
        self.d_in, self.d_out, self.use_bias = d_in, d_out, use_bias
        scale = d_in ** -0.5 if init_scale is None else init_scale
        self.w = normal_param((d_in, d_out), scale, device, generator)
        self.b = zeros_param((d_out,), device) if use_bias else None

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
