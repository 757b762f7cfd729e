"""Loss functions with the derivative structure BackPACK needs.

For a loss ``L(θ) = (1/M) Σ_m ℓ(z_m, y_m)`` over M sample units, each loss
exposes

  * ``value(z, y)``            — scalar mean loss,
  * ``grad(z, y)``             — cotangents dL/dz, already carrying the 1/M,
  * ``sqrt_hessian(z, y)``     — exact symmetric factor ``S`` with
                                 ``S Sᵀ = ∇²_z L`` (paper Eq. 15), shape
                                 ``[C, *z.shape]``,
  * ``sqrt_hessian_chunk(z, y, lo, size)`` — columns ``[lo, lo+size)`` of it,
  * ``sqrt_hessian_mc(rng, z, y, k)`` — Monte-Carlo factor ``S̃`` (Eq. 20),
                                 shape ``[k, *z.shape]``,
  * ``hessian_mean(z, y)``     — batch-averaged loss Hessian (KFRA Eq. 24b).

The 1/M of the mean is folded into the factors as 1/sqrt(M).  Port of
``src/repro/core/loss_hessian.py``.

MC draws.  ``rng`` of :meth:`sqrt_hessian_mc` is either a
``torch.Generator`` or a tensor holding the draws themselves: class indices
``[k, *y.shape]`` for cross-entropy, ±1 signs ``[k, *z.shape]`` for MSE.
PyTorch cannot reproduce JAX's threefry streams, so the parity tests pass
JAX's draws in this way.  Generator draws are made on the generator's device
and moved to ``z``'s, so one CPU generator seeded alike gives the same draws
for a CPU and a CUDA run.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F


def _f32_dtype(x: torch.Tensor) -> torch.dtype:
    """float32, or float64 where ``x`` is float64: a reference computed in
    float64 on the CPU stays float64."""
    return torch.float64 if x.dtype == torch.float64 else torch.float32


def _f32(x: torch.Tensor) -> torch.Tensor:
    """``x`` in float32 (bfloat16 and float16 widened), or float64 kept
    (:func:`_f32_dtype`)."""
    return x.to(_f32_dtype(x))


def _uniform(rng: torch.Generator, shape) -> torch.Tensor:
    return torch.rand(shape, generator=rng, device=rng.device)


class CrossEntropyLoss:
    """Softmax cross-entropy over the last axis of ``z``; integer targets.

    ``z``: [..., C] logits.  ``y``: [...] int targets.  Mean over all target
    positions; positions where ``y < 0`` are masked out of the mean.
    """

    name = "cross_entropy"

    def _mask_and_m(self, y):
        mask = y >= 0
        m = mask.sum().clamp_min(1).float()
        return mask, m

    def value(self, z, y):
        mask, m = self._mask_and_m(y)
        logp = torch.log_softmax(_f32(z), dim=-1)
        picked = torch.gather(logp, -1, y.clamp_min(0)[..., None])[..., 0]
        return -(picked * mask).sum() / m

    def grad(self, z, y):
        mask, m = self._mask_and_m(y)
        p = torch.softmax(_f32(z), dim=-1)
        onehot = F.one_hot(y.clamp_min(0), z.shape[-1]).to(p.dtype)
        g = (p - onehot) * mask[..., None] / m
        return g.to(z.dtype)

    # The loss Hessian over z = [N, U, C] (U = unit axes flattened) is
    # block-diagonal over (n, u), so the exact factor has one column per
    # (unit u, class c): S[(u,c), n, u', v] = δ_{u,u'} √p_c (e_c − p)_v / √m.

    def n_exact_cols(self, z):
        C = z.shape[-1]
        U = z.numel() // (z.shape[0] * C)
        return U * C

    def sqrt_hessian(self, z, y):
        return self.sqrt_hessian_chunk(z, y, 0, self.n_exact_cols(z))

    def sqrt_hessian_chunk(self, z, y, lo, size):
        """Columns [lo, lo+size) of the exact factor's leading (U·C) axis."""
        mask, m = self._mask_and_m(y)
        C, N = z.shape[-1], z.shape[0]
        U = z.numel() // (N * C)
        p = torch.softmax(_f32(z.reshape(N, U, C)), dim=-1)
        maskf = mask.reshape(N, U).to(p.dtype)
        cols = lo + torch.arange(size, device=z.device)
        valid = (cols < U * C).to(p.dtype)
        cols = cols.clamp_max(U * C - 1)
        u_idx, c_idx = cols // C, cols % C
        onehot_u = F.one_hot(u_idx, U).to(p.dtype)                 # [size, U]
        onehot_c = F.one_hot(c_idx, C).to(p.dtype)                 # [size, C]
        p_u = p[:, u_idx, :]                                       # [N, size, C]
        sp_uc = torch.sqrt(p_u.gather(-1, c_idx[None, :, None].expand(N, -1, 1)))[..., 0]
        col = sp_uc[..., None] * (onehot_c[None] - p_u)            # [N, size, C]
        col = col * maskf[:, u_idx][..., None]
        S = onehot_u.T[None, :, :, None] * col[:, None, :, :]     # [N, U, size, C]
        S = S.movedim(2, 0) * valid[:, None, None, None] / torch.sqrt(m)
        return S.reshape((size,) + tuple(z.shape)).to(z.dtype)

    def sqrt_hessian_mc(self, rng, z, y, k=1):
        """MC factor from ``k`` sampled classes per position (see the module
        doc for what ``rng`` may be)."""
        mask, m = self._mask_and_m(y)
        p = torch.softmax(_f32(z), dim=-1)
        if isinstance(rng, torch.Generator):
            # Inverse-CDF sampling from uniforms drawn on the generator.
            u = _uniform(rng, (k,) + tuple(y.shape)).to(z.device)
            cdf = torch.cumsum(p, dim=-1)
            yhat = (u[..., None] > cdf[None]).sum(-1).clamp_max(z.shape[-1] - 1)
        else:
            yhat = rng.to(device=z.device, dtype=torch.long)
            if tuple(yhat.shape) != (k,) + tuple(y.shape):
                raise ValueError(f"MC draws must have shape {(k,) + tuple(y.shape)}, "
                                 f"got {tuple(yhat.shape)}")
        onehot = F.one_hot(yhat, z.shape[-1]).to(p.dtype)
        S = (p[None] - onehot) * mask[None, ..., None]
        S = S / torch.sqrt(m * k)
        return S.to(z.dtype)

    def hessian_mean(self, z, y):
        """(1/m) Σ ∇²ℓ — KFRA initialization (Eq. 24b). [C, C]."""
        mask, m = self._mask_and_m(y)
        p = torch.softmax(_f32(z), dim=-1) * mask[..., None]
        pf = p.reshape(-1, z.shape[-1])
        H = torch.diag(pf.sum(0)) - pf.T @ pf
        return H / m


class MSELoss:
    """0.5‖z − y‖² summed over the last axis, mean over the rest."""

    name = "mse"

    @staticmethod
    def _m(y):
        return max(y.numel() // y.shape[-1], 1)

    def value(self, z, y):
        return 0.5 * ((_f32(z) - y) ** 2).sum() / self._m(y)

    def grad(self, z, y):
        return ((_f32(z) - y) / self._m(y)).to(z.dtype)

    def n_exact_cols(self, z):
        C = z.shape[-1]
        U = z.numel() // (z.shape[0] * C)
        return U * C

    def sqrt_hessian(self, z, y):
        return self.sqrt_hessian_chunk(z, y, 0, self.n_exact_cols(z))

    def sqrt_hessian_chunk(self, z, y, lo, size):
        """Column (u,c) = δ_{u,u'} e_c / √m  (u-major leading axis)."""
        m = self._m(y)
        C, N = z.shape[-1], z.shape[0]
        U = z.numel() // (N * C)
        cols = lo + torch.arange(size, device=z.device)
        valid = (cols < U * C).float()
        cols = cols.clamp_max(U * C - 1)
        onehot_u = F.one_hot(cols // C, U).float()
        onehot_c = F.one_hot(cols % C, C).float()
        S = onehot_u[:, None, :, None] * onehot_c[:, None, None, :]
        S = S.expand(size, N, U, C) * valid[:, None, None, None]
        return (S / math.sqrt(m)).reshape((size,) + tuple(z.shape)).to(z.dtype)

    def sqrt_hessian_mc(self, rng, z, y, k=1):
        """MC factor from Rademacher vectors (E[s sᵀ] = I); see the module
        doc for what ``rng`` may be."""
        m = self._m(y)
        shape = (k,) + tuple(z.shape)
        if isinstance(rng, torch.Generator):
            s = (_uniform(rng, shape) < 0.5).float() * 2 - 1
        else:
            s = rng.float()
            if tuple(s.shape) != shape:
                raise ValueError(f"MC draws must have shape {shape}, got {tuple(s.shape)}")
        return (s.to(z.device) / math.sqrt(m * k)).to(z.dtype)

    def hessian_mean(self, z, y):
        # per-position Hessian of 0.5‖z−y‖² is I; its mean over positions is I.
        return torch.eye(z.shape[-1], device=z.device)
