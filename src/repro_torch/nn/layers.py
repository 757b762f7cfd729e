"""Conv2d, MaxPool2d, Flatten, BatchedDense and Param in the BackPACK
module protocol.

Port of ``src/repro/nn/layers.py:87-251``.  Activations stay NHWC between
layers, as in JAX, so ``Flatten`` orders features the same way and Dense
weights line up across the two packages.

Conv2d runs through unfold, so every Dense formula applies to it with the
H′·W′ patches as the R axis (Grosse & Martens 2016).  ``F.unfold`` on NCHW
gives channel-major patch features (C_in, kh, kw), the order of JAX's
``conv_general_dilated_patches``, so ``w`` is ``[kh·kw·C_in, C_out]`` in both.
XLA's ``"SAME"`` pads low = total // 2 and puts the odd pixel at the high
end; ``F.unfold`` pads symmetrically, so the padding is applied with
``F.pad`` first.  The forward pass is unfold + ``torch.matmul``, never
cuDNN, and the input cotangent is ``F.fold`` of ``B @ wᵀ``, the exact
adjoint of the unfold.

``BatchedDense`` holds a mixture of experts' weights ``[E, a, b]``; its
statistics are token-level (each routed token is a sample unit: a
per-sequence moment is undefined once a sequence's tokens route to
different experts), so it has no per-sample entries.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.core.module import (
    Module,
    _f32,
    dense_curv_stats,
    dense_first_order_stats,
    full_param,
    normal_param,
    zeros_param,
)
from repro_torch.kernels import ops as kops


def _pair(v):
    return (v, v) if isinstance(v, int) else tuple(v)


def _pads(padding, size, kernel, stride):
    """(low, high) padding of one spatial axis, as XLA computes it."""
    if padding == "VALID":
        return 0, 0
    if padding == "SAME":
        out = -(-size // stride)
        total = max((out - 1) * stride + kernel - size, 0)
        return total // 2, total - total // 2
    raise ValueError(f"padding must be 'SAME' or 'VALID', got {padding!r}")


class Conv2d(Module):
    """NHWC conv via unfold → Dense-shaped BackPACK formulas.

    x: [N, H, W, C_in] → [N, H', W', C_out].  The tape holds the patches
    ``[N, H'·W', kh·kw·C_in]`` (the layer's A) and the input shape.
    """

    def __init__(self, c_in, c_out, kernel=3, stride=1, padding="SAME",
                 use_bias=True, device="cuda",
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.c_in, self.c_out = c_in, c_out
        self.kernel = _pair(kernel)
        self.stride = _pair(stride)
        self.padding = padding
        self.use_bias = use_bias
        fan_in = self.kernel[0] * self.kernel[1] * c_in
        self.w = normal_param((fan_in, c_out), fan_in ** -0.5, device, generator)
        self.b = zeros_param((c_out,), device) if use_bias else None

    def params(self):
        p = {"w": self.w}
        if self.use_bias:
            p["b"] = self.b
        return p

    def _geometry(self, h, w):
        """((pad_top, pad_bottom, pad_left, pad_right), (H', W'))."""
        (kh, kw), (sh, sw) = self.kernel, self.stride
        pt, pb = _pads(self.padding, h, kh, sh)
        pl, pr = _pads(self.padding, w, kw, sw)
        hh = (h + pt + pb - kh) // sh + 1
        ww = (w + pl + pr - kw) // sw + 1
        return (pt, pb, pl, pr), (hh, ww)

    def _unfold(self, x):
        """x [N, H, W, C] → patches [N, H'·W', C·kh·kw] (contiguous), (H', W')."""
        (pt, pb, pl, pr), hw = self._geometry(x.shape[1], x.shape[2])
        xt = F.pad(x.permute(0, 3, 1, 2), (pl, pr, pt, pb))
        pat = F.unfold(xt, self.kernel, stride=self.stride)
        return pat.transpose(1, 2).contiguous(), hw

    def _fold(self, P, in_shape):
        """Adjoint of :meth:`_unfold`: P [K, H'·W', C·kh·kw] → [K, H, W, C]."""
        _, h, w, c = in_shape
        (pt, pb, pl, pr), _ = self._geometry(h, w)
        x = F.fold(P.transpose(1, 2), (h + pt + pb, w + pl + pr), self.kernel,
                   stride=self.stride)
        x = x[:, :, pt:pt + h, pl:pl + w]
        return x.permute(0, 2, 3, 1).contiguous()

    def _linear(self, params, pat, hw, n):
        y = pat @ params["w"]
        if self.use_bias:
            y = y + params["b"]
        return y.reshape(n, hw[0], hw[1], self.c_out)

    def call(self, params, x):
        pat, hw = self._unfold(x)
        return self._linear(params, pat, hw, x.shape[0])

    def forward_tape(self, params, x):
        pat, hw = self._unfold(x)
        return self._linear(params, pat, hw, x.shape[0]), (pat, tuple(x.shape))

    def backward(self, params, tape, g, exts, cfg):
        pat, in_shape = tape
        B = g.reshape(g.shape[0], -1, self.c_out)
        Af, Bf = _f32(pat), _f32(B)
        grads = {"w": Af.reshape(-1, Af.shape[-1]).T @ Bf.reshape(-1, self.c_out)}
        if self.use_bias:
            grads["b"] = Bf.sum(dim=(0, 1))
        g_in = self._fold(B @ params["w"].T, in_shape)
        stats = dense_first_order_stats(pat, B, exts, cfg, self.use_bias) if exts else {}
        return g_in, grads, stats

    def jac_t_mat(self, params, tape, M):
        _, in_shape = tape
        c, n = M.shape[:2]
        P = M.reshape(c * n, -1, self.c_out) @ params["w"].T
        return self._fold(P, in_shape).reshape((c,) + in_shape)

    def curv_backward(self, params, tape, S, exts, cfg, ext_prefix):
        pat, _ = tape
        c = S.shape[0]
        Sr = S.reshape(c, S.shape[1], -1, self.c_out)
        stats = dense_curv_stats(pat, Sr, exts, cfg, self.use_bias, ext_prefix)
        return self.jac_t_mat(params, tape, S), stats


class MaxPool2d(Module):
    """NHWC max pooling over ``size``×``size`` windows ("VALID").

    The cotangent goes to the first maximum of each window in row-major
    order — ``max_pool2d``'s index rule, and the one JAX's
    ``reduce_window`` max gradient follows on the windows of equal zeros
    that a ReLU leaves.  The tape holds the input shape and those indices.
    """

    def __init__(self, size=2, stride=None):
        super().__init__()
        self.size = size
        self.stride = stride or size

    def _pool(self, x):
        y, idx = F.max_pool2d(x.permute(0, 3, 1, 2), self.size, self.stride,
                              return_indices=True)
        return y.permute(0, 2, 3, 1).contiguous(), idx

    def call(self, params, x):
        return self._pool(x)[0]

    def forward_tape(self, params, x):
        y, idx = self._pool(x)
        return y, (tuple(x.shape), idx)

    def jac_t_mat(self, params, tape, M):
        (n, h, w, c), idx = tape
        k = M.shape[0]
        src = M.permute(0, 1, 4, 2, 3).reshape(k, n, c, -1)
        out = torch.zeros((k, n, c, h * w), dtype=M.dtype, device=M.device)
        out.scatter_add_(3, idx.reshape(1, n, c, -1).expand(k, -1, -1, -1), src)
        return out.reshape(k, n, c, h, w).permute(0, 1, 3, 4, 2).contiguous()

    def backward(self, params, tape, g, exts, cfg):
        return self.jac_t_mat(params, tape, g[None])[0], (), {}


class Flatten(Module):
    def call(self, params, x):
        return x.reshape(x.shape[0], -1)

    def forward_tape(self, params, x):
        return self.call(params, x), tuple(x.shape)

    def backward(self, params, tape, g, exts, cfg):
        return g.reshape(tape), (), {}

    def jac_t_mat(self, params, tape, M):
        return M.reshape((M.shape[0],) + tape)


class BatchedDense(Module):
    """Per-expert weights: x [E, cap, a] → [E, cap, b] through ``w`` [E, a,
    b] (``[L, E, a, b]`` once a ``ScanStack`` stacks it), drawn at scale
    a^-1/2 as JAX draws them.

    ``backward`` gives the gradient, the input cotangent and, for
    SecondMoment / Variance, the token-level Σ_slots G∘G with G = xᵀg per
    capacity slot: on the fused route one ``fused_first_order`` launch with
    the experts as its group axis and R = 1 (``[E, cap, 1, a]``), else
    ``(x∘x)ᵀ(g∘g)``; for KFAC / KFLR the A factor xᵀx / cap.  The GGN
    diagonal and the B factor of ``curv_backward`` are plain products, as
    in JAX (no kernel there)."""

    def __init__(self, n_experts, d_in, d_out, init_scale=None, dtype=torch.float32,
                 device="cuda", generator: Optional[torch.Generator] = None):
        super().__init__()
        self.E, self.d_in, self.d_out = n_experts, d_in, d_out
        scale = d_in ** -0.5 if init_scale is None else init_scale
        self.w = normal_param((n_experts, d_in, d_out), scale, device, generator, dtype)

    def params(self):
        return {"w": self.w}

    def call(self, params, x):
        return torch.bmm(x, params["w"])

    def backward(self, params, tape, g, exts, cfg):
        x = tape
        Af, Bf = _f32(x), _f32(g)
        grads = {"w": Af.transpose(1, 2) @ Bf}
        g_in = g @ params["w"].transpose(1, 2)
        names = {e.name for e in exts}
        stats = {}
        if "second_moment" in names or "variance" in names:
            if cfg.use_kernels and cfg.use_fused:
                w = kops.fused_first_order(Af[:, :, None, :].contiguous(),
                                           Bf[:, :, None, :].contiguous(),
                                           want_l2=False, want_moment=True)["moment"]
            else:
                w = (Af * Af).transpose(1, 2) @ (Bf * Bf)
            stats["_sum_grad2"] = {"w": w}
        if "kfac" in names or "kflr" in names:
            stats["_kron_a"] = {"w": Af.transpose(1, 2) @ Af / float(x.shape[1])}
        return g_in, grads, stats

    def jac_t_mat(self, params, tape, M):
        return M @ params["w"].transpose(1, 2)

    def curv_backward(self, params, tape, S, exts, cfg, ext_prefix):
        names = {e.name for e in exts}
        stats = {}
        Sf = _f32(S)
        diag_name = "diag_ggn_mc" if ext_prefix == "mc" else "diag_ggn"
        kron_name = "kfac" if ext_prefix == "mc" else "kflr"
        if diag_name in names:
            x2 = _f32(tape) ** 2
            stats[diag_name] = {"w": torch.einsum("eca,xecb->eab", x2, Sf * Sf)}
        if kron_name in names:
            stats[kron_name] = {"w": {"B": torch.einsum("xeci,xecj->eij", Sf, Sf)}}
        return self.jac_t_mat(params, tape, S), stats


class Param(Module):
    """Raw learnable tensor; ``call`` ignores x and returns the tensor
    (Hymba's ``a_log``), filled with the constant ``init``, or drawn from
    N(0, scale²) with ``generator`` where ``scale`` is given (Whisper's
    ``pos_dec``, JAX's ``0.01 * normal`` initialiser)."""

    def __init__(self, shape, init=0.0, dtype=torch.float32, device="cuda", scale=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.shape = tuple(shape)
        self.v = (full_param(self.shape, init, device, dtype) if scale is None
                  else normal_param(self.shape, scale, device, generator, dtype))

    def params(self):
        return {"v": self.v}

    def call(self, params, x):
        return params["v"]

    def backward(self, params, tape, g, exts, cfg):
        return None, {"v": g.to(params["v"].dtype)}, {}

    def jac_t_mat(self, params, tape, M):
        return None

    def curv_backward(self, params, tape, S, exts, cfg, ext_prefix):
        return None, {}
