"""Kernel dispatch: the one entry point of every reduction kernel.

The counterpart of the JAX registry's ``dispatch`` and ``_interpret``
(``src/repro/kernels/ops.py:102-200``).  The device of the inputs decides:

* a CPU tensor takes the plain version in :mod:`repro_torch.kernels.ref`;
* a CUDA tensor launches the Hopper kernel (built from ``csrc/`` at first
  use), or raises — there is no fallback;
* any other device raises.

Attention and WKV also have a gradient on the card: each kernel is launched
from the forward of a ``torch.autograd.Function`` whose backward recomputes
the plain version and takes its vector-Jacobian product, and whose ``jvp``
takes the plain version's forward-mode derivative (the JAX package has no
Pallas derivative either: XLA differentiates its plain ``sdpa`` and
``wkv_chunked``).  Both are written with ``torch.func``, and each Function
has a vmap rule, so ``torch.func.jvp``, ``vjp``, ``grad`` and ``vmap`` (the
curvature products of :mod:`repro_torch.curv`) go through the kernels.
Attention's derivatives go in blocks of ``ATTN_GRAD_Q_CHUNK`` queries, so
that no [T, S] matrix of all pairs is kept.  A call launches the kernel once
whether or not it needs a derivative, never the plain version in its place.
On the CPU autograd and ``torch.func`` reach the plain versions directly.

Each kernel has a launch counter, a plain integer that the wrapper raises by
one where it launches the kernel and nowhere else; :func:`launch_counts`
reads them and :func:`reset_launch_counts` sets them to 0, so a run can show
that it went through the kernels.  Each entry point also counts
``kernel.calls.<name>`` in :mod:`repro_torch.obs` once a call, on either
device (JAX's ``dispatch`` counts the same); on the card a call launches its
kernel once, so the counter moves with the launch count.

The TPU registry's padding policy (``_pad_to``, ``_auto_block``,
``_auto_class_chunk``, ``_pad_factor_pair``) served the (8, 128) tiling and
VMEM; the CUDA kernels mask their ragged edges themselves.  Its jit cache has
no counterpart either: PyTorch runs eagerly.  So JAX's
``kernel.cache_hit.*``, ``kernel.cache_miss.*`` and
``kernel.padding_waste_bytes.*`` counters have none.
"""
from __future__ import annotations

from typing import Dict

import torch

from repro_torch import obs
from repro_torch.kernels import ref
from repro_torch.kernels.batch_l2 import batch_l2_cuda
from repro_torch.kernels.cross_dot import cross_dot_cuda
from repro_torch.kernels.flash_attention import flash_attention_cuda
from repro_torch.kernels.fused_first_order import fused_first_order_cuda
from repro_torch.kernels.fused_second_order import fused_second_order_cuda
from repro_torch.kernels.ggn_diag import ggn_diag_cuda
from repro_torch.kernels.per_sample_moment import per_sample_moment_cuda
from repro_torch.kernels.predictive_var import predictive_var_cuda
from repro_torch.kernels.sq_matmul import sq_matmul_cuda
from repro_torch.kernels.wkv import wkv_cuda

KERNELS = ("fused_first_order", "fused_second_order", "sq_matmul",
           "per_sample_moment", "batch_l2", "ggn_diag", "cross_dot",
           "predictive_var", "flash_attention", "wkv")
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
    obs.count("kernel.calls.sq_matmul")
    if not _on_card("sq_matmul", A, B):
        return ref.sq_matmul(A, B)
    out = sq_matmul_cuda(A, B)
    _LAUNCHES["sq_matmul"] += 1
    return out


def fused_first_order(A, B, want_l2=True, want_moment=False, want_dot=False):
    """Fused first-order stats; A/B may be [N, R, a] (a leading group axis of
    1 is added and stripped) or [E, N, R, a].  Returns the requested keys of
    l2 [E, N] / moment [E, a, b] / dot [E, N, N].  The Dense sweeps pass
    [N, R, a]; ``BatchedDense`` passes [E, cap, 1, a], its experts the group
    axis and its capacity slots the samples (R = 1)."""
    obs.count("kernel.calls.fused_first_order")
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
    obs.count("kernel.calls.fused_second_order")
    wants = dict(want_diag=want_diag, want_kron=want_kron,
                 want_trace=want_trace)
    if not _on_card("fused_second_order", A, S):
        return ref.fused_second_order(A, S, **wants)
    out = fused_second_order_cuda(A, S, **wants)
    _LAUNCHES["fused_second_order"] += 1
    return out


def per_sample_moment(A: torch.Tensor, B: torch.Tensor) -> torch.Tensor:
    """Σ_n (A_nᵀB_n)∘²: A [N, R, a], B [N, R, b] → [a, b] float32."""
    obs.count("kernel.calls.per_sample_moment")
    if not _on_card("per_sample_moment", A, B):
        return ref.per_sample_moment(A, B)
    out = per_sample_moment_cuda(A, B)
    _LAUNCHES["per_sample_moment"] += 1
    return out


def batch_l2(A: torch.Tensor, B: torch.Tensor, form=None) -> torch.Tensor:
    """‖A_nᵀB_n‖²: A [N, R, a], B [N, R, b] → [N] float32.  On the card
    ``form`` (``"gram"`` or ``"g"``) overrides the kernel's choice of
    algorithm (:func:`repro_torch.kernels.batch_l2.batch_l2_form`)."""
    obs.count("kernel.calls.batch_l2")
    if not _on_card("batch_l2", A, B):
        return ref.batch_l2(A, B)
    out = batch_l2_cuda(A, B, form)
    _LAUNCHES["batch_l2"] += 1
    return out


def ggn_diag(A: torch.Tensor, S: torch.Tensor) -> torch.Tensor:
    """Σ_cn (A_nᵀS_cn)∘²: A [N, R, a], S [C, N, R, b] → [a, b] float32."""
    obs.count("kernel.calls.ggn_diag")
    if not _on_card("ggn_diag", A, S):
        return ref.ggn_diag(A, S)
    out = ggn_diag_cuda(A, S)
    _LAUNCHES["ggn_diag"] += 1
    return out


def full_a_side(A: torch.Tensor, B: torch.Tensor) -> torch.Tensor:
    """An A side [E or 1, N/k, R, a] as the [E, N, R, a] it stands for:
    the group axis broadcast, the rows repeated class-major."""
    A = A.expand((B.shape[0],) + tuple(A.shape[1:]))
    reps = B.shape[1] // A.shape[1]
    return A.repeat(1, reps, 1, 1) if reps > 1 else A


def cross_dot(A1, B1, A2, B2) -> torch.Tensor:
    """Cross-block pairwise dots out[e,n,m] = ⟨A1ᵀB1[e,n], A2ᵀB2[e,m]⟩.

    B1 [E, N1, R, b], B2 [E, N2, R, b] → [E, N1, N2] float32; 3-dimensional
    inputs get a group axis of 1, stripped from the output.  Each A side may
    be [E, N, R, a] or a shared one: a group axis of 1 serves every group,
    and N/k rows serve N rows class-major (row p of B pairs with row
    p mod N/k), so the NTK and GGNGram read the layer input without a
    broadcast copy.
    """
    obs.count("kernel.calls.cross_dot")
    squeeze = B1.dim() == 3
    if squeeze:
        A1, B1, A2, B2 = A1[None], B1[None], A2[None], B2[None]
    if _on_card("cross_dot", A1, B1, A2, B2):
        out = cross_dot_cuda(A1.contiguous(), B1.contiguous(), A2.contiguous(),
                             B2.contiguous())
        _LAUNCHES["cross_dot"] += 1
    else:
        out = ref.cross_dot(full_a_side(A1, B1), B1, full_a_side(A2, B2), B2)
    return out[0] if squeeze else out


def predictive_var(A: torch.Tensor, S: torch.Tensor, Sigma=None) -> torch.Tensor:
    """GLM predictive variance [C, N]: A [N, R, a], S [C, N, R, b], with the
    squared Jacobian weighted by ``Sigma`` [a, b] (a diagonal posterior) or
    not (a Kronecker posterior's half-transformed inputs)."""
    obs.count("kernel.calls.predictive_var")
    xs = (A, S) if Sigma is None else (A, S, Sigma)
    if not _on_card("predictive_var", *xs):
        return ref.predictive_var(A, S, Sigma)
    out = predictive_var_cuda(A, S, Sigma)
    _LAUNCHES["predictive_var"] += 1
    return out


ATTN_GRAD_Q_CHUNK = 512  # queries a block of attention's backward and jvp (sdpa_chunked's q_chunk)


def _on_floats(fn, xs):
    """``fn(*xs)`` as a function of the floating tensors of ``xs`` alone (the
    others held), and those tensors' indices."""
    idx = [i for i, x in enumerate(xs) if x is not None and x.is_floating_point()]

    def f(*floats):
        full = list(xs)
        for i, x in zip(idx, floats):
            full[i] = x
        return fn(*full)

    return f, idx


def _as_tuple(o):
    return o if isinstance(o, tuple) else (o,)


def _vjp_of_plain(fn, xs, gouts):
    """Cotangents of ``fn(*xs)``'s outputs ``gouts`` (None: a zero
    cotangent) pulled back to the floating tensors of ``xs`` (None for the
    others), by ``torch.func.vjp`` through the plain version: so the
    backward composes with an outer ``torch.func`` transform (``hvp`` is
    forward-over-reverse)."""
    f, idx = _on_floats(lambda *a: _as_tuple(fn(*a)), xs)
    outs, pull = torch.func.vjp(f, *[xs[i] for i in idx])
    gs = pull(tuple(torch.zeros_like(o) if g is None else g for o, g in zip(outs, gouts)))
    grads = [None] * len(xs)
    for i, g in zip(idx, gs):
        grads[i] = g
    return grads


def _zero_tangent(t, x):
    return torch.zeros_like(x) if t is None else t


def _vmap_by_loop(apply, info, in_dims, args):
    """A vmap rule by a loop over the mapped axis: ``apply`` once a slice,
    the outputs stacked on axis 0."""
    outs = [apply(*(a if d is None else a.select(d, b) for a, d in zip(args, in_dims)))
            for b in range(info.batch_size)]
    if isinstance(outs[0], tuple):
        return tuple(torch.stack(o) for o in zip(*outs)), (0,) * len(outs[0])
    return torch.stack(outs), 0


def _fold(x, d, size):
    """A vmapped [B, N, ...] operand (or an unmapped [N, ...] one, broadcast)
    as [B·N, ...]: the mapped axis folded into the kernel's batch."""
    x = x.movedim(d, 0) if d is not None else x.expand(size, *x.shape)
    return x.reshape(size * x.shape[1], *x.shape[2:])


class _FlashAttentionFn(torch.autograd.Function):
    """The ``flash_attention`` kernel forward; the plain version's
    derivatives, block by block of queries, for the backward (VJP) and
    forward mode (JVP); a vmap rule that folds the mapped axis into the
    kernel's batch.  So ``torch.func.jvp``, ``vjp``, ``grad`` and ``vmap``
    go through it, and each launches the kernel for the primal output."""

    @staticmethod
    def forward(q, k, v, q_positions, k_positions, kw):
        out = flash_attention_cuda(q.contiguous(), k.contiguous(), v.contiguous(),
                                   q_positions=q_positions, k_positions=k_positions, **kw)
        _LAUNCHES["flash_attention"] += 1
        return out

    @staticmethod
    def setup_context(ctx, inputs, output):
        q, k, v, qp, kp, kw = inputs
        ctx.save_for_backward(q, k, v, qp, kp)
        ctx.save_for_forward(q, k, v, qp, kp)
        ctx.kw = kw

    @staticmethod
    def _blocks(q, qp, kp, kw):
        """Each block of ``ATTN_GRAD_Q_CHUNK`` queries: (slice, the plain
        version of the block as a function of (q_block, k, v))."""
        t = q.shape[1]
        qp = qp if qp is not None else torch.arange(t, device=q.device)
        for lo in range(0, t, ATTN_GRAD_Q_CHUNK):
            sl = slice(lo, min(t, lo + ATTN_GRAD_Q_CHUNK))

            def block(qb, kb, vb, _qp=qp[sl]):
                return ref.flash_attention(qb, kb, vb, q_positions=_qp, k_positions=kp, **kw)

            yield sl, block

    @staticmethod
    @torch.profiler.record_function("flash_attention_backward")
    def backward(ctx, gout):
        q, k, v, qp, kp = ctx.saved_tensors
        dq, dk, dv = [], 0.0, 0.0
        for sl, block in _FlashAttentionFn._blocks(q, qp, kp, ctx.kw):
            gq, gk, gv = _vjp_of_plain(block, (q[:, sl], k, v), (gout[:, sl],))
            dq.append(gq)
            dk = dk + gk.float()
            dv = dv + gv.float()
        return torch.cat(dq, 1), dk.to(k.dtype), dv.to(v.dtype), None, None, None

    @staticmethod
    @torch.profiler.record_function("flash_attention_jvp")
    def jvp(ctx, dq, dk, dv, _dqp, _dkp, _dkw):
        q, k, v, qp, kp = ctx.saved_tensors
        dq, dk, dv = (_zero_tangent(t, x) for t, x in ((dq, q), (dk, k), (dv, v)))
        return torch.cat([torch.func.jvp(block, (q[:, sl], k, v), (dq[:, sl], dk, dv))[1]
                          for sl, block in _FlashAttentionFn._blocks(q, qp, kp, ctx.kw)], 1)

    @staticmethod
    def vmap(info, in_dims, q, k, v, q_positions, k_positions, kw):
        if in_dims[3] is not None or in_dims[4] is not None:  # positions a slice each
            return _vmap_by_loop(lambda *a: _FlashAttentionFn.apply(*a, kw), info,
                                 in_dims[:5], (q, k, v, q_positions, k_positions))
        b = info.batch_size
        out = _FlashAttentionFn.apply(_fold(q, in_dims[0], b), _fold(k, in_dims[1], b),
                                      _fold(v, in_dims[2], b), q_positions, k_positions, kw)
        return out.reshape(b, -1, *out.shape[1:]), 0


class _WkvFn(torch.autograd.Function):
    """The ``wkv`` kernel forward; the plain version's VJP (backward) and
    JVP (forward mode); a vmap rule that folds the mapped axis into the
    kernel's batch where ``u`` is shared (else a launch a slice)."""

    @staticmethod
    def forward(r, k, v, log_w, u, state0, chunk):
        out = wkv_cuda(r.contiguous(), k.contiguous(), v.contiguous(), log_w.contiguous(), u,
                       None if state0 is None else state0.contiguous(), chunk)
        _LAUNCHES["wkv"] += 1
        return out

    @staticmethod
    def setup_context(ctx, inputs, output):
        *xs, chunk = inputs
        ctx.save_for_backward(*xs)
        ctx.save_for_forward(*xs)
        ctx.chunk = chunk

    @staticmethod
    @torch.profiler.record_function("wkv_backward")
    def backward(ctx, gy, gstate):
        xs = ctx.saved_tensors

        def plain(r, k, v, log_w, u, state0):
            return ref.wkv(r, k, v, log_w, u, state0, ctx.chunk)

        return tuple(_vjp_of_plain(plain, xs, (gy, gstate))) + (None,)

    @staticmethod
    @torch.profiler.record_function("wkv_jvp")
    def jvp(ctx, *tangents):
        xs = ctx.saved_tensors
        f, idx = _on_floats(lambda *a: ref.wkv(*a, ctx.chunk), xs)
        return torch.func.jvp(f, tuple(xs[i] for i in idx),
                              tuple(_zero_tangent(tangents[i], xs[i]) for i in idx))[1]

    @staticmethod
    def vmap(info, in_dims, r, k, v, log_w, u, state0, chunk):
        if in_dims[4] is not None:  # a u a slice: the kernel shares one
            return _vmap_by_loop(lambda *a: _WkvFn.apply(*a, chunk), info, in_dims[:6],
                                 (r, k, v, log_w, u, state0))
        b = info.batch_size
        y, state = _WkvFn.apply(
            _fold(r, in_dims[0], b), _fold(k, in_dims[1], b), _fold(v, in_dims[2], b),
            _fold(log_w, in_dims[3], b), u,
            None if state0 is None else _fold(state0, in_dims[5], b), chunk)
        return (y.reshape(b, -1, *y.shape[1:]), state.reshape(b, -1, *state.shape[1:])), (0, 0)


def flash_attention(q, k, v, *, causal=True, window=None, q_positions=None,
                    k_positions=None, scale=None) -> torch.Tensor:
    """Causal, sliding-window GQA attention (``nn/functional.sdpa``): q
    [N, T, H, dh], k [N, S, KV, dh], v [N, S, KV, dv] → [N, T, H, dv] in q's
    dtype, with optional positions q_positions [T] / k_positions [S] (slots
    < 0 empty)."""
    obs.count("kernel.calls.flash_attention")
    kw = dict(causal=causal, window=window, scale=scale)
    xs = [x for x in (q, k, v, q_positions, k_positions) if x is not None]
    if not _on_card("flash_attention", *xs):
        return ref.flash_attention(q, k, v, q_positions=q_positions, k_positions=k_positions,
                                   **kw)
    return _FlashAttentionFn.apply(q, k, v, q_positions, k_positions, kw)


def wkv(r, k, v, log_w, u=None, state0=None, chunk=16):
    """The chunked WKV recurrence (``nn/functional.wkv_chunked`` with a
    ``chunk`` that divides T): r, k [N, T, H, dk], v [N, T, H, dv], log_w
    [N, T, H, dk or 1], u [H, dk] or None, state0 [N, H, dk, dv] or None →
    (y in r's dtype, state float32)."""
    obs.count("kernel.calls.wkv")
    xs = [x for x in (r, k, v, log_w, u, state0) if x is not None]
    if not _on_card("wkv", *xs):
        return ref.wkv(r, k, v, log_w, u, state0, chunk)
    return _WkvFn.apply(r, k, v, log_w, u, state0, chunk)
