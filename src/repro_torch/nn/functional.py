"""Parameter-free mixing primitives used inside ``Wired.wire`` functions.

Port of ``src/repro/nn/functional.py`` (RoPE, ``sdpa``, ``sdpa_chunked``,
``wkv_chunked``, ``wkv_step``, ``token_shift``, ``cache_update``).  JAX's dtype rules are kept: the mixing is
computed in float32 and returned in the input's dtype, masked logits are
−1e30, ``log_w`` is clipped to [−60, −1e−6].  ``sdpa`` and ``wkv_chunked`` go
through the kernel dispatch (:mod:`repro_torch.kernels.ops`): on the card the
hand-written ``flash_attention`` and ``wkv`` kernels (with a gradient where
autograd asks for one), on the CPU their plain versions.  A decode position ``pos`` is a Python int or a 0-dimensional
integer tensor on the activations' device.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import ops as kops
from repro_torch.kernels.ref import NEG_INF


# ---------------------------------------------------------------------------
# RoPE
# ---------------------------------------------------------------------------


def rope_freqs(dh, theta=10000.0, device=None):
    return theta ** (-torch.arange(0, dh, 2, dtype=torch.float32, device=device) / dh)


def apply_rope(x, positions, theta=10000.0):
    """x: [N, T, H, dh]; positions: [T] tensor, or a scalar (decode)."""
    dh = x.shape[-1]
    freqs = rope_freqs(dh, theta, x.device)  # [dh/2]
    pos = torch.as_tensor(positions, device=x.device).float()
    ang = pos[..., None] * freqs
    if ang.dim() == 1:       # scalar position (decode)
        ang = ang[None, None, None]      # [1, 1, 1, dh/2]
    else:                    # [T, dh/2]
        ang = ang[None, :, None]         # [1, T, 1, dh/2]
    cos, sin = torch.cos(ang), torch.sin(ang)
    x1, x2 = x[..., : dh // 2].float(), x[..., dh // 2:].float()
    r1 = x1 * cos - x2 * sin
    r2 = x2 * cos + x1 * sin
    return torch.cat([r1, r2], dim=-1).to(x.dtype)


# ---------------------------------------------------------------------------
# scaled dot-product attention (GQA, causal, sliding window)
# ---------------------------------------------------------------------------


def sdpa(q, k, v, *, causal=True, window=None, q_positions=None,
         k_positions=None, scale=None):
    """q, k: [N, T, H, dh], [N, S, KV, dh]; v: [N, S, KV, dv] → [N, T, H, dv]
    in q's dtype (dv = dh(v), which MLA sets apart from dh).

    ``*_positions``: absolute positions (default arange), used for masking
    with KV caches / rings (slots at −1 are empty).  The ``flash_attention``
    kernel on the card, its plain version on the CPU.
    """
    return kops.flash_attention(q, k, v, causal=causal, window=window,
                                q_positions=q_positions, k_positions=k_positions,
                                scale=scale)


def sdpa_chunked(q, k, v, *, causal=True, window=None, q_positions=None,
                 k_positions=None, scale=None, q_chunk=512, k_chunk=1024):
    """``sdpa`` in blocks of ``q_chunk`` queries and ``k_chunk`` keys, with
    an online softmax over the key blocks (JAX's flash-attention-style
    ``sdpa_chunked``): no [T, S] matrix of all pairs.  On the card it is the
    same ``flash_attention`` kernel as :func:`sdpa`, which never forms one
    either; on the CPU this loop (the chunks shrink to divisors of T and S,
    as in JAX)."""
    xs = [x for x in (q, k, v, q_positions, k_positions) if x is not None]
    if kops._on_card("flash_attention", *xs):
        return sdpa(q, k, v, causal=causal, window=window, q_positions=q_positions,
                    k_positions=k_positions, scale=scale)
    n, t, h, dh = q.shape
    s, kv = k.shape[1], k.shape[2]
    g, dv = h // kv, v.shape[-1]
    scale = scale if scale is not None else dh ** -0.5
    qp = q_positions if q_positions is not None else torch.arange(t, device=q.device)
    kp = k_positions if k_positions is not None else torch.arange(s, device=q.device)
    qp, kp = qp.long(), kp.long()
    cq = min(q_chunk, t)
    while t % cq:
        cq -= 1
    ck = min(k_chunk, s)
    while s % ck:
        ck -= 1
    outs = []
    for lo in range(0, t, cq):
        qi = q[:, lo:lo + cq].reshape(n, cq, kv, g, dh).float()
        qpos = qp[lo:lo + cq]
        m = torch.full((n, kv, g, cq), NEG_INF, dtype=torch.float32, device=q.device)
        l = torch.zeros((n, kv, g, cq), dtype=torch.float32, device=q.device)
        acc = torch.zeros((n, kv, g, cq, dv), dtype=torch.float32, device=q.device)
        for ko in range(0, s, ck):
            kpos = kp[ko:ko + ck]
            logits = torch.einsum("ntkgd,nskd->nkgts", qi, k[:, ko:ko + ck].float()) * scale
            mask = torch.ones((cq, ck), dtype=torch.bool, device=q.device)
            if causal:
                mask &= qpos[:, None] >= kpos[None, :]
            if window is not None:
                mask &= (qpos[:, None] - kpos[None, :]) < window
            mask &= kpos[None, :] >= 0
            logits = torch.where(mask, logits, torch.full_like(logits, NEG_INF))
            m_new = torch.maximum(m, logits.amax(-1))
            corr = torch.exp(m - m_new)
            p = torch.exp(logits - m_new[..., None])
            l = l * corr + p.sum(-1)
            acc = acc * corr[..., None] + torch.einsum("nkgts,nskd->nkgtd", p,
                                                       v[:, ko:ko + ck].float())
            m = m_new
        out = acc / l.clamp_min(1e-30)[..., None]          # [n, kv, g, cq, dv]
        outs.append(out.permute(0, 3, 1, 2, 4).reshape(n, cq, h, dv))
    return torch.cat(outs, dim=1).to(q.dtype)


# ---------------------------------------------------------------------------
# chunked linear-attention scans (RWKV6 "Finch" / Mamba-2 SSD)
# ---------------------------------------------------------------------------


def wkv_chunk(t, chunk=16):
    """The chunk ``wkv_chunked`` uses for T = t: ``chunk`` if it divides t,
    1 if t < chunk, else the largest divisor of t below it."""
    if t % chunk == 0:
        return chunk
    return 1 if t < chunk else next(c for c in range(chunk, 0, -1) if t % c == 0)


def wkv_chunked(r, k, v, log_w, u=None, state0=None, chunk=16):
    """RWKV6 recurrence, chunk-parallel:

        S_t = diag(w_t) S_{t-1} + k_t v_tᵀ ;   y_t = r_tᵀ S_{t-1} + (r·u·k)_t v_t

    r, k: [N, T, H, dk];  v: [N, T, H, dv];  log_w: [N, T, H, dk] or
    [N, T, H, 1] (≤ 0); u: [H, dk] bonus or None;  state0: [N, H, dk, dv]
    or None.  Returns (y [N, T, H, dv] in r's dtype, state [N, H, dk, dv]
    float32).  SSD/Mamba-2 is the special case of a scalar per-head decay
    with u=None.  The ``wkv`` kernel on the card, its plain version on the
    CPU.
    """
    return kops.wkv(r, k, v, log_w, u, state0, wkv_chunk(r.shape[1], chunk))


def wkv_step(r, k, v, log_w, u, state):
    """Single-token WKV step (decode). r,k: [N,H,dk]; v: [N,H,dv]."""
    rf, kf, vf = r.float(), k.float(), v.float()
    w = torch.exp(log_w.float().clamp(-60.0, -1e-6)).expand(kf.shape)
    y = torch.einsum("nhd,nhde->nhe", rf, state)
    if u is not None:
        y = y + torch.einsum("nhd,hd,nhd->nh", rf, u.float(), kf)[..., None] * vf
    state = w[..., None] * state + kf[..., None] * vf[..., None, :]
    return y.to(r.dtype), state


# ---------------------------------------------------------------------------
# token shift (RWKV)
# ---------------------------------------------------------------------------


def token_shift(x, last=None):
    """x_{t-1} (zeros / ``last`` for t = 0).  x: [N, T, D]."""
    if last is None:
        last = torch.zeros_like(x[:, :1])
    elif last.dim() == 2:
        last = last[:, None]
    return torch.cat([last, x[:, :-1]], dim=1)


# ---------------------------------------------------------------------------
# KV-cache helpers (decode)
# ---------------------------------------------------------------------------


def cache_update(cache_k, cache_v, pos_buf, k_new, v_new, pos, ring):
    """Insert one position into a (possibly ring) KV cache; returns new
    tensors, the given ones stay as they are (JAX's arrays are immutable).

    cache_k/v: [N, S, KV, dh]; pos_buf: [S] absolute positions (-1 = empty);
    k/v_new: [N, 1, KV, dh]; pos: the position; ring: a Python bool.
    """
    S = cache_k.shape[1]
    pos = torch.as_tensor(pos, device=cache_k.device).reshape(1)
    slot = (torch.remainder(pos, S) if ring else pos.clamp(max=S - 1)).long()
    cache_k = cache_k.index_copy(1, slot, k_new.to(cache_k.dtype))
    cache_v = cache_v.index_copy(1, slot, v_new.to(cache_v.dtype))
    pos_buf = pos_buf.index_copy(0, slot, pos.to(pos_buf.dtype))
    return cache_k, cache_v, pos_buf
