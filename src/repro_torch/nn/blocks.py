"""Decoder blocks as ``Wired`` modules.

Port of ``src/repro/nn/blocks.py``: ``AttnBlock`` (GQA attention with full or
partial RoPE, optional qkv biases, a GLU or plain feed-forward, RMSNorm or
LayerNorm), ``AttnMoEBlock`` (that attention with a routed mixture of
experts in place of the feed-forward), ``MLAMoEBlock`` (DeepSeek-V2's
multi-head latent attention, decoded over its compressed cache, with routed
and shared experts), ``RWKV6Block`` (token-shift time and
channel mixes around the WKV recurrence) and ``HymbaBlock`` (parallel
attention and SSD heads sharing one block), each with its full-sequence
``wire`` and its single-token ``wire_step`` against a KV cache (a ring of
``window`` slots in the sliding-window layers), MLA's latent cache, the SSD
or WKV state, and RWKV's shifted inputs.  One block = one decoder layer, so a layer stack is a
single homogeneous ``ScanStack``.

Every parameter lives in a Dense / BatchedDense / norm / Param child, in the
JAX layout.  Attention is ``functional.sdpa`` (``attn_impl="naive"``, the
JAX default) or ``functional.sdpa_chunked`` (``"chunked"``), both of which
the card runs in the ``flash_attention`` kernel; the SSD scan is
``functional.wkv_chunked``, which it runs in the ``wkv`` kernel.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as TF

from repro_torch.core.module import Dense, GroupRMSNorm, LayerNorm, RMSNorm
from repro_torch.nn import functional as F
from repro_torch.nn.layers import BatchedDense, Param
from repro_torch.nn.moe import moe_apply
from repro_torch.nn.wired import Wired


def _norm(kind, d, dtype, device):
    if kind == "rmsnorm":
        return RMSNorm(d, dtype=dtype, device=device)
    return LayerNorm(d, dtype=dtype, device=device)


def _gelu(x):
    return TF.gelu(x, approximate="tanh")  # jax.nn.gelu's default


def _act(name):
    return {"silu": TF.silu, "gelu": _gelu, "relu": TF.relu}[name]


# ---------------------------------------------------------------------------
# dense attention + (G)LU FFN decoder layer
# ---------------------------------------------------------------------------


class AttnBlock(Wired):
    def __init__(self, d, n_heads, kv_heads, d_ff, *, head_dim=None,
                 causal=True, window=None, norm="rmsnorm", act="silu",
                 glu=True, rope_theta=10000.0, rope_pct=1.0, qkv_bias=False,
                 attn_impl="naive", dtype=torch.float32, device="cuda",
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        if attn_impl not in ("naive", "chunked"):
            raise ValueError(f"attn_impl must be 'naive' or 'chunked', got {attn_impl!r}")
        self.h, self.kv = n_heads, kv_heads
        self.dh = dh = head_dim or d // n_heads
        self.causal, self.window = causal, window
        self.attn_impl = attn_impl
        self.act = _act(act)
        self.glu = glu
        self.rope_theta, self.rope_pct = rope_theta, rope_pct
        kw = dict(dtype=dtype, device=device, generator=generator)
        ch = {
            "ln1": _norm(norm, d, dtype, device),
            "wq": Dense(d, n_heads * dh, use_bias=qkv_bias, **kw),
            "wk": Dense(d, kv_heads * dh, use_bias=qkv_bias, **kw),
            "wv": Dense(d, kv_heads * dh, use_bias=qkv_bias, **kw),
            "wo": Dense(n_heads * dh, d, use_bias=False, **kw),
            "ln2": _norm(norm, d, dtype, device),
        }
        ch.update(self._ffn_children(d, d_ff, kw))
        self.set_children(ch)

    def _ffn_children(self, d, d_ff, kw):
        if self.glu:
            return {"w_gate": Dense(d, d_ff, use_bias=False, **kw),
                    "w_up": Dense(d, d_ff, use_bias=False, **kw),
                    "w_down": Dense(d_ff, d, use_bias=False, **kw)}
        return {"w_up": Dense(d, d_ff, use_bias=True, **kw),
                "w_down": Dense(d_ff, d, use_bias=True, **kw)}

    def _rope(self, x, positions):
        """RoPE on the first ``rot = ⌊dh·rope_pct⌋`` (rounded down to even)
        dims of each head, with the frequencies of a rot-wide head; the rest
        passes through."""
        if self.rope_pct >= 1.0:
            return F.apply_rope(x, positions, self.rope_theta)
        rot = int(self.dh * self.rope_pct)
        rot -= rot % 2
        return torch.cat([F.apply_rope(x[..., :rot], positions, self.rope_theta),
                          x[..., rot:]], dim=-1)

    def _attend(self, call, x, positions):
        n, t = x.shape[:2]
        q = call("wq", x).reshape(n, t, self.h, self.dh)
        k = call("wk", x).reshape(n, t, self.kv, self.dh)
        v = call("wv", x).reshape(n, t, self.kv, self.dh)
        return self._rope(q, positions), self._rope(k, positions), v

    def _ffn(self, call, x):
        h = call("ln2", x)
        if self.glu:
            y = self.act(call("w_gate", h)) * call("w_up", h)
        else:
            y = self.act(call("w_up", h))
        return x + call("w_down", y)

    def _sdpa(self, q, k, v):
        fn = F.sdpa_chunked if self.attn_impl == "chunked" else F.sdpa
        return fn(q, k, v, causal=self.causal, window=self.window)

    def wire(self, call, params, x):
        n, t = x.shape[:2]
        h = call("ln1", x)
        q, k, v = self._attend(call, h, torch.arange(t, device=x.device))
        a = self._sdpa(q, k, v)
        x = x + call("wo", a.reshape(n, t, self.h * self.dh))
        return self._ffn(call, x)

    # -- decode -----------------------------------------------------------------
    def init_cache(self, params, batch, max_len, dtype):
        S = max_len if self.window is None else min(self.window, max_len)
        device = params["wk"]["w"].device
        return {
            "k": torch.zeros((batch, S, self.kv, self.dh), dtype=dtype, device=device),
            "v": torch.zeros((batch, S, self.kv, self.dh), dtype=dtype, device=device),
            "pos": torch.full((S,), -1, dtype=torch.int32, device=device),
        }

    def _cached_attention(self, q, k, v, pos, cache):
        ck, cv, pbuf = F.cache_update(cache["k"], cache["v"], cache["pos"], k, v, pos,
                                      ring=self.window is not None)
        a = F.sdpa(q, ck, cv, causal=True, window=self.window,
                   q_positions=pos.reshape(1), k_positions=pbuf)
        return a, {"k": ck, "v": cv, "pos": pbuf}

    def wire_step(self, call, params, xp, cache):
        x, pos = xp  # x: [N, 1, d], pos: a 0-dimensional integer tensor
        n = x.shape[0]
        h = call("ln1", x)
        q, k, v = self._attend(call, h, pos)
        a, cache = self._cached_attention(q, k, v, pos, cache)
        x = x + call("wo", a.reshape(n, 1, self.h * self.dh))
        x = self._ffn(call, x)
        return (x, pos), cache


# ---------------------------------------------------------------------------
# MLA (DeepSeek-V2) attention + routed and shared experts
# ---------------------------------------------------------------------------


class MLAMoEBlock(Wired):
    """Port of ``src/repro/nn/blocks.py:161-285``: multi-head latent
    attention (``dq`` → q with RoPE on its last ``qk_rope`` dims; ``dkv`` →
    the latent ``c_kv`` [N, T, kv_lora] and one shared RoPE key ``k_pe``;
    ``uk`` / ``uv`` lift ``c_kv`` to the heads' keys and values of width
    ``v_dim``) and a routed mixture of experts plus ``n_shared`` experts
    folded into one SiLU GLU of width ``d_expert · n_shared``.

    Decode keeps only the compressed cache (``ckv``, ``kpe``: kv_lora +
    qk_rope floats a token) and absorbs ``uk`` into the query and ``uv``
    into the context, in float32, reading their weights outside a ``call``
    as JAX does; BackPACK never records the decode path.  The cache is not
    a ring: a position past its end overwrites the last slot."""

    def __init__(self, d, n_heads, d_expert, n_experts, top_k, *, kv_lora=512,
                 qk_nope=128, qk_rope=64, v_dim=128, n_shared=2, capacity_factor=1.25,
                 rope_theta=10000.0, act="silu", dtype=torch.float32, device="cuda",
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.h = n_heads
        self.kv_lora, self.nope, self.rh, self.dv = kv_lora, qk_nope, qk_rope, v_dim
        self.E, self.k_top, self.cf = n_experts, top_k, capacity_factor
        self.n_shared = n_shared
        self.rope_theta = rope_theta
        self.act = _act(act)
        kw = dict(dtype=dtype, device=device, generator=generator)
        ch = {
            "ln1": RMSNorm(d, dtype=dtype, device=device),
            "dq": Dense(d, n_heads * (qk_nope + qk_rope), use_bias=False, **kw),
            "dkv": Dense(d, kv_lora + qk_rope, use_bias=False, **kw),
            "uk": Dense(kv_lora, n_heads * qk_nope, use_bias=False, **kw),
            "uv": Dense(kv_lora, n_heads * v_dim, use_bias=False, **kw),
            "wo": Dense(n_heads * v_dim, d, use_bias=False, **kw),
            "ln2": RMSNorm(d, dtype=dtype, device=device),
            "router": Dense(d, n_experts, use_bias=False, **kw),
            "e_gate": BatchedDense(n_experts, d, d_expert, **kw),
            "e_up": BatchedDense(n_experts, d, d_expert, **kw),
            "e_down": BatchedDense(n_experts, d_expert, d, **kw),
        }
        if n_shared:
            sd = d_expert * n_shared
            ch.update({"s_gate": Dense(d, sd, use_bias=False, **kw),
                       "s_up": Dense(d, sd, use_bias=False, **kw),
                       "s_down": Dense(sd, d, use_bias=False, **kw)})
        self.set_children(ch)

    def _mla_qkv(self, call, h, positions):
        n, t = h.shape[:2]
        q = call("dq", h).reshape(n, t, self.h, self.nope + self.rh)
        q_nope, q_pe = q[..., : self.nope], q[..., self.nope:]
        q_pe = F.apply_rope(q_pe, positions, self.rope_theta)
        ckv_full = call("dkv", h)
        c_kv, k_pe = ckv_full[..., : self.kv_lora], ckv_full[..., self.kv_lora:]
        k_pe = F.apply_rope(k_pe[:, :, None, :], positions, self.rope_theta)
        return q_nope, q_pe, c_kv, k_pe  # k_pe: [N, T, 1, rh]

    def _mla_attend(self, call, q_nope, q_pe, c_kv, k_pe):
        n, t = q_nope.shape[:2]
        k_nope = call("uk", c_kv).reshape(n, -1, self.h, self.nope)
        v = call("uv", c_kv).reshape(n, -1, self.h, self.dv)
        k_pe = k_pe.expand(-1, -1, self.h, -1)
        q = torch.cat([q_nope, q_pe], dim=-1)
        k = torch.cat([k_nope, k_pe], dim=-1)
        a = F.sdpa(q, k, v, causal=True, scale=(self.nope + self.rh) ** -0.5)
        return call("wo", a.reshape(n, t, self.h * self.dv))

    def _moe_ffn(self, call, x):
        h = call("ln2", x)
        logits = call("router", h)
        y = moe_apply(call, h, logits, self.E, self.k_top, self.cf, self.act)
        if self.n_shared:
            y = y + call("s_down", self.act(call("s_gate", h)) * call("s_up", h))
        return x + y

    def wire(self, call, params, x):
        h = call("ln1", x)
        q_nope, q_pe, c_kv, k_pe = self._mla_qkv(
            call, h, torch.arange(x.shape[1], device=x.device))
        x = x + self._mla_attend(call, q_nope, q_pe, c_kv, k_pe)
        return self._moe_ffn(call, x)

    # -- decode: absorbed MLA over the compressed cache ---------------------------
    def init_cache(self, params, batch, max_len, dtype):
        device = params["dkv"]["w"].device
        return {
            "ckv": torch.zeros((batch, max_len, self.kv_lora), dtype=dtype, device=device),
            "kpe": torch.zeros((batch, max_len, self.rh), dtype=dtype, device=device),
            "pos": torch.full((max_len,), -1, dtype=torch.int32, device=device),
        }

    def wire_step(self, call, params, xp, cache):
        x, pos = xp  # x: [N, 1, d], pos: a 0-dimensional integer tensor
        n = x.shape[0]
        h = call("ln1", x)
        q_nope, q_pe, c_kv, k_pe = self._mla_qkv(call, h, pos)
        S = cache["ckv"].shape[1]
        pos1 = torch.as_tensor(pos, device=x.device).reshape(1)
        slot = pos1.clamp(max=S - 1).long()
        ckv = cache["ckv"].index_copy(1, slot, c_kv.to(cache["ckv"].dtype))
        kpe = cache["kpe"].index_copy(1, slot, k_pe[:, :, 0].to(cache["kpe"].dtype))
        pbuf = cache["pos"].index_copy(0, slot, pos1.to(torch.int32))
        # absorb W_UK into the query:  score = q_nopeᵀ W_UK c_kv + q_peᵀ k_pe
        f32 = torch.float32
        wuk = params["uk"]["w"].reshape(self.kv_lora, self.h, self.nope).to(f32)
        q_lat = torch.einsum("nthd,lhd->nthl", q_nope.to(f32), wuk)  # [N, 1, H, kv_lora]
        scale = (self.nope + self.rh) ** -0.5
        ckv32 = ckv.to(f32)
        logits = (torch.einsum("nthl,nsl->nhts", q_lat, ckv32)
                  + torch.einsum("nthr,nsr->nhts", q_pe.to(f32), kpe.to(f32))) * scale
        mask = (pbuf >= 0) & (pbuf <= pos1)  # [S]
        logits = torch.where(mask, logits, torch.full_like(logits, F.NEG_INF))
        p = torch.softmax(logits, dim=-1)
        ctx = torch.einsum("nhts,nsl->nthl", p, ckv32)
        wuv = params["uv"]["w"].reshape(self.kv_lora, self.h, self.dv).to(f32)
        a = torch.einsum("nthl,lhv->nthv", ctx, wuv)
        x = x + call("wo", a.reshape(n, 1, self.h * self.dv).to(x.dtype))
        x = self._moe_ffn(call, x)
        return (x, pos), {"ckv": ckv, "kpe": kpe, "pos": pbuf}


# ---------------------------------------------------------------------------
# GQA attention + routed mixture-of-experts FFN (Granite)
# ---------------------------------------------------------------------------


class AttnMoEBlock(AttnBlock):
    """Port of ``src/repro/nn/blocks.py:292-322``: ``AttnBlock``'s attention
    (RMSNorm, SiLU, full RoPE, no window) with the FFN replaced by ``ln2`` →
    ``router`` → :func:`~repro_torch.nn.moe.moe_apply` over the experts
    ``e_gate``, ``e_up`` and ``e_down`` (``BatchedDense``).  The children
    are JAX's after its ``pop``s: no dense FFN is drawn.  Decode is
    ``AttnBlock.wire_step``, the capacity counted for the step's tokens."""

    def __init__(self, d, n_heads, kv_heads, d_expert, n_experts, top_k, *,
                 capacity_factor=1.25, act="silu", rope_theta=10000.0,
                 dtype=torch.float32, head_dim=None, device="cuda",
                 generator: Optional[torch.Generator] = None):
        self.E, self.k_top, self.cf = n_experts, top_k, capacity_factor
        self.d_expert = d_expert
        super().__init__(d, n_heads, kv_heads, 4 * d, head_dim=head_dim, act=act,
                         rope_theta=rope_theta, dtype=dtype, device=device,
                         generator=generator)

    def _ffn_children(self, d, d_ff, kw):
        return {"router": Dense(d, self.E, use_bias=False, **kw),
                "e_gate": BatchedDense(self.E, d, self.d_expert, **kw),
                "e_up": BatchedDense(self.E, d, self.d_expert, **kw),
                "e_down": BatchedDense(self.E, self.d_expert, d, **kw)}

    def _ffn(self, call, x):
        h = call("ln2", x)
        logits = call("router", h)
        return x + moe_apply(call, h, logits, self.E, self.k_top, self.cf, self.act)


# ---------------------------------------------------------------------------
# RWKV6 "Finch": token-shift time mix (data-dependent decay) + channel mix
# ---------------------------------------------------------------------------


class RWKV6Block(Wired):
    """Port of ``src/repro/nn/blocks.py:325-412``: the time mix lerps each
    input with its token-shifted predecessor (``mu_*``), runs the WKV
    recurrence with a per-channel decay ``−exp(w0 + w2(tanh(w1(·))))`` and
    the bonus ``u`` (``functional.wkv_chunked``: the ``wkv`` kernel on the
    card), normalizes per head (``GroupRMSNorm``) and gates it; the channel
    mix is a squared-ReLU MLP gated by a sigmoid.  Decode carries the last
    normalized inputs of both mixes and the WKV state."""

    def __init__(self, d, d_ff, *, head_dim=64, decay_lora=64, wkv_chunk=16,
                 dtype=torch.float32, device="cuda",
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.d, self.dh = d, head_dim
        self.h = d // head_dim
        self.wkv_chunk = wkv_chunk
        kw = dict(use_bias=False, dtype=dtype, device=device, generator=generator)

        def mu():
            return Param((d,), init=0.5, dtype=dtype, device=device)

        self.set_children({
            "ln1": RMSNorm(d, dtype=dtype, device=device),
            "ln2": RMSNorm(d, dtype=dtype, device=device),
            "mu_r": mu(), "mu_k": mu(), "mu_v": mu(), "mu_g": mu(), "mu_w": mu(),
            "w1": Dense(d, decay_lora, **kw),
            "w2": Dense(decay_lora, d, **kw),
            "w0": Param((d,), init=-4.0, dtype=dtype, device=device),
            "u": Param((self.h, head_dim), init=0.0, dtype=dtype, device=device),
            "wr": Dense(d, d, **kw),
            "wk": Dense(d, d, **kw),
            "wv": Dense(d, d, **kw),
            "wg": Dense(d, d, **kw),
            "ln_x": GroupRMSNorm(d, self.h, dtype=dtype, device=device),
            "wo": Dense(d, d, **kw),
            "cmu_r": mu(), "cmu_k": mu(),
            "cwr": Dense(d, d, **kw),
            "cwk": Dense(d, d_ff, **kw),
            "cwv": Dense(d_ff, d, **kw),
        })

    def _time_mix(self, call, h, shifted, state0=None):
        n, t, d = h.shape

        def lerp(mu):
            return h + (shifted - h) * call(mu, None)

        r = call("wr", lerp("mu_r")).reshape(n, t, self.h, self.dh)
        k = call("wk", lerp("mu_k")).reshape(n, t, self.h, self.dh)
        v = call("wv", lerp("mu_v")).reshape(n, t, self.h, self.dh)
        g = TF.silu(call("wg", lerp("mu_g")))
        raw = call("w0", None) + call("w2", torch.tanh(call("w1", lerp("mu_w"))))
        log_w = -torch.exp(raw.float()).reshape(n, t, self.h, self.dh)
        y, state = F.wkv_chunked(r, k, v, log_w, u=call("u", None), state0=state0,
                                 chunk=self.wkv_chunk)
        y = call("ln_x", y.reshape(n, t, d)) * g
        return call("wo", y), state

    def _chan_mix(self, call, h, shifted):
        def lerp(mu):
            return h + (shifted - h) * call(mu, None)

        rc = torch.sigmoid(call("cwr", lerp("cmu_r")))
        kc = torch.square(TF.relu(call("cwk", lerp("cmu_k"))))
        return rc * call("cwv", kc)

    def wire(self, call, params, x):
        h = call("ln1", x)
        y, _ = self._time_mix(call, h, F.token_shift(h))
        x = x + y
        h2 = call("ln2", x)
        return x + self._chan_mix(call, h2, F.token_shift(h2))

    def init_cache(self, params, batch, max_len, dtype):
        device = params["wr"]["w"].device
        return {
            "x_time": torch.zeros((batch, 1, self.d), dtype=dtype, device=device),
            "x_chan": torch.zeros((batch, 1, self.d), dtype=dtype, device=device),
            "state": torch.zeros((batch, self.h, self.dh, self.dh), dtype=torch.float32,
                                 device=device),
        }

    def wire_step(self, call, params, xp, cache):
        x, pos = xp  # [N, 1, d]
        h = call("ln1", x)
        y, state = self._time_mix(call, h, cache["x_time"].to(h.dtype), state0=cache["state"])
        x = x + y
        h2 = call("ln2", x)
        x = x + self._chan_mix(call, h2, cache["x_chan"].to(h2.dtype))
        return (x, pos), {"x_time": h.to(cache["x_time"].dtype),
                          "x_chan": h2.to(cache["x_chan"].dtype), "state": state}


# ---------------------------------------------------------------------------
# Hymba: parallel attention + SSD heads sharing one block
# ---------------------------------------------------------------------------


class HymbaBlock(AttnBlock):
    def __init__(self, d, n_heads, kv_heads, d_ff, *, head_dim=None,
                 ssm_state=16, window=None, act="silu", rope_theta=10000.0,
                 attn_impl="naive", dtype=torch.float32, device="cuda",
                 generator: Optional[torch.Generator] = None):
        super().__init__(d, n_heads, kv_heads, d_ff, head_dim=head_dim,
                         window=window, act=act, rope_theta=rope_theta,
                         attn_impl=attn_impl, dtype=dtype, device=device,
                         generator=generator)
        self.ds = ssm_state
        kw = dict(use_bias=False, dtype=dtype, device=device, generator=generator)
        self.children_map.update({
            "w_xs": Dense(d, self.h * self.dh, **kw),
            "w_B": Dense(d, self.h * self.ds, **kw),
            "w_C": Dense(d, self.h * self.ds, **kw),
            "w_dt": Dense(d, self.h, use_bias=True, dtype=dtype, device=device,
                          generator=generator),
            "a_log": Param((self.h,), init=0.0, dtype=torch.float32, device=device),
            "norm_attn": RMSNorm(self.h * self.dh, dtype=dtype, device=device),
            "norm_ssm": RMSNorm(self.h * self.dh, dtype=dtype, device=device),
        })

    def _ssd(self, call, h, state0=None):
        n, t = h.shape[:2]
        xs = call("w_xs", h).reshape(n, t, self.h, self.dh)
        B = call("w_B", h).reshape(n, t, self.h, self.ds)
        C = call("w_C", h).reshape(n, t, self.h, self.ds)
        dt = TF.softplus(call("w_dt", h).float())
        log_a = (-dt * torch.exp(call("a_log", None)))[..., None]  # [N,T,H,1]
        y, state = F.wkv_chunked(C, B, xs, log_a, u=None, state0=state0)
        return y.reshape(n, t, self.h * self.dh), state

    def wire(self, call, params, x):
        n, t = x.shape[:2]
        h = call("ln1", x)
        q, k, v = self._attend(call, h, torch.arange(t, device=x.device))
        ao = self._sdpa(q, k, v).reshape(n, t, self.h * self.dh)
        so, _ = self._ssd(call, h)
        y = 0.5 * (call("norm_attn", ao) + call("norm_ssm", so))
        x = x + call("wo", y)
        return self._ffn(call, x)

    def init_cache(self, params, batch, max_len, dtype):
        c = super().init_cache(params, batch, max_len, dtype)
        c["ssm"] = torch.zeros((batch, self.h, self.ds, self.dh), dtype=torch.float32,
                               device=c["k"].device)
        return c

    def wire_step(self, call, params, xp, cache):
        x, pos = xp
        n = x.shape[0]
        h = call("ln1", x)
        q, k, v = self._attend(call, h, pos)
        ao, kv_cache = self._cached_attention(q, k, v, pos, cache)
        ao = ao.reshape(n, 1, self.h * self.dh)
        so, sstate = self._ssd(call, h, state0=cache["ssm"])
        y = 0.5 * (call("norm_attn", ao) + call("norm_ssm", so))
        x = x + call("wo", y)
        x = self._ffn(call, x)
        return (x, pos), dict(kv_cache, ssm=sstate)


# ---------------------------------------------------------------------------
# Whisper encoder / decoder blocks
# ---------------------------------------------------------------------------


class EncBlock(AttnBlock):
    """Whisper's encoder layer (``src/repro/nn/blocks.py:492``): a
    non-causal ``AttnBlock`` with LayerNorm, qkv biases and a plain GELU
    feed-forward.  It keeps ``AttnBlock``'s RoPE on q and k, as JAX's does."""

    def __init__(self, d, n_heads, d_ff, dtype=torch.float32, device="cuda",
                 generator: Optional[torch.Generator] = None):
        super().__init__(d, n_heads, n_heads, d_ff, causal=False, norm="layernorm",
                         act="gelu", glu=False, qkv_bias=True, dtype=dtype, device=device,
                         generator=generator)


class DecBlock(Wired):
    """Whisper's decoder layer (``src/repro/nn/blocks.py:499-576``).  Input
    and output: the tuple (y [N, Td, d], enc [N, S, d]); enc passes through
    unchanged and is read by the cross-attention's ``ck`` / ``cv``, so its
    cotangent sums the pass-through and those reads.  Decode carries the
    self-attention's KV cache and the cross K/V that
    ``WhisperModel.init_serve_cache`` fills from the encoder output."""

    def __init__(self, d, n_heads, d_ff, dtype=torch.float32, device="cuda",
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.d, self.h = d, n_heads
        self.dh = d // n_heads
        kw = dict(dtype=dtype, device=device, generator=generator)

        def dense(bias=True):
            return Dense(d, d, use_bias=bias, **kw)

        self.set_children({
            "ln1": LayerNorm(d, dtype=dtype, device=device),
            "wq": dense(), "wk": dense(bias=False), "wv": dense(), "wo": dense(),
            "lnx": LayerNorm(d, dtype=dtype, device=device),
            "cq": dense(), "ck": dense(bias=False), "cv": dense(), "co": dense(),
            "ln2": LayerNorm(d, dtype=dtype, device=device),
            "w1": Dense(d, d_ff, use_bias=True, **kw),
            "w2": Dense(d_ff, d, use_bias=True, **kw),
        })

    def _heads(self, x):
        n, t = x.shape[:2]
        return x.reshape(n, t, self.h, self.dh)

    def wire(self, call, params, x):
        y, enc = x
        n, t = y.shape[:2]
        h = call("ln1", y)
        a = F.sdpa(self._heads(call("wq", h)), self._heads(call("wk", h)),
                   self._heads(call("wv", h)), causal=True)
        y = y + call("wo", a.reshape(n, t, self.d))
        h = call("lnx", y)
        c = F.sdpa(self._heads(call("cq", h)), self._heads(call("ck", enc)),
                   self._heads(call("cv", enc)), causal=False)
        y = y + call("co", c.reshape(n, t, self.d))
        h = call("ln2", y)
        y = y + call("w2", _gelu(call("w1", h)))
        return (y, enc)

    def init_cache(self, params, batch, max_len, dtype):
        device = params["wq"]["w"].device
        return {
            "k": torch.zeros((batch, max_len, self.h, self.dh), dtype=dtype, device=device),
            "v": torch.zeros((batch, max_len, self.h, self.dh), dtype=dtype, device=device),
            "pos": torch.full((max_len,), -1, dtype=torch.int32, device=device),
            # cross K/V, filled from the encoder output
            "ck": None,
            "cv": None,
        }

    def cross_kv(self, params, enc):
        """The cross-attention's K and V [N, S, H, dh] of the encoder output."""
        def call(name):
            return self.children_map[name].call(params[name], enc)

        return self._heads(call("ck")), self._heads(call("cv"))

    def wire_step(self, call, params, xp, cache):
        y, pos = xp  # y: [N, 1, d], pos: a 0-dimensional integer tensor
        n = y.shape[0]
        h = call("ln1", y)
        ck_, cv_, pbuf = F.cache_update(cache["k"], cache["v"], cache["pos"],
                                        self._heads(call("wk", h)), self._heads(call("wv", h)),
                                        pos, ring=False)
        a = F.sdpa(self._heads(call("wq", h)), ck_, cv_, causal=True,
                   q_positions=pos.reshape(1), k_positions=pbuf)
        y = y + call("wo", a.reshape(n, 1, self.d))
        h = call("lnx", y)
        c = F.sdpa(self._heads(call("cq", h)), cache["ck"], cache["cv"], causal=False)
        y = y + call("co", c.reshape(n, 1, self.d))
        h = call("ln2", y)
        y = y + call("w2", _gelu(call("w1", h)))
        return (y, pos), {"k": ck_, "v": cv_, "pos": pbuf, "ck": cache["ck"], "cv": cache["cv"]}
