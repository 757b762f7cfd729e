"""Model assemblies: ``CausalLM``, ``WhisperModel`` and ``build_model`` for
the language-model zoo.

Port of ``src/repro/nn/models.py`` (``sinusoid_pos``, ``TokenEmbed``,
``CausalLM``, ``WhisperModel``, ``_expand_segments``, ``make_stacks``,
``build_model``).  The same module tree serves the full-sequence forward
(``call``, the prefill step) and decode (``serve_step`` with per-block
caches) and BackPACK's ``run``.  Every kind of the JAX package is built:
dense, Hymba, RWKV6, encoder-decoder and the two mixtures of experts, GQA
(``moe_gqa``) and DeepSeek-V2's MLA with shared experts (``moe_mla``).
"""
from __future__ import annotations

import math
from typing import List, Optional

import torch

from repro_torch.core.module import (
    Dense,
    Embedding,
    LayerNorm,
    Module,
    RMSNorm,
    ScanStack,
    Sequential,
)
from repro_torch.core.module import _layer
from repro_torch.nn.blocks import (
    AttnBlock,
    AttnMoEBlock,
    DecBlock,
    EncBlock,
    HymbaBlock,
    MLAMoEBlock,
    RWKV6Block,
)
from repro_torch.nn.layers import Param
from repro_torch.nn.wired import Wired

def sinusoid_pos(t, d, dtype=torch.float32, device=None):
    """The [t, d] sinusoidal positions (sin at even, cos at odd columns),
    computed in float32 and cast to ``dtype``."""
    pos = torch.arange(t, dtype=torch.float32, device=device)[:, None]
    div = torch.exp(torch.arange(0, d, 2, dtype=torch.float32, device=device)
                    * (-math.log(10000.0) / d))
    pe = torch.zeros((t, d), dtype=torch.float32, device=device)
    pe[:, 0::2] = torch.sin(pos * div)
    pe[:, 1::2] = torch.cos(pos * div)
    return pe.to(dtype)


class PrefixEmbed(Wired):
    """VLM frontend stub: precomputed prefix embeddings concatenated before
    the token embeddings.  x: {'tokens': [N, Tt] int, 'prefix': [N, P, d]
    float} → [N, P + Tt, d].  Decode embeds tokens alone
    (:meth:`embed_tokens`)."""

    def __init__(self, vocab, d, dtype=torch.float32, device="cuda", generator=None):
        super().__init__()
        self.set_children({"emb": Embedding(vocab, d, dtype=dtype, device=device,
                                            generator=generator)})

    def wire(self, call, params, x):
        toks = call("emb", x["tokens"])
        return torch.cat([x["prefix"].to(toks.dtype), toks], dim=1)

    def embed_tokens(self, params, tokens):
        return self.children_map["emb"].call(params["emb"], tokens)


class TokenEmbed(Wired):
    def __init__(self, vocab, d, dtype=torch.float32, device="cuda", generator=None):
        super().__init__()
        self.set_children({"emb": Embedding(vocab, d, dtype=dtype, device=device,
                                            generator=generator)})

    def wire(self, call, params, x):
        return call("emb", x)

    def embed_tokens(self, params, tokens):
        return self.children_map["emb"].call(params["emb"], tokens)


class CausalLM(Sequential):
    """[embed, *stacks, norm, head] with a single-token decode path."""

    def __init__(self, embed, stacks: List[Module], norm, head):
        super().__init__([embed] + stacks + [norm, head])
        self.n_stacks = len(stacks)

    @property
    def stacks(self):
        return self.mods[1: 1 + self.n_stacks]

    def init_serve_cache(self, params, batch, max_len, dtype):
        return tuple(
            s.init_cache(p, batch, max_len, dtype)
            for s, p in zip(self.stacks, params[1: 1 + self.n_stacks])
        )

    def serve_step(self, params, caches, tokens, pos):
        """tokens: [N] int; pos: int or 0-dimensional tensor → (logits [N,V],
        caches)."""
        emb = self.mods[0]
        pos = torch.as_tensor(pos, dtype=torch.int32, device=tokens.device)
        h = emb.embed_tokens(params[0], tokens[:, None])
        x = (h, pos)
        new_caches = []
        for i, stack in enumerate(self.stacks):
            x, c = stack.decode_step(params[1 + i], x, caches[i])
            new_caches.append(c)
        h = self.mods[-2].call(params[-2], x[0])
        logits = self.mods[-1].call(params[-1], h)
        return logits[:, 0], tuple(new_caches)


class WhisperModel(Wired):
    """Encoder-decoder; the audio frontend is a stub that feeds precomputed
    frame embeddings.  x: {'frames': [N, S, d], 'tokens': [N, Td] int} →
    logits [N, Td, V].  The encoder is a ``ScanStack`` of ``EncBlock``s, the
    decoder one of ``DecBlock``s carrying (y, enc); their sweeps run inside
    this module's through ``Wired``'s opaque children.  The head is not tied
    to the embedding."""

    def __init__(self, vocab, d, n_heads, d_ff, enc_layers, dec_layers, max_dec=448,
                 dtype=torch.float32, device="cuda", generator: Optional[torch.Generator] = None):
        super().__init__()
        self.d, self.max_dec = d, max_dec

        def enc_block(dev):
            return EncBlock(d, n_heads, d_ff, dtype=dtype, device=dev, generator=generator)

        def dec_block(dev):
            return DecBlock(d, n_heads, d_ff, dtype=dtype, device=dev, generator=generator)

        self.set_children({
            "emb": Embedding(vocab, d, dtype=dtype, device=device, generator=generator),
            "pos_dec": Param((max_dec, d), scale=0.01, dtype=dtype, device=device,
                             generator=generator),
            "enc": ScanStack(enc_block, enc_layers, device=device),
            "ln_post": LayerNorm(d, dtype=dtype, device=device),
            "dec": ScanStack(dec_block, dec_layers, device=device),
            "ln_f": LayerNorm(d, dtype=dtype, device=device),
            "head": Dense(d, vocab, use_bias=False, dtype=dtype, device=device,
                          generator=generator),
        })

    def _positions(self, frames):
        return frames + sinusoid_pos(frames.shape[1], self.d, frames.dtype, frames.device)[None]

    def wire(self, call, params, x):
        frames, tokens = x["frames"], x["tokens"]
        td = tokens.shape[1]
        e = call("enc", self._positions(frames))
        e = call("ln_post", e)
        t = call("emb", tokens) + call("pos_dec", None)[:td][None]
        y, _ = call("dec", (t, e))
        y = call("ln_f", y)
        return call("head", y)

    # -- serving -----------------------------------------------------------------
    def encode(self, params, frames):
        """The encoder output [N, S, d] of the frames."""
        e = self.children_map["enc"].call(params["enc"], self._positions(frames))
        return self.children_map["ln_post"].call(params["ln_post"], e)

    def init_serve_cache(self, params, batch, max_len, dtype, enc_out=None):
        """The decoder's caches, ``max_dec`` slots a layer (``max_len`` is
        ignored, as in JAX); with ``enc_out`` each layer's cross K/V filled
        from it, in its dtype."""
        dec = self.children_map["dec"]
        caches = dec.init_cache(params["dec"], batch, self.max_dec, dtype)
        if enc_out is not None:
            ks, vs = zip(*(dec.block.cross_kv(_layer(params["dec"], i), enc_out)
                           for i in range(dec.L)))
            caches = dict(caches, ck=torch.stack(ks), cv=torch.stack(vs))
        return caches

    def serve_step(self, params, caches, tokens, pos):
        """tokens: [N] int; pos: int or 0-dimensional tensor → (logits [N, V],
        caches).  Positions past ``max_dec`` reuse its last row of
        ``pos_dec``."""
        pos = torch.as_tensor(pos, dtype=torch.int32, device=tokens.device)
        h = self.children_map["emb"].call(params["emb"], tokens[:, None])
        row = torch.clamp(pos, max=self.max_dec - 1).reshape(1).long()
        h = h + params["pos_dec"]["v"].index_select(0, row)[None]
        x, caches = self.children_map["dec"].decode_step(params["dec"], (h, pos), caches)
        y = self.children_map["ln_f"].call(params["ln_f"], x[0])
        logits = self.children_map["head"].call(params["head"], y)
        return logits[:, 0], caches


def _expand_segments(cfg):
    """cfg.window_segments: list[(window_or_None, count)], cfg.pattern_repeat."""
    segs = cfg.window_segments or [(None, cfg.n_layers)]
    repeat = cfg.pattern_repeat or 1
    total = sum(c for _, c in segs) * repeat
    if total != cfg.n_layers:
        raise ValueError(f"{cfg.name}: the window segments give {total} layers, "
                         f"not {cfg.n_layers}")
    return segs, repeat


def make_stacks(mk_block, segments, repeat, device="cuda", remat=False):
    """``mk_block(window, device)`` builds one block; a segment of c > 1
    blocks is a ``ScanStack``, the segments of one pattern a ``Sequential``,
    and a pattern repeated r > 1 times a ``ScanStack`` of the pattern.
    ``remat`` goes to each segment's stack, and to the repeat's stack only
    when the pattern is one segment (as JAX's ``make_stacks``: a pattern of
    several segments recomputes inside them)."""
    def unit(dev):
        segs = [ScanStack(lambda d, w=w: mk_block(w, d), c, device=dev, remat=remat) if c > 1
                else mk_block(w, dev) for (w, c) in segments]
        return Sequential(segs) if len(segs) > 1 else segs[0]

    if repeat > 1:
        return [ScanStack(unit, repeat, device=device,
                          remat=remat and len(segments) == 1)]
    return [unit(device)]


def build_model(cfg, remat=False, attn_impl="naive", wkv_chunk=16, device="cuda",
                generator: Optional[torch.Generator] = None):
    """The root module of ``cfg`` on ``device`` (the card unless the caller
    asks for the CPU), in ``cfg.dtype``, with weights drawn from
    ``generator`` (a CPU ``torch.Generator``).  ``remat`` recomputes each
    stacked layer's forward in the backward pass of ``call``
    (:class:`~repro_torch.core.module.ScanStack`).  JAX's ``seq_constraint``
    comes with the sharded lane (ROADMAP queue A item 12).  ``wkv_chunk`` is
    RWKV6's scan chunk (Hymba scans with chunks of 16)."""
    dtype = getattr(torch, cfg.dtype)
    d = cfg.d_model
    if cfg.kind == "encdec":  # no remat, as in JAX; max_dec stays 448
        return WhisperModel(cfg.vocab, d, cfg.n_heads, cfg.d_ff, cfg.enc_layers,
                            cfg.dec_layers, dtype=dtype, device=device, generator=generator)

    def mk(w, dev):
        if cfg.kind == "rwkv":
            return RWKV6Block(d, cfg.d_ff, head_dim=cfg.head_dim or 64, wkv_chunk=wkv_chunk,
                              dtype=dtype, device=dev, generator=generator)
        if cfg.kind == "hymba":
            return HymbaBlock(d, cfg.n_heads, cfg.kv_heads, cfg.d_ff, head_dim=cfg.head_dim,
                              ssm_state=cfg.ssm_state, window=w, act=cfg.act,
                              attn_impl=attn_impl, rope_theta=cfg.rope_theta, dtype=dtype,
                              device=dev, generator=generator)
        if cfg.kind == "moe_mla":
            return MLAMoEBlock(d, cfg.n_heads, cfg.d_expert, cfg.n_experts, cfg.top_k,
                               kv_lora=cfg.kv_lora, qk_nope=cfg.qk_nope, qk_rope=cfg.qk_rope,
                               v_dim=cfg.v_head_dim, n_shared=cfg.n_shared_experts,
                               capacity_factor=cfg.capacity_factor, rope_theta=cfg.rope_theta,
                               act=cfg.act, dtype=dtype, device=dev, generator=generator)
        if cfg.kind == "moe_gqa":  # window, norm and attn_impl are not passed, as in JAX
            return AttnMoEBlock(d, cfg.n_heads, cfg.kv_heads, cfg.d_expert, cfg.n_experts,
                                cfg.top_k, capacity_factor=cfg.capacity_factor, act=cfg.act,
                                rope_theta=cfg.rope_theta, dtype=dtype, head_dim=cfg.head_dim,
                                device=dev, generator=generator)
        return AttnBlock(d, cfg.n_heads, cfg.kv_heads, cfg.d_ff, head_dim=cfg.head_dim,
                         window=w, norm=cfg.norm, act=cfg.act, glu=cfg.glu,
                         rope_theta=cfg.rope_theta, rope_pct=cfg.rope_pct,
                         qkv_bias=cfg.qkv_bias, attn_impl=attn_impl, dtype=dtype,
                         device=dev, generator=generator)

    segments, repeat = _expand_segments(cfg)
    stacks = make_stacks(mk, segments, repeat, device=device, remat=remat)
    emb_cls = PrefixEmbed if cfg.frontend == "vision" else TokenEmbed
    embed = emb_cls(cfg.vocab, d, dtype=dtype, device=device, generator=generator)
    norm = (RMSNorm(d, dtype=dtype, device=device) if cfg.norm == "rmsnorm"
            else LayerNorm(d, dtype=dtype, device=device))
    head = Dense(d, cfg.vocab, use_bias=False, dtype=dtype, device=device,
                 generator=generator)
    return CausalLM(embed, stacks, norm, head)
