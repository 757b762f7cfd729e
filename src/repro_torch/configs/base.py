"""The language-model configuration dataclass and the input-shape registry.

A copy of ``src/repro/configs/base.py:17-136`` (plain dataclasses, kept here
so the port imports nothing of the JAX package).  ``param_count`` counts the
port's own tensors, built on the ``meta`` device (no memory, no draws).
``input_specs`` (``jax.ShapeDtypeStruct`` stand-ins for the dry-run cells)
waits for the cost tooling (ROADMAP queue A item 14).
"""
from __future__ import annotations

import dataclasses
import math
from typing import List, Optional, Tuple


@dataclasses.dataclass(frozen=True)
class Shape:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # 'train' | 'prefill' | 'decode'


SHAPES = {
    "train_4k": Shape("train_4k", 4096, 256, "train"),
    "prefill_32k": Shape("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": Shape("decode_32k", 32768, 128, "decode"),
    "long_500k": Shape("long_500k", 524288, 1, "decode"),
}


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    kind: str       # dense | moe_gqa | moe_mla | rwkv | hymba | encdec
    family: str     # dense | moe | ssm | hybrid | vlm | audio
    n_layers: int
    d_model: int
    n_heads: int
    kv_heads: int
    d_ff: int
    vocab: int
    head_dim: Optional[int] = None
    act: str = "silu"
    norm: str = "rmsnorm"
    glu: bool = True
    rope_theta: float = 10000.0
    rope_pct: float = 1.0
    qkv_bias: bool = False
    # attention pattern: list of (window|None, count) repeated pattern_repeat×
    window_segments: Optional[List[Tuple[Optional[int], int]]] = None
    pattern_repeat: int = 1
    # moe
    n_experts: int = 0
    top_k: int = 0
    d_expert: int = 0
    n_shared_experts: int = 0
    capacity_factor: float = 1.25
    # mla
    kv_lora: int = 0
    qk_nope: int = 128
    qk_rope: int = 64
    v_head_dim: int = 128
    # ssm / hybrid
    ssm_state: int = 0
    # frontend
    frontend: str = "none"  # none | vision | audio
    n_prefix: int = 0
    # enc-dec
    enc_layers: int = 0
    dec_layers: int = 0
    dec_len: int = 448
    dtype: str = "bfloat16"
    # capability flags
    long_context_ok: bool = False
    source: str = ""

    def reduced(self):
        """Small same-family config for CPU smoke tests."""
        kw = dict(
            n_layers=2, d_model=64, n_heads=4, kv_heads=2, d_ff=128,
            vocab=97, head_dim=16, dtype="float32",
        )
        if self.kind == "rwkv":
            kw.update(n_heads=4, head_dim=16, d_model=64)
        if self.window_segments is not None:
            kw["window_segments"] = [(8, 1), (None, 1)]
            kw["pattern_repeat"] = 1
        if self.n_experts:
            kw.update(n_experts=4, top_k=2, d_expert=32)
        if self.n_shared_experts:
            kw.update(n_shared_experts=1)
        if self.kv_lora:
            kw.update(kv_lora=32, qk_nope=16, qk_rope=8, v_head_dim=16)
        if self.ssm_state:
            kw.update(ssm_state=8)
        if self.frontend == "vision":
            kw.update(n_prefix=4)
        if self.kind == "encdec":
            kw.update(enc_layers=2, dec_layers=2, dec_len=8, n_layers=4)
        return dataclasses.replace(self, **kw)

    # ---- analytics ---------------------------------------------------------
    def param_count(self, model=None) -> int:
        """Entries of the port's parameter tensors (the model is built on the
        ``meta`` device unless one is given)."""
        from repro_torch.core.tree import tree_leaves
        from repro_torch.nn.models import build_model

        model = model or build_model(self, device="meta")
        return sum(math.prod(p.shape) for p in tree_leaves(model.params()))

    def active_param_count(self, model=None) -> int:
        """Params touched per token (MoE: top-k of routed experts)."""
        total = self.param_count(model)
        if not self.n_experts:
            return total
        per_expert = 3 * self.d_model * self.d_expert
        routed = self.n_layers * self.n_experts * per_expert
        active = self.n_layers * self.top_k * per_expert
        return total - routed + active


def supported_shapes(cfg: ModelConfig):
    names = ["train_4k", "prefill_32k", "decode_32k"]
    if cfg.long_context_ok:
        names.append("long_500k")
    return [SHAPES[n] for n in names]


def skipped_shapes(cfg: ModelConfig):
    return [] if cfg.long_context_ok else [SHAPES["long_500k"]]
