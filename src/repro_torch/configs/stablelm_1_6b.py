"""StableLM-2-1.6B [dense]: 24L d=2048 32H MHA (kv=32) d_ff=5632,
vocab=100352, LayerNorm, partial rotary 25%.  [hf:stabilityai/stablelm-2-1_6b]
"""
from repro_torch.configs.base import ModelConfig

ARCH = ModelConfig(
    name="stablelm-1.6b", kind="dense", family="dense",
    n_layers=24, d_model=2048, n_heads=32, kv_heads=32, d_ff=5632,
    vocab=100352, act="silu", norm="layernorm", glu=True,
    rope_pct=0.25, qkv_bias=True,
    long_context_ok=False, source="hf:stabilityai/stablelm-2-1_6b; unverified",
)
