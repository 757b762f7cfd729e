"""Granite-3.0-1B-A400M [moe]: 24L d=1024 16H (kv=8) expert d_ff=512,
32 experts top-8, vocab=49155.  [hf:ibm-granite/granite-3.0-1b-a400m-base]
"""
from repro_torch.configs.base import ModelConfig

ARCH = ModelConfig(
    name="granite-moe-1b-a400m", kind="moe_gqa", family="moe",
    n_layers=24, d_model=1024, n_heads=16, kv_heads=8, d_ff=512,
    vocab=49155, act="silu", norm="rmsnorm",
    n_experts=32, top_k=8, d_expert=512,
    long_context_ok=False, source="hf:ibm-granite/granite-3.0-1b-a400m-base",
)
