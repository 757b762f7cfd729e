"""CodeQwen1.5-7B [dense]: 32L d=4096 32H MHA (kv=32) d_ff=13440
vocab=92416, qwen1.5 arch (qkv bias).  [hf:Qwen/CodeQwen1.5-7B]
"""
from repro_torch.configs.base import ModelConfig

ARCH = ModelConfig(
    name="codeqwen1.5-7b", kind="dense", family="dense",
    n_layers=32, d_model=4096, n_heads=32, kv_heads=32, d_ff=13440,
    vocab=92416, act="silu", norm="rmsnorm", glu=True, qkv_bias=True,
    rope_theta=1e6,
    long_context_ok=False, source="hf:Qwen/CodeQwen1.5-7B; hf",
)
