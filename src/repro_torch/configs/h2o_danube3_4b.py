"""H2O-Danube-3-4B [dense]: 24L d=3840 32H (kv=8) d_ff=10240 vocab=32000,
llama+mistral mix with sliding-window attention (8192).
[arXiv:2401.16818; unverified]

long_500k RUNS: uniform SWA -> every layer's cache is a ring of 8192.
"""
from repro_torch.configs.base import ModelConfig

ARCH = ModelConfig(
    name="h2o-danube-3-4b", kind="dense", family="dense",
    n_layers=24, d_model=3840, n_heads=32, kv_heads=8, d_ff=10240,
    vocab=32000, head_dim=120, act="silu", norm="rmsnorm", glu=True,
    window_segments=[(8192, 24)], pattern_repeat=1,
    long_context_ok=True, source="arXiv:2401.16818; unverified",
)
