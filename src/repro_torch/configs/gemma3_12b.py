"""Gemma-3-12B [dense]: 48L d=3840 16H (kv=8) d_ff=15360 vocab=262144,
5 local (window 1024) : 1 global pattern ×8, GeGLU.  [unverified]

long_500k RUNS: 40/48 layers have ring caches (1024); the 8 global layers
keep full caches — O(T) memory on 1/6 of layers, documented in DESIGN.md.
"""
from repro_torch.configs.base import ModelConfig

ARCH = ModelConfig(
    name="gemma3-12b", kind="dense", family="dense",
    n_layers=48, d_model=3840, n_heads=16, kv_heads=8, d_ff=15360,
    vocab=262144, head_dim=240, act="gelu", norm="rmsnorm", glu=True,
    rope_theta=1e6, window_segments=[(1024, 5), (None, 1)], pattern_repeat=8,
    long_context_ok=True, source="hf:google/gemma-3; unverified",
)
