"""Hymba-1.5B [hybrid]: 32L d=1600 25H (kv=5) d_ff=5504, parallel
attention + SSD heads (ssm_state=16), SWA everywhere except 3 global
layers (first/middle/last).  [arXiv:2411.13676; hf]

long_500k RUNS: SSM state is O(1); attention caches are rings (1024)
except the 3 global layers.
"""
from repro_torch.configs.base import ModelConfig

ARCH = ModelConfig(
    name="hymba-1.5b", kind="hymba", family="hybrid",
    n_layers=32, d_model=1600, n_heads=25, kv_heads=5, d_ff=5504,
    vocab=32001, head_dim=64, ssm_state=16,
    window_segments=[(None, 1), (1024, 15), (None, 1), (1024, 14), (None, 1)],
    pattern_repeat=1,
    long_context_ok=True, source="arXiv:2411.13676; hf",
)
