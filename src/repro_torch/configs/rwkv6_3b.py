"""RWKV6-3B "Finch" [ssm]: 32L d=2560 (40 heads x 64), attn-free,
data-dependent decay, channel-mix d_ff=8960, vocab=65536.
[arXiv:2404.05892; hf]

long_500k RUNS: O(1) recurrent state (no KV cache at all).
"""
from repro_torch.configs.base import ModelConfig

ARCH = ModelConfig(
    name="rwkv6-3b", kind="rwkv", family="ssm",
    n_layers=32, d_model=2560, n_heads=40, kv_heads=40, d_ff=8960,
    vocab=65536, head_dim=64,
    long_context_ok=True, source="arXiv:2404.05892; hf",
)
