"""DeepSeek-V2-Lite-16B [moe+mla]: 27L d=2048 16H, MLA kv_lora=512
(qk_nope=128, qk_rope=64, v=128), 64 routed experts top-6 + 2 shared,
expert d_ff=1408, vocab=102400.  [arXiv:2405.04434; hf]

long_500k RUNS for this arch: MLA's compressed per-token cache
(kv_lora+rope = 576 floats/token/layer) is precisely its long-context
design point (~0.6 GB/layer at 524k, bf16).
"""
from repro_torch.configs.base import ModelConfig

ARCH = ModelConfig(
    name="deepseek-v2-lite-16b", kind="moe_mla", family="moe",
    n_layers=27, d_model=2048, n_heads=16, kv_heads=16, d_ff=1408,
    vocab=102400, act="silu", norm="rmsnorm",
    n_experts=64, top_k=6, d_expert=1408, n_shared_experts=2,
    kv_lora=512, qk_nope=128, qk_rope=64, v_head_dim=128,
    long_context_ok=True, source="arXiv:2405.04434; hf",
)
