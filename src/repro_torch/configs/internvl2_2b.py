"""InternVL2-2B [vlm]: InternViT frontend (stub) + InternLM2-1.8B backbone.

24L d_model=2048 16H (GQA kv=8) d_ff=8192 vocab=92553  [arXiv:2404.16821; hf]
Frontend is a STUB per task spec: ``input_specs`` provides precomputed patch
embeddings ([B, 256, d]) prepended to the text tokens.
"""
from repro_torch.configs.base import ModelConfig

ARCH = ModelConfig(
    name="internvl2-2b", kind="dense", family="vlm",
    n_layers=24, d_model=2048, n_heads=16, kv_heads=8, d_ff=8192,
    vocab=92553, act="silu", norm="rmsnorm", glu=True,
    rope_theta=1e6, frontend="vision", n_prefix=256,
    long_context_ok=False, source="arXiv:2404.16821; hf",
)
