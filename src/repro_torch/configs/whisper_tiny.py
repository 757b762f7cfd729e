"""Whisper-tiny [audio]: enc-dec, 4+4L d=384 6H d_ff=1536 vocab=51865,
conv frontend STUBBED (input_specs provides frame embeddings).
[arXiv:2212.04356; unverified]

decode shapes decode 1 text token against a seq_len-frame cross-attention
cache; long_500k skipped (full attention; 30 s audio ceiling).
"""
from repro_torch.configs.base import ModelConfig

ARCH = ModelConfig(
    name="whisper-tiny", kind="encdec", family="audio",
    n_layers=8, d_model=384, n_heads=6, kv_heads=6, d_ff=1536,
    vocab=51865, act="gelu", norm="layernorm", glu=False,
    frontend="audio", enc_layers=4, dec_layers=4, dec_len=448,
    long_context_ok=False, source="arXiv:2212.04356; unverified",
)
