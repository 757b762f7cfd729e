"""Serving: batched prefill and decode with KV caches (:mod:`.engine`), and
the encoder-decoder's ``generate_whisper``."""
from .engine import ServeConfig, generate, generate_whisper, prefill

__all__ = ["ServeConfig", "generate", "generate_whisper", "prefill"]
