"""Serving: batched prefill and decode with KV caches (:mod:`.engine`)."""
from .engine import ServeConfig, generate, prefill

__all__ = ["ServeConfig", "generate", "prefill"]
