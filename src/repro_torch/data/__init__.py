"""Deterministic synthetic data (:mod:`.synthetic`).  Port of
``src/repro/data``."""
from .synthetic import DataConfig, audio_batch, batch_for, lm_batch, vlm_batch

__all__ = ["DataConfig", "audio_batch", "batch_for", "lm_batch", "vlm_batch"]
