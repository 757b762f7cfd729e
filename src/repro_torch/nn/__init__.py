"""Layers beyond Dense (convolution, pooling, flattening, raw parameters),
and the language models: mixing functions (:mod:`.functional`), ``Wired``
(:mod:`.wired`), decoder blocks (:mod:`.blocks`) and model assemblies
(:mod:`.models`, among them the encoder-decoder ``WhisperModel``)."""
from .layers import Conv2d, Flatten, MaxPool2d, Param
from .models import WhisperModel

__all__ = ["Conv2d", "Flatten", "MaxPool2d", "Param", "WhisperModel"]
