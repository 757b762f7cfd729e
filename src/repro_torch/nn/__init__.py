"""Layers beyond Dense (convolution, pooling, flattening, per-expert
weights, raw parameters), and the language models: mixing functions
(:mod:`.functional`), ``Wired`` (:mod:`.wired`), mixture-of-experts routing
(:mod:`.moe`), decoder blocks (:mod:`.blocks`) and model assemblies
(:mod:`.models`, among them the encoder-decoder ``WhisperModel``)."""
from .blocks import AttnMoEBlock, MLAMoEBlock
from .layers import BatchedDense, Conv2d, Flatten, MaxPool2d, Param
from .models import WhisperModel

__all__ = ["AttnMoEBlock", "BatchedDense", "Conv2d", "Flatten", "MLAMoEBlock", "MaxPool2d",
           "Param", "WhisperModel"]
