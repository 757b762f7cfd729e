"""Layers beyond Dense (convolution, pooling, flattening, raw parameters),
and the language models: mixing functions (:mod:`.functional`), ``Wired``
(:mod:`.wired`), decoder blocks (:mod:`.blocks`) and model assemblies
(:mod:`.models`)."""
from .layers import Conv2d, Flatten, MaxPool2d, Param

__all__ = ["Conv2d", "Flatten", "MaxPool2d", "Param"]
