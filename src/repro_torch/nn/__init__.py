"""Layers beyond Dense: convolution, pooling, flattening."""
from .layers import Conv2d, Flatten, MaxPool2d

__all__ = ["Conv2d", "Flatten", "MaxPool2d"]
