"""BackPACK in PyTorch, with its reduction kernels written for NVIDIA Hopper.

The port of the JAX package ``repro`` (which stays the reference): the same
extensions, sweeps and module protocol, parameters in the JAX layout so
weights cross over through numpy (:mod:`repro_torch.bridge`).  Entry points
run on the card unless the caller asks for the CPU.  :mod:`repro_torch.obs`
records spans, counters and gauges across every layer.
"""
from repro_torch import obs

__all__ = ["obs"]
