"""Matrix-free curvature: so far the kernel-space natural gradient
(:func:`kernel_ngd_direction`).  The CG lane, the GGN-vector product and
SLQ come with the rest of ``src/repro/curv``."""
from .ngd import kernel_ngd_direction

__all__ = ["kernel_ngd_direction"]
