"""Training steps: the plain gradient step and the engine-backed extended
step of the paper's §4 (:mod:`.step`)."""
from .step import make_extended_train_step, make_loss_fn, make_train_step

__all__ = ["make_extended_train_step", "make_loss_fn", "make_train_step"]
