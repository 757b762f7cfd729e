"""Training steps: the plain gradient step and the engine-backed extended
step of the paper's §4, and a language model's prefill and decode steps
(:mod:`.step`); npz checkpoints and the accumulated sweep's snapshot store
(:mod:`.checkpoint`); failure injection and restarts (:mod:`.fault`); the training loop on
synthetic data (:mod:`.loop`)."""
from . import checkpoint, fault
from .step import (
    make_decode_step,
    make_extended_train_step,
    make_loss_fn,
    make_prefill_step,
    make_train_step,
)

__all__ = ["make_decode_step", "make_extended_train_step", "make_loss_fn",
           "make_prefill_step", "make_train_step"]
