"""Training on one card: synthetic data, AdamW, the train step and
checkpoints, with the reference's names."""

from .optim import OptimizerConfig, init_opt_state, apply_updates
from .step import make_train_step, make_prefill_step, make_decode_step
from .data import DataState, synth_batch, next_batch
from . import checkpoint

__all__ = [
    "OptimizerConfig",
    "init_opt_state",
    "apply_updates",
    "make_train_step",
    "make_prefill_step",
    "make_decode_step",
    "DataState",
    "synth_batch",
    "next_batch",
    "checkpoint",
]
