"""Training stack: optimizer, step builder, checkpointing, fault tolerance.

The port's counterpart of ``repro.train``: the same functional contracts
over trees of torch tensors (params and optimizer state are dicts, lists
and tuples of tensors; a step returns new trees and never writes into the
ones it was given).
"""

from .optimizer import AdamW, cosine_schedule, global_norm
from .step import init_train_state, make_train_step

__all__ = ["AdamW", "cosine_schedule", "global_norm",
           "init_train_state", "make_train_step"]
