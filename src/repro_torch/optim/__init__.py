"""Optimizers of the port: the JAX package's ``repro/optim/optimizers.py``
over trees of tensors."""
from .optimizers import (SGDM, AdamW, clip_by_global_norm, constant_schedule,
                         cosine_schedule, global_norm)

__all__ = ["AdamW", "SGDM", "clip_by_global_norm", "constant_schedule",
           "cosine_schedule", "global_norm"]
