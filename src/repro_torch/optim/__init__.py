"""Optimizers of the port: what a training step needs from the JAX
package's ``repro/optim/optimizers.py``, over dicts of tensors."""
from .optimizers import (SGDM, clip_by_global_norm, constant_schedule,
                         cosine_schedule, global_norm)

__all__ = ["SGDM", "clip_by_global_norm", "constant_schedule",
           "cosine_schedule", "global_norm"]
