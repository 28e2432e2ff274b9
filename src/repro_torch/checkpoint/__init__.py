"""Checkpoints of the port's trainer: ``manager.CheckpointManager``, which
reads and writes the JAX package's format."""
from .manager import CheckpointManager

__all__ = ["CheckpointManager"]
