"""Checkpoints of the training state, ported from ``repro.checkpoint``."""
from .manager import CheckpointManager

__all__ = ["CheckpointManager"]
