"""Fault-tolerant checkpointing: atomic commit, async writes, checksums."""
from repro_torch.checkpoint.manager import CheckpointManager

__all__ = ["CheckpointManager"]
