"""Checkpoints of the port (`repro.ckpt`): cuboid-chunked, async flush."""
from .checkpoint import CheckpointManager, restore_checkpoint, save_checkpoint

__all__ = ["CheckpointManager", "restore_checkpoint", "save_checkpoint"]
