"""Checkpointing of a training stream (``manager.CheckpointManager``)."""
