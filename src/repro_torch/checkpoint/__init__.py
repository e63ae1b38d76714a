"""Checkpoints of the port's TrainState (``manager.CheckpointManager``)."""
