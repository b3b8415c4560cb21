"""Frozen copies of the port's loss and training step."""
