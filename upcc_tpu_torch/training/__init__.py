"""Training: losses, the training step and the trainer."""
