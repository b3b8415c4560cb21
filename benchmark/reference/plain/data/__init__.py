"""Frozen copies of the port's synthetic frames, cube slicing,
augmentations and rate-control draws."""
