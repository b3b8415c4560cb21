"""Model modules of the codec (inference half)."""
