"""Quality metrics."""
