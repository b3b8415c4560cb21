"""Synthetic point clouds."""
