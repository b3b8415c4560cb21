"""Lower bound, inference form: the JAX package's ``lower_bound`` carries
a custom gradient for training; the port's inference path needs only its
forward value."""

import torch


def lower_bound(x, bound):
    return torch.clamp(x, min=bound)
