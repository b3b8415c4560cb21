"""Lower bound with identity-if-towards-bound gradient, and rounding with a
straight-through gradient.

``lower_bound``'s gradient passes where the input is at or above the bound,
or where the incoming gradient is negative (descent then pushes the value
up toward the bound): the convention learned compression stacks use for
scale parameters, as the JAX package's ``custom_vjp`` has it.  Its value is
``max(x, bound)``.
"""

import torch


class _LowerBound(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, bound):
        ctx.save_for_backward(x)
        ctx.bound = bound
        return torch.clamp(x, min=bound)

    @staticmethod
    def backward(ctx, g):
        (x,) = ctx.saved_tensors
        pass_through = (x >= ctx.bound) | (g < 0)
        return torch.where(pass_through, g, torch.zeros_like(g)), None


def lower_bound(x, bound):
    """``max(x, bound)``; ``bound`` is a Python number."""
    return _LowerBound.apply(x, float(bound))


def quantize_ste(x):
    """Round with a straight-through gradient."""
    return x + (torch.round(x) - x).detach()
