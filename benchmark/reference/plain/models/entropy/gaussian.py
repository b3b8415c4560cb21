"""Conditional Gaussian entropy model: the likelihood of the integer bin
under N(mean, scale^2) and the additive-noise quantization proxy of
training; the scale table, the scale-index function and the CDF tables
of rANS coding.

Training noise is drawn by ``uniform_noise`` from an explicit
``torch.Generator``; it cannot give the JAX package's ``jax.random`` bits,
so the parity tests hand both packages the same numbers."""

import math

import numpy as np
import torch

from ..bound import lower_bound

SCALE_MIN = 0.11
SCALE_MAX = 256.0
SCALES_LEVELS = 64
TAIL_MASS = 1e-9
LIKELIHOOD_BOUND = 1e-9


def uniform_noise(shape, like, generator=None):
    """U(-0.5, 0.5) noise of ``shape`` with ``like``'s dtype and device,
    drawn from ``generator``."""
    return torch.rand(shape, generator=generator, dtype=like.dtype,
                      device=like.device) - 0.5


def _std_cumulative(x):
    """Standard normal CDF through erfc (stable in the tails)."""
    return 0.5 * torch.special.erfc(-(2 ** -0.5) * x)


def likelihood(values, scales, means=None):
    """P(round(v) | N(mean, scale^2)) for each element (same shapes)."""
    if means is not None:
        values = values - means
    scales = lower_bound(scales, SCALE_MIN)
    v = torch.abs(values)
    upper = _std_cumulative((0.5 - v) / scales)
    lower = _std_cumulative((-0.5 - v) / scales)
    return lower_bound(upper - lower, LIKELIHOOD_BOUND)


def quantize_noise(values, generator=None):
    """The additive U(-0.5, 0.5) quantization proxy of training."""
    return values + uniform_noise(values.shape, values, generator)


def default_scale_table():
    return np.exp(np.linspace(math.log(SCALE_MIN), math.log(SCALE_MAX),
                              SCALES_LEVELS))


def build_indexes(scales, scale_table=None):
    """Index of the smallest table scale >= scale: the count of table
    entries (but the last) strictly below the bounded scale."""
    table = torch.as_tensor(np.asarray(
        scale_table if scale_table is not None else default_scale_table(),
        np.float32), device=scales.device)
    scales = lower_bound(scales, SCALE_MIN).contiguous()
    return torch.searchsorted(table[:-1].contiguous(), scales,
                              right=False).to(torch.int32)
