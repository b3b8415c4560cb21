"""Conditional Gaussian entropy model: the scale table, the scale-index
function and the CDF tables of the mean-scale hyperprior (inference
half)."""

import math

import numpy as np
import torch
from scipy.stats import norm as _scipy_norm

from ..bound import lower_bound

SCALE_MIN = 0.11
SCALE_MAX = 256.0
SCALES_LEVELS = 64
TAIL_MASS = 1e-9


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


def build_cdf_tables(scale_table=None, precision=16):
    """Host-side integer CDF tables, one per table scale, over a symmetric
    integer support sized by the tail quantile of that scale."""
    table = np.asarray(scale_table if scale_table is not None
                       else default_scale_table())
    multiplier = -_scipy_norm.ppf(TAIL_MASS / 2)
    tails = np.ceil(table * multiplier).astype(np.int32)
    max_len = int(2 * tails.max() + 1)

    from ...coding.rans import pmf_to_quantized_cdf
    n = len(table)
    cdfs = np.zeros((n, max_len + 2), np.int32)
    lengths = np.zeros((n,), np.int32)
    offsets = -tails.astype(np.int32)
    for i, (s, t) in enumerate(zip(table, tails)):
        x = np.arange(-t, t + 1, dtype=np.float64)
        upper = _scipy_norm.cdf((x + 0.5) / s)
        lower = _scipy_norm.cdf((x - 0.5) / s)
        pmf = upper - lower
        tail_mass = lower[0] + (1.0 - upper[-1])
        qc = pmf_to_quantized_cdf(pmf, tail_mass, precision)
        cdfs[i, :len(qc)] = qc
        lengths[i] = len(qc)
    return {"cdf": cdfs, "cdf_length": lengths, "offset": offsets}
