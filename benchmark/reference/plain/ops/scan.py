"""Prefix sums.

The JAX package blocks its scan into triangular matmuls for the TPU's
matrix unit; PyTorch's cumsum is exact in int32 on every device, so the
port's scan is one call.
"""

import torch


def cumsum_i32(x):
    """Inclusive prefix sum of small non-negative ints, int32 [N] out."""
    return torch.cumsum(x.to(torch.int32), 0, dtype=torch.int32)
