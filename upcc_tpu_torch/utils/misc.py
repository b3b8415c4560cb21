"""Small utilities: running averages, bit counting, coordinate set ops
(numpy; the same results as the JAX package's ``utils/misc.py``)."""

import numpy as np


class AverageMeter:
    """Running average tracker."""

    def __init__(self):
        self.reset()

    def reset(self):
        self.val = 0.0
        self.sum = 0.0
        self.count = 0

    def update(self, val, n=1):
        self.val = val
        self.sum += val * n
        self.count += n

    @property
    def avg(self):
        return self.sum / self.count if self.count else 0.0


def count_bits(strings):
    """Total bits in a (possibly nested) structure of byte strings."""
    if isinstance(strings, (bytes, bytearray)):
        return 8 * len(strings)
    if isinstance(strings, (list, tuple)):
        return sum(count_bits(s) for s in strings)
    if isinstance(strings, dict):
        return sum(count_bits(s) for s in strings.values())
    raise TypeError(f"cannot count bits of {type(strings)}")


def overlapping_mask(keys_a, keys_b, warn_duplicates=True):
    """Boolean mask over keys_a marking members of keys_b (both int64
    Morton-key arrays), by exact set membership."""
    keys_a = np.asarray(keys_a)
    keys_b = np.unique(np.asarray(keys_b))
    idx = np.searchsorted(keys_b, keys_a)
    idx = np.minimum(idx, max(len(keys_b) - 1, 0))
    mask = (keys_b[idx] == keys_a) if len(keys_b) \
        else np.zeros(len(keys_a), bool)
    if warn_duplicates:
        _, ca = np.unique(keys_a, return_counts=True)
        if (ca > 1).any():
            print(f"Warning: {int((ca > 1).sum())} duplicate coordinates "
                  "in overlapping_mask input")
    return mask
