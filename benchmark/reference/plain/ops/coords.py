"""Morton-key coordinate arithmetic for sparse voxel tensors.

Every point is identified by one int64 key::

    key = (batch << BATCH_SHIFT) | morton(u_x, u_y, u_z)

where ``u = coordinate // tensor_stride`` are the unit coordinates at the
tensor's stride level.  Invalid (padding) slots hold ``SENTINEL`` = int64
max, so a sorted key array keeps its valid points in a contiguous prefix.
Stride-2 downsampling is ``morton >> 3``; child expansion is
``morton << 3 | c``.  The ``_np`` functions are the numpy twins used by
host code.
"""

import numpy as np
import torch

COORD_BITS = 19
BATCH_SHIFT = 3 * COORD_BITS
SENTINEL = np.iinfo(np.int64).max
KEY_MASK = (1 << BATCH_SHIFT) - 1

_MASKS = [
    (0x1249249249249249, 2),
    (0x10C30C30C30C30C3, 4),
    (0x100F00F00F00F00F, 8),
    (0x1F0000FF0000FF, 16),
    (0x1F00000000FFFF, 32),
]


def _spread3(v):
    """Spread the low 21 bits of v so bit i moves to bit 3*i."""
    v = v.to(torch.int64) & 0x1FFFFF
    for mask, shift in reversed(_MASKS):
        v = (v | (v << shift)) & mask
    return v


def _compact3(v):
    """Inverse of _spread3: collect every 3rd bit back into the low 21."""
    v = v.to(torch.int64) & 0x1249249249249249
    v = (v ^ (v >> 2)) & 0x10C30C30C30C30C3
    v = (v ^ (v >> 4)) & 0x100F00F00F00F00F
    v = (v ^ (v >> 8)) & 0x1F0000FF0000FF
    v = (v ^ (v >> 16)) & 0x1F00000000FFFF
    v = (v ^ (v >> 32)) & 0x1FFFFF
    return v


def morton_encode(units):
    """units: int tensor [..., 3] of non-negative unit coordinates -> int64."""
    x = _spread3(units[..., 0])
    y = _spread3(units[..., 1])
    z = _spread3(units[..., 2])
    return (x << 2) | (y << 1) | z


def morton_decode(code):
    """int64 [...] -> int32 [..., 3] unit coordinates."""
    x = _compact3(code >> 2)
    y = _compact3(code >> 1)
    z = _compact3(code)
    return torch.stack([x, y, z], dim=-1).to(torch.int32)


def morton_encode_np(units):
    """numpy twin of morton_encode for host-side voxelization."""
    units = np.asarray(units)
    out = np.zeros(units.shape[:-1], np.int64)
    for axis, shift in ((0, 2), (1, 1), (2, 0)):
        v = units[..., axis].astype(np.int64) & 0x1FFFFF
        for mask, s in reversed(_MASKS):
            v = (v | (v << s)) & mask
        out |= v << shift
    return out


def morton_decode_np(codes):
    """numpy twin of morton_decode (host-side output conversion)."""
    codes = np.asarray(codes)
    out = np.zeros(codes.shape + (3,), np.int32)
    for axis, shift in ((0, 2), (1, 1), (2, 0)):
        v = (codes >> shift) & 0x1249249249249249
        v = (v ^ (v >> 2)) & 0x10C30C30C30C30C3
        v = (v ^ (v >> 4)) & 0x100F00F00F00F00F
        v = (v ^ (v >> 8)) & 0x1F0000FF0000FF
        v = (v ^ (v >> 16)) & 0x1F00000000FFFF
        v = (v ^ (v >> 32)) & 0x1FFFFF
        out[..., axis] = v.astype(np.int32)
    return out


def make_keys(batch, units):
    """Pack (batch int [...], units int [..., 3]) into keys."""
    return (batch.to(torch.int64) << BATCH_SHIFT) | morton_encode(units)


def key_batch(keys):
    """Batch index of each key (garbage for SENTINEL slots; mask separately)."""
    return (keys >> BATCH_SHIFT).to(torch.int32)


def key_units(keys):
    """Unit coordinates of each key, int32 [..., 3]."""
    return morton_decode(keys & KEY_MASK)


def key_is_valid(keys):
    return keys != SENTINEL


def sentinel_like(keys):
    """A SENTINEL scalar tensor on the keys' device (for torch.where)."""
    return torch.full((), SENTINEL, dtype=torch.int64, device=keys.device)


def shift_units(keys, delta, scale=1, div2=False):
    """Neighbour key arithmetic: decode, apply ``u * scale + delta`` (or
    ``(u - delta) / 2`` with ``div2``; delta a static length-3 tuple of
    ints), re-encode.  Returns (keys, valid): results outside the
    coordinate range (or odd before the halving), and shifts of SENTINEL
    slots, are SENTINEL and not valid."""
    b = keys & ~KEY_MASK
    d = torch.tensor(delta, dtype=torch.int32, device=keys.device)
    if div2:
        t = key_units(keys) - d
        ok = ((t & 1) == 0).all(-1) & (t >= 0).all(-1) & key_is_valid(keys)
        nu = t >> 1
    else:
        nu = key_units(keys) * scale + d
        ok = (nu >= 0).all(-1) & (nu < (1 << COORD_BITS)).all(-1) \
            & key_is_valid(keys)
    nk = b | morton_encode(nu.clamp(min=0))
    return torch.where(ok, nk, sentinel_like(keys)), ok


def kernel_offsets(kernel_size, ndim=3):
    """Static numpy [K, 3] kernel offset grid, MinkowskiEngine convention:
    odd kernels are centered, even kernels non-negative."""
    if kernel_size % 2 == 1:
        r = np.arange(kernel_size) - kernel_size // 2
    else:
        r = np.arange(kernel_size)
    grid = np.stack(np.meshgrid(r, r, r, indexing="ij"), axis=-1).reshape(-1, ndim)
    return grid.astype(np.int32)
