"""Sparse convolutions by key lookup: for each kernel offset, neighbour key
arithmetic, a binary search into the sorted input keys, a masked gather
and one [N, Cin] x [Cin, Cout] product, accumulated in f32.  Plain torch:
these serve ``layers.SparseConv`` and the Shepard interpolation loss, not
the codec's convs (``ops/family.py``).

Coordinate modes:
  'same' : out stride == in stride,      neighbour = u_out + d
  'down' : out stride == 2x in stride,   neighbour = 2 u_out + d
  'up'   : out stride == in stride / 2,  neighbour = (u_out - d) / 2 (even)
"""

import torch

from . import coords as C
from .sparse import SparseTensor


def _neighbor_keys(out_keys, delta, mode):
    delta = tuple(int(v) for v in delta)
    if mode == "same":
        return C.shift_units(out_keys, delta, scale=1)
    if mode == "down":
        return C.shift_units(out_keys, delta, scale=2)
    if mode == "up":
        return C.shift_units(out_keys, delta, div2=True)
    raise ValueError(mode)


def gather_neighbors(in_keys, in_feats, out_keys, delta, mode):
    """One offset: (features of the neighbour at ``delta`` of every output
    key, zeros where absent; found bool)."""
    nkeys, _ = _neighbor_keys(out_keys, delta, mode)
    idx = torch.searchsorted(in_keys, nkeys).clamp(max=in_keys.shape[0] - 1)
    found = (in_keys[idx] == nkeys) & C.key_is_valid(nkeys)
    g = in_feats[idx]
    return g * found[:, None].to(g.dtype), found


def apply_sparse_conv(x: SparseTensor, out_keys, weights, bias, offsets, mode,
                      out_stride, compute_dtype=torch.float32):
    """Sparse convolution of ``x`` onto the sorted ``out_keys``.
    weights [K, Cin, Cout] per offset of the static numpy ``offsets``
    [K, 3]; bias [Cout] or None."""
    in_feats = x.feats.to(compute_dtype)
    w = weights.to(compute_dtype)
    acc = torch.zeros((out_keys.shape[0], weights.shape[-1]),
                      dtype=torch.float32, device=out_keys.device)
    for k, d in enumerate(offsets):
        g, _ = gather_neighbors(x.keys, in_feats, out_keys, d, mode)
        acc = acc + g.float() @ w[k].float()
    if bias is not None:
        acc = acc + bias.float()
    acc = acc * C.key_is_valid(out_keys)[:, None].to(acc.dtype)
    return SparseTensor(keys=out_keys, feats=acc, stride=out_stride)


def apply_channelwise_conv(x: SparseTensor, out_keys, weights, offsets, mode,
                           out_stride):
    """Depthwise sparse conv: out = sum_k neighbour_k * weights[k] (per
    channel).  Used by the Shepard interpolation loss."""
    acc = torch.zeros((out_keys.shape[0], x.feats.shape[1]),
                      dtype=x.feats.dtype, device=out_keys.device)
    for k, d in enumerate(offsets):
        g, _ = gather_neighbors(x.keys, x.feats, out_keys, d, mode)
        acc = acc + g * weights[k][None, :]
    acc = acc * C.key_is_valid(out_keys)[:, None].to(acc.dtype)
    return SparseTensor(keys=out_keys, feats=acc, stride=out_stride)


def apply_avg_pool(x: SparseTensor, out_keys, offsets, mode, out_stride):
    """Mean of the found neighbours over the kernel support."""
    acc = torch.zeros((out_keys.shape[0], x.feats.shape[1]),
                      dtype=x.feats.dtype, device=out_keys.device)
    cnt = torch.zeros(out_keys.shape[0], dtype=torch.float32,
                      device=out_keys.device)
    for d in offsets:
        g, found = gather_neighbors(x.keys, x.feats, out_keys, d, mode)
        acc = acc + g
        cnt = cnt + found.to(torch.float32)
    feats = acc / cnt.clamp(min=1.0)[:, None]
    feats = feats * C.key_is_valid(out_keys)[:, None].to(feats.dtype)
    return SparseTensor(keys=out_keys, feats=feats, stride=out_stride)


def conv_param_shapes(kernel_size, cin, cout):
    """Shapes of a conv's (weights, bias): ([K^3, cin, cout], [cout])."""
    k = kernel_size ** 3
    return (k, cin, cout), (cout,)


def init_conv_weights(generator, kernel_size, cin, cout,
                      dtype=torch.float32):
    """Variance-scaling init over the full fan-in (K^3 * cin): weights
    N(0, 1 / fan_in) drawn from ``generator`` on its device, zero bias."""
    (k, _, _), _ = conv_param_shapes(kernel_size, cin, cout)
    std = (1.0 / (k * cin)) ** 0.5
    w = torch.randn((k, cin, cout), generator=generator, dtype=dtype,
                    device=generator.device) * std
    b = torch.zeros((cout,), dtype=dtype, device=generator.device)
    return w, b
