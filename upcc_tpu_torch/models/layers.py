"""Parameter-holding layers over the family-conv engine.

Coordinate structure (FamilyMaps) is built by the caller and shared across
layers on the same point set; the modules here hold weights and call the
``ops.family`` compute.  Parameter names and shapes match the JAX
package's flax layers (``w`` [K^3, cin, cout], ``b`` [cout]; Dense
``kernel`` [in, out], ``bias``), so a flax tree maps onto them by path.
"""

import torch
from torch import nn

from ..ops import coords as C
from ..ops import family as F


class _TapConv(nn.Module):
    """Weights ``w`` [kernel_size^3, cin, cout] and bias ``b`` [cout]."""

    def __init__(self, cin, cout, kernel_size, use_bias=True):
        super().__init__()
        k = kernel_size ** 3
        self.kernel_size = kernel_size
        self.w = nn.Parameter(torch.randn(k, cin, cout) * (1.0 / (k * cin)) ** 0.5)
        self.b = nn.Parameter(torch.zeros(cout)) if use_bias else None


class FamilyConv(_TapConv):
    """Stride-1 sparse conv (odd kernel <= 5) over octree bricks."""

    def forward(self, fm, feats, valid, out_fm=None, out_keys_valid=None,
                nbr_cross=None, grand=False):
        if grand:
            # grandparent-brick mode: fm = G self-neighbour map, feats =
            # [G, 64, cin] grandchild brick, valid = [G, 64] slot mask
            out = F.grand_apply(fm, feats, self.w, self.kernel_size, "conv")
            if self.b is not None:
                out = out + self.b
            return out * valid[..., None].to(out.dtype)
        out = F.family_conv(fm, feats, valid, self.w, self.kernel_size,
                            out_fm, out_keys_valid, nbr_cross)
        if self.b is not None:
            ov = out_keys_valid if out_keys_valid is not None else valid
            out = (out + self.b) * ov[:, None].to(out.dtype)
        return out


class FamilyDownConv(_TapConv):
    """Stride-2 sparse conv; output set = fm.parent_keys."""

    def forward(self, fm, feats, valid, grand=False):
        if grand:
            # fm = G self map of the input's grandparent level, feats =
            # [G, 64, cin]; returns [G, 8, cout] child bricks (the caller
            # unflattens and re-masks)
            out = F.grand_apply(fm, feats, self.w, self.kernel_size, "down")
            if self.b is not None:
                out = out + self.b
            return out
        out = F.family_down_conv(fm, feats, valid, self.w, self.kernel_size)
        if self.b is not None:
            out = (out + self.b) * C.key_is_valid(fm.parent_keys)[:, None] \
                .to(out.dtype)
        return out


class FamilyTransposeUp(_TapConv):
    """Generative stride-2 transposed conv onto the full child expansion."""

    def forward(self, nbr_self, feats, valid, grand=False):
        if grand:
            # nbr_self = G self map, feats = [G, 8, cin] child brick of G,
            # valid = [G, 64] candidate mask; non-candidate slots come out
            # zero (downstream grand convs gather whole G rows)
            out = F.grand_apply(nbr_self, feats, self.w, self.kernel_size,
                                "transpose")
            if self.b is not None:
                out = out + self.b
            return out * valid[..., None].to(out.dtype)
        out = F.family_transpose_up(nbr_self, feats, valid, self.w,
                                    self.kernel_size)
        if self.b is not None:
            # output rows follow the nbr map's rows; kernel-2 transposes
            # pass no map — rows are the input set
            row_ok = valid if nbr_self is None else nbr_self[1].any(dim=1)
            cvalid = torch.repeat_interleave(row_ok, 8)
            out = (out + self.b) * cvalid[:, None].to(out.dtype)
        return out


class PointwiseConv(nn.Module):
    """1^3 conv == per-point dense layer."""

    def __init__(self, cin, cout, use_bias=True):
        super().__init__()
        self.w = nn.Parameter(torch.randn(cin, cout) * (1.0 / cin) ** 0.5)
        self.b = nn.Parameter(torch.zeros(cout)) if use_bias else None

    def forward(self, feats, valid):
        out = feats.to(self.w.dtype) @ self.w
        if self.b is not None:
            out = out + self.b
        return out * valid[:, None].to(out.dtype)


class Dense(nn.Module):
    """flax ``nn.Dense`` layout: kernel [in, out], bias [out]."""

    def __init__(self, fin, fout):
        super().__init__()
        self.kernel = nn.Parameter(torch.randn(fin, fout) * (1.0 / fin) ** 0.5)
        self.bias = nn.Parameter(torch.zeros(fout))

    def forward(self, x):
        return x @ self.kernel + self.bias


class MLP(nn.Module):
    """Small dense MLP (the rate-control gain/offset nets); submodules are
    named ``Dense_<i>`` as flax names them."""

    def __init__(self, fin, features, final_softplus=False):
        super().__init__()
        self.n = len(features)
        self.final_softplus = final_softplus
        for i, f in enumerate(features):
            self.add_module(f"Dense_{i}", Dense(fin, f))
            fin = f

    def forward(self, x):
        for i in range(self.n):
            x = getattr(self, f"Dense_{i}")(x)
            if i < self.n - 1:
                x = torch.relu(x)
        if self.final_softplus:
            x = torch.logaddexp(x, torch.zeros_like(x))  # jax.nn.softplus
        return x
