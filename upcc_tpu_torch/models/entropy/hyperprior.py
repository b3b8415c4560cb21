"""Variable-rate mean-scale hyperprior over sparse latents, inference half.

h_a: 3^3 conv + LeakyReLU + two stride-2 3^3 convs (y stride 8 -> z 32);
h_s: two stride-2 kernel-2 generative transposes + a 3^3 conv producing
(scales, means) read out directly at the y coordinates through a
cross-parent map; the gain nets map q = (q_g, q_a) to per-channel gains and
quant_nn predicts quantization-reconstruction offsets.  Encoder and decoder
both run ``decode_params_device``, so their entropy parameters are the
same bits.  The training forward is not ported.
"""

import torch
from torch import nn

from ...ops import coords
from ...ops import family as F
from ...ops.sparse import SparseTensor, upsample_children_keys
from ..bound import lower_bound
from ..layers import MLP, FamilyConv, FamilyDownConv, FamilyTransposeUp
from . import gaussian
from .bottleneck import FactorizedBottleneck

EPS = 1e-4


def _leaky_relu(x):
    return torch.nn.functional.leaky_relu(x, 0.01)


class MeanScaleHyperprior(nn.Module):
    def __init__(self, C_bottleneck=128, C_hyper_bottleneck=192,
                 quantization_mode="ste", inverse_rescaling=True,
                 quantization_offset=True, adaptive_BN=True, max_batch=8,
                 cap_factors=(1.0, 0.5, 2.0, 4.0)):
        super().__init__()
        C, Ch = C_bottleneck, C_hyper_bottleneck
        self.C_bottleneck = C
        self.inverse_rescaling = inverse_rescaling
        self.quantization_offset = quantization_offset
        self.adaptive_BN = adaptive_BN
        self.max_batch = max_batch
        self.cap_factors = tuple(cap_factors)
        self.ha1 = FamilyConv(C, Ch, 3)
        self.ha2 = FamilyDownConv(Ch, Ch, 3)
        self.ha3 = FamilyDownConv(Ch, Ch, 3)
        self.hs1 = FamilyTransposeUp(Ch, Ch, 2)
        self.hs2 = FamilyTransposeUp(Ch, C * 3 // 2, 2)
        self.hs3 = FamilyConv(C * 3 // 2, C * 2, 3)
        self.bottleneck = FactorizedBottleneck(Ch)
        # flax creates a submodule's parameters only when it is called
        if adaptive_BN:
            self.scale_nn = MLP(2, (8, C // 4, C), final_softplus=True)
            if not inverse_rescaling:
                self.rescale_nn = MLP(2, (8, C // 4, C), final_softplus=True)
        if quantization_offset:
            self.quant_nn = MLP(2, (10, 10, 1))

    def _pyramid(self, y_keys, root_nbr=None, z_caps=None):
        """y(stride 8) -> stride 16 -> stride 32 (z) pyramid."""
        if z_caps is not None:
            cap0, cap1 = z_caps
        else:
            cap0 = int(self.cap_factors[0] * y_keys.shape[0])
            cap1 = int(self.cap_factors[1] * y_keys.shape[0])
        return F.pyramid(y_keys, [cap0, cap1], skip_finest_nbr=True,
                         root_nbr=root_nbr)

    def h_a(self, y: SparseTensor, levels=None):
        levels = levels or self._pyramid(y.keys)

        def fm(l):
            nbr = levels[l + 1]["nbr"]
            return F.FamilyMap(parent_keys=levels[l + 1]["keys"],
                               point_parent=levels[l]["pp"],
                               point_slot=levels[l]["sl"],
                               nbr_idx=nbr[0], nbr_ok=nbr[1])

        t = self.ha1(fm(0), y.feats, y.valid, out_keys_valid=y.valid)
        t = _leaky_relu(t)
        f1 = self.ha2(fm(0), t, y.valid)
        z1 = SparseTensor(keys=levels[1]["keys"], feats=_leaky_relu(f1),
                          stride=y.stride * 2)
        f2 = self.ha3(fm(1), z1.feats, z1.valid)
        return SparseTensor(keys=levels[2]["keys"], feats=f2,
                            stride=z1.stride * 2)

    def h_s_params_at(self, z_hat: SparseTensor, y_keys, levels=None,
                      hs_caps=None):
        """Gaussian params (scales, means) evaluated at the y coordinates.
        hs_caps: static (t1, t2) child-expansion capacities (they truncate,
        exactly as in the JAX package)."""
        levels = levels or self._pyramid(y_keys)
        if hs_caps is not None:
            cap_mid, cap_top = hs_caps
        else:
            cap_mid = int(self.cap_factors[2] * y_keys.shape[0])
            cap_top = int(self.cap_factors[3] * y_keys.shape[0])
        dev = y_keys.device
        z_keys = z_hat.keys
        nbr_z = levels[2]["nbr"]

        t1_keys = upsample_children_keys(z_keys)[:cap_mid]
        f1 = self.hs1(None, z_hat.feats, z_hat.valid)[:cap_mid]
        t1_valid = coords.key_is_valid(t1_keys)
        f1 = _leaky_relu(f1) * t1_valid[:, None]
        ar1 = torch.arange(t1_keys.shape[0], dtype=torch.int32, device=dev)
        nbr_t1 = F.derive_self_neighbors(t1_keys, ar1 >> 3, ar1 & 7, nbr_z)

        t2_keys = upsample_children_keys(t1_keys)[:cap_top]
        f2 = self.hs2(None, f1, t1_valid)[:cap_top]
        t2_valid = coords.key_is_valid(t2_keys)
        f2 = _leaky_relu(f2) * t2_valid[:, None]
        ar2 = torch.arange(t2_keys.shape[0], dtype=torch.int32, device=dev)
        fm_t2 = F.FamilyMap(parent_keys=t1_keys, point_parent=ar2 >> 3,
                            point_slot=ar2 & 7, nbr_idx=nbr_t1[0],
                            nbr_ok=nbr_t1[1])

        y_valid = coords.key_is_valid(y_keys)
        s16_keys = levels[1]["keys"]
        s16_valid = coords.key_is_valid(s16_keys)
        t1_brick = F.member_brick(ar1 >> 3, ar1 & 7, t1_valid,
                                  z_keys.shape[0], t1_keys.shape[0])
        cross = F.derive_neighbors(levels[1]["pp"], levels[1]["sl"],
                                   s16_valid, nbr_z, t1_brick,
                                   t1_keys.shape[0])
        fm_y = F.FamilyMap(parent_keys=s16_keys,
                           point_parent=levels[0]["pp"],
                           point_slot=levels[0]["sl"],
                           nbr_idx=cross[0], nbr_ok=cross[1])
        out = self.hs3(fm_t2, f2, t2_valid, out_fm=fm_y,
                       out_keys_valid=y_valid, nbr_cross=cross)
        scales, means = torch.chunk(out, 2, dim=1)
        return scales, means

    def gains(self, q, y_batch, y_valid):
        """Per-point (scale, rescale) gain vectors from quality q [B, 2]."""
        C = self.C_bottleneck
        if not self.adaptive_BN:
            ones = torch.ones((y_batch.shape[0], C), device=y_batch.device)
            return ones, ones
        scale_b = self.scale_nn(q.float()) + EPS  # [B, C]
        b = y_batch.clamp(0, q.shape[0] - 1).to(torch.int64)
        scale = scale_b[b]
        if self.inverse_rescaling:
            rescale = 1.0 / scale
        else:
            rescale = (1.0 / (self.rescale_nn(q.float()) + EPS))[b]
        m = y_valid[:, None].float()
        return scale * m + (1 - m), rescale * m + (1 - m)

    def offsets(self, stddev, scale):
        """Quantization-reconstruction offsets from (gain, stddev) pairs."""
        inp = torch.stack([scale, stddev], dim=-1)  # [N, C, 2]
        return self.quant_nn(inp)[..., 0]

    def decode_params_device(self, y_keys, z_sym, q, z_keys=None,
                             root_nbr=None, z_caps=None, hs_caps=None):
        """Decoder graph after the z symbols are entropy-decoded: z
        coordinates from the y coordinates, z_hat, h_s, gains and the rANS
        scale indexes.  The encoder runs this same graph."""
        levels = self._pyramid(y_keys, root_nbr=root_nbr, z_caps=z_caps)
        if z_keys is None:
            z_keys = levels[2]["keys"]
        med = self.bottleneck.medians()
        z_valid = coords.key_is_valid(z_keys)
        z_hat = SparseTensor(keys=z_keys,
                             feats=(z_sym.float() + med[None, :])
                             * z_valid[:, None],
                             stride=32)
        scales_hat, means_hat = self.h_s_params_at(z_hat, y_keys, levels,
                                                   hs_caps=hs_caps)
        y_valid = coords.key_is_valid(y_keys)
        y_batch = coords.key_batch(y_keys)
        scale, rescale = self.gains(q, y_batch, y_valid)
        indexes = gaussian.build_indexes(scales_hat * scale).to(torch.uint8)
        return {"indexes": indexes, "scales_hat": scales_hat,
                "means_hat": means_hat, "scale": scale, "rescale": rescale,
                "y_valid": y_valid,
                # stride-16 structure for the synthesis graph (saves its
                # root search)
                "y_struct": {"parent_keys": levels[1]["keys"],
                             "pp": levels[0]["pp"], "sl": levels[0]["sl"],
                             "nbr_idx": levels[1]["nbr"][0],
                             "nbr_ok": levels[1]["nbr"][1]}}

    def dequantize_y_device(self, y_sym, dec):
        """Turn decoded integer y symbols into y_hat features."""
        q_val = y_sym.float()
        if self.quantization_offset:
            q_abs, signs = torch.abs(q_val), torch.sign(q_val)
            stdev = lower_bound(dec["scales_hat"] * dec["scale"],
                                gaussian.SCALE_MIN)
            offs = -self.offsets(stdev, dec["scale"])
            offs = torch.where(q_abs < EPS, 0.0, offs)
            y_hat = signs * (q_abs + offs)
            y_hat = y_hat * dec["rescale"] + dec["means_hat"]
        else:
            y_hat = (q_val + dec["means_hat"] * dec["scale"]) * dec["rescale"]
        return y_hat * dec["y_valid"][:, None]
