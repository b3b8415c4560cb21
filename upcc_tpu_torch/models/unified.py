"""UnifiedModel: the joint geometry+attribute codec model (inference half).

The device methods the codec calls: the analysis transform, the hyper
analysis with z rounding, the decoder's params graph (run by the encoder
too), y symbol extraction, dequantization + synthesis, and the staged synthesis of
the coded-occupancy mode.  The training forward is not ported.
"""

from typing import Any, Dict

import torch
from torch import nn

from ..ops.sparse import SparseTensor
from .entropy.hyperprior import MeanScaleHyperprior
from .transforms import AnalysisTransform, SparseSynthesisTransform


def occupancy_color_features(x: SparseTensor):
    """[1, R, G, B] features: constant occupancy + colors."""
    occ = x.valid[:, None].to(x.feats.dtype)
    return x.replace(feats=torch.cat([occ, x.feats], dim=1))


class UnifiedModel(nn.Module):
    def __init__(self, config: Dict[str, Any]):
        super().__init__()
        self.config = config
        mb = config.get("max_batch", 8)
        ga = dict(config["g_a"])
        gs = dict(config["g_s"])
        em = dict(config["entropy_model"])
        em.pop("type", None)
        em.pop("entropy_bottleneck_vbr", None)
        self.g_a = AnalysisTransform(max_batch=mb, **ga)
        self.g_s = SparseSynthesisTransform(max_batch=mb, **gs)
        self.entropy_model = MeanScaleHyperprior(max_batch=mb, **em)

    def ga_device(self, x: SparseTensor, root_nbr=None, level_caps=None,
                  max_batch=None):
        """Encoder front: the analysis transform."""
        xin = occupancy_color_features(x)
        y, k = self.g_a(xin, root_nbr=root_nbr, level_caps=level_caps,
                        max_batch=max_batch)
        return {"y_keys": y.keys, "y_feats": y.feats, "k": k}

    def hyper_analyze_device(self, y_keys, y_feats, root_nbr=None,
                             z_caps=None):
        """h_a + z rounding, on the decoder's y capacity bucket so the z key
        set is identical on both sides.  Symbols are clipped to int16."""
        em = self.entropy_model
        y = SparseTensor(keys=y_keys, feats=y_feats, stride=8)
        z = em.h_a(y, em._pyramid(y_keys, root_nbr=root_nbr, z_caps=z_caps))
        med = em.bottleneck.medians()
        z_sym = torch.clamp(torch.round(z.feats - med[None, :])
                            * z.valid[:, None], -32767, 32767)
        return {"z_keys": z.keys, "z_sym": z_sym.to(torch.int16)}

    def decode_params_device(self, y_keys, z_sym, q, root_nbr=None,
                             z_caps=None, hs_caps=None):
        return self.entropy_model.decode_params_device(
            y_keys, z_sym, q, root_nbr=root_nbr, z_caps=z_caps,
            hs_caps=hs_caps)

    def encode_symbols_device(self, y_feats, dec):
        """Quantize y to integer symbols with the decoder-derived params
        (the operation order ``y*scale - means*scale`` is part of the
        format: rounding a reordered expression flips symbols)."""
        sym = torch.round(y_feats * dec["scale"]
                          - dec["means_hat"] * dec["scale"])
        return torch.clamp(sym * dec["y_valid"][:, None], -32767, 32767
                           ).to(torch.int16)

    def dequantize_y_device(self, y_sym, dec):
        return self.entropy_model.dequantize_y_device(y_sym, dec)

    def decode_reconstruct_device(self, y_keys, y_sym, dec, k,
                                  prune_caps=None, num_levels=3):
        """Decoder back half: dequantize y symbols + synthesis."""
        y_hat_feats = self.entropy_model.dequantize_y_device(y_sym, dec)
        y_hat = SparseTensor(keys=y_keys, feats=y_hat_feats, stride=8)
        x_hat, _, _ = self.g_s(y_hat, k, prune_caps=prune_caps,
                               y_struct=dec.get("y_struct"),
                               num_levels=num_levels)
        return x_hat

    def decode_refine_device(self, y_keys, y_sym, dec, ext_keep=(),
                             num_levels=3, prune_caps=None,
                             emit_last_logits=True):
        """Staged synthesis for the coded-occupancy (lossless-geometry)
        mode (codec/refine.py).  Levels < len(ext_keep) select by the
        externally decoded occupancy masks; with ``emit_last_logits`` the
        pass stops at level ``num_levels-1`` and returns that level's
        occupancy logits (candidate-aligned) for host entropy coding.
        With ``emit_last_logits=False`` (all three masks supplied) it
        returns the final colored reconstruction instead.

        Encoder and decoder must call this with identical shapes and
        dtypes at every stage: the context bins derived from the logits
        have to agree bit for bit, or the occupancy streams desync."""
        y_hat_feats = self.entropy_model.dequantize_y_device(y_sym, dec)
        y_hat = SparseTensor(keys=y_keys, feats=y_hat_feats, stride=8)
        kz = torch.zeros((3, self.config.get("max_batch", 8)),
                         dtype=torch.int32, device=y_keys.device)
        x_hat, _, logits_list = self.g_s(
            y_hat, kz, prune_caps=prune_caps, y_struct=dec.get("y_struct"),
            num_levels=num_levels, ext_keep=ext_keep,
            emit_last_logits=emit_last_logits)
        if emit_last_logits:
            return logits_list[num_levels - 1]
        return x_hat
