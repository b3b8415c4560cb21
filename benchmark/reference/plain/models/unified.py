"""UnifiedModel: the joint geometry+attribute codec model.

``forward`` is the training pass (g_a -> hyperprior -> g_s, returning what
the loss reads) and ``aux_loss`` the bottleneck's quantile loss.  The
device methods the codec calls: the analysis transform, the hyper
analysis with z rounding, the decoder's params graph (run by the encoder
too), y symbol extraction, dequantization + synthesis, and the staged
synthesis of the coded-occupancy mode.
"""

from typing import Any, Dict

import numpy as np
import torch
from torch import nn

from ..ops import family as F
from ..ops.sparse import SparseTensor, downsample_keys
from .entropy.hyperprior import MeanScaleHyperprior
from .transforms import AnalysisTransform, SparseSynthesisTransform


def host_root_maps(keys_np, config, device="cpu"):
    """Host-computed root 27-neighbourhood maps of the training forward
    ({'ga': (idx, ok), 'z': (idx, ok)} on ``device``).  The caps mirror
    g_a's fractional pyramid and the hyperprior's exactly: truncation
    happens at every level, so the host chain passes the same per-level
    capacities."""
    cap = len(keys_np)
    ga_factors = config["g_a"].get("cap_factors", (0.5, 0.25, 0.125))
    floor = min(cap, 8192)
    ga_caps = [max(int(f * cap), floor) for f in ga_factors]
    _, gi, go = F.host_root_neighbors(np.asarray(keys_np), 4, ga_caps[2],
                                      ga_caps + [ga_caps[2]])
    zf = config["entropy_model"].get("cap_factors", (1.0, 0.5, 2.0, 4.0))
    ycap = ga_caps[2]
    zcaps = [int(zf[0] * ycap), int(zf[1] * ycap)]
    _, zi, zo = F.host_root_neighbors(np.asarray(keys_np), 5, zcaps[1],
                                      ga_caps + zcaps)
    as_t = lambda a: torch.from_numpy(a).to(device)
    return {"ga": (as_t(gi), as_t(go)), "z": (as_t(zi), as_t(zo))}


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

    def forward(self, x: SparseTensor, q, Lambda, training=True,
                root_nbrs=None, generator=None, oracle_levels=()):
        """x: the input cloud (stride 1, colors in [0, 1] as feats); q and
        Lambda [B, 2]; root_nbrs: host root maps (``host_root_maps``);
        generator: the training noise's; oracle_levels: g_s levels pruned
        by the GT pyramid (the diagnostic oracle of
        ``SparseSynthesisTransform``).  Returns the dict the loss reads:
        prediction, gt_pyramid (stride 4, 2, 1 key sets), candidates,
        occ_logits, q_map, likelihoods {'y', 'z'} and k."""
        root_nbrs = root_nbrs or {}
        xin = occupancy_color_features(x)
        y, k = self.g_a(xin, root_nbr=root_nbrs.get("ga"))
        y_hat, (lik_y, lik_z) = self.entropy_model(
            y, q, training=training, root_nbr=root_nbrs.get("z"),
            generator=generator)
        # the GT pyramid: stride-2 key downsamples of the input
        p1 = downsample_keys(x.keys)
        p2 = downsample_keys(p1)
        gt_pyramid = [p2, p1, x.keys]
        x_hat, candidates, occ_logits = self.g_s(
            y_hat, k, oracle_gt=gt_pyramid if oracle_levels else None,
            oracle_levels=tuple(oracle_levels))
        return {"prediction": x_hat, "gt_pyramid": gt_pyramid,
                "candidates": candidates, "occ_logits": occ_logits,
                "q_map": Lambda, "likelihoods": {"y": lik_y, "z": lik_z},
                "k": k}

    def aux_loss(self):
        return self.entropy_model.bottleneck.aux_loss()

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
