"""Rate-distortion losses on flat sparse tensors (the JAX package's
``training/loss.py``):

  * BPPLoss        sum(-log2 lik) / number of input points, per stream;
  * ColorLoss      L1/L2 on colors at GT voxels present in the prediction,
                   weighted by lambda_A of the point's batch item;
  * Multiscale_FocalLoss  focal loss on each level's occupancy logits
                   against the GT pyramid's key sets, weighted by lambda_G;
  * ShepardsLoss   color loss against GT colors interpolated onto the
                   predicted coordinates (inverse-distance window, one
                   channelwise sparse conv, ``ops/conv.py``).

Key-set intersections are exact sorted-key lookups; every reduction is
masked (padding slots add nothing).
"""

import math

import numpy as np
import torch

from ..ops import coords as C
from ..ops.conv import apply_channelwise_conv
from ..ops.sparse import SparseTensor, features_at, lookup


def _masked_mean(x, mask):
    m = mask.to(x.dtype)
    if x.dim() > m.dim():
        m = m[:, None]
    return torch.sum(x * m) / torch.clamp(
        torch.sum(m) * (x.numel() // mask.numel()), min=1.0)


def bpp_loss(likelihoods, num_points, weight=1.0):
    """Bits per ground-truth point of one likelihood stream [N, C]."""
    bits = torch.sum(torch.log(likelihoods)) / (-math.log(2.0))
    return weight * bits / torch.clamp(num_points, min=1.0)


def _lam(q_map, batch, col, max_batch):
    return q_map[batch.clamp(0, max_batch - 1).to(torch.int64), col]


def color_loss(gt: SparseTensor, pred: SparseTensor, q_map, kind="L2",
               max_batch=8):
    """Distortion of predicted colors at GT voxels present in the
    prediction."""
    _, found = lookup(pred, gt.keys)
    diff = gt.feats - features_at(pred, gt.keys)
    err = torch.abs(diff) if kind == "L1" else diff * diff
    lam = _lam(q_map, gt.batch, 1, max_batch)
    return _masked_mean(err * lam[:, None], found & gt.valid)


def focal_loss(candidates, logits_list, gt_pyramid, q_map, alpha=0.5,
               gamma=2.0, max_batch=8):
    """Per-level occupancy focal loss over candidate voxels."""
    total = 0.0
    for cand, logits, gt_keys in zip(candidates, logits_list, gt_pyramid):
        idx = torch.searchsorted(gt_keys, cand.keys).clamp(
            max=gt_keys.shape[0] - 1)
        occupied = (gt_keys[idx] == cand.keys) & cand.valid
        zero = torch.zeros((), dtype=logits.dtype, device=logits.device)
        p = torch.clamp(torch.where(
            occupied, torch.exp(-torch.logaddexp(zero, -logits)),
            torch.exp(-torch.logaddexp(zero, logits))), 1e-2, 1.0)
        a = torch.where(occupied, alpha, 1.0 - alpha)
        fl = -a * (1.0 - p) ** gamma * torch.log(p)
        lam = _lam(q_map, cand.batch, 0, max_batch)
        total = total + _masked_mean(fl * lam, cand.valid)
    return total


def shepards_window(window_size, p):
    """Inverse-distance ball window, flat [window_size^3] f32."""
    r = window_size // 2
    g = np.arange(window_size) - r
    zz, yy, xx = np.meshgrid(g, g, g, indexing="ij")
    dist = np.sqrt(xx ** 2 + yy ** 2 + zz ** 2)
    w = 1.0 / (dist ** p + 1e-5)
    w[dist > r] = 0.0
    return w.reshape(-1).astype(np.float32)


def shepards_loss(gt: SparseTensor, pred: SparseTensor, q_map, kind="L2",
                  window_size=9, p=8, max_batch=8):
    """Color loss against GT colors interpolated to the predicted
    coordinates: one channelwise conv over [valid, colors] gives the
    weighted sums and the weight total at once; exact GT colors where a
    predicted voxel is a GT voxel."""
    offs = C.kernel_offsets(window_size)
    w = torch.as_tensor(shepards_window(window_size, p),
                        device=gt.feats.device)
    ncolor = gt.feats.shape[1]
    gt_aug = gt.replace(feats=torch.cat(
        [gt.valid[:, None].to(gt.feats.dtype), gt.feats], dim=1))
    wk = w[:, None].expand(-1, ncolor + 1)
    interp = apply_channelwise_conv(gt_aug, pred.keys, wk, offs, "same",
                                    pred.stride)
    denom = interp.feats[:, :1]
    colors = interp.feats[:, 1:] / torch.clamp(denom, min=1e-8)
    valid = pred.valid & (denom[:, 0] > 1e-8)
    _, exact = lookup(gt, pred.keys)
    gt_colors = torch.where(exact[:, None], features_at(gt, pred.keys),
                            colors)
    diff = gt_colors - pred.feats
    err = torch.abs(diff) if kind == "L1" else diff * diff
    lam = _lam(q_map, pred.batch, 1, max_batch)
    return _masked_mean(err * lam[:, None], valid)


class Loss:
    """Config-driven loss registry: {name: {type: ..., options}}."""

    def __init__(self, config, max_batch=8):
        self.config = dict(config)
        self.max_batch = max_batch

    def __call__(self, gt: SparseTensor, out):
        num_points = torch.sum(gt.valid.to(torch.float32))
        losses = {}
        total = 0.0
        for ident, cfg in self.config.items():
            kind = cfg["type"]
            if kind == "BPPLoss":
                val = bpp_loss(out["likelihoods"][cfg["key"]], num_points,
                               cfg.get("weight", 1.0))
            elif kind == "ColorLoss":
                val = color_loss(gt, out["prediction"], out["q_map"],
                                 cfg.get("loss", "L2"), self.max_batch)
            elif kind == "Multiscale_FocalLoss":
                val = focal_loss(out["candidates"], out["occ_logits"],
                                 out["gt_pyramid"], out["q_map"],
                                 cfg.get("alpha", 0.5), cfg.get("gamma", 2.0),
                                 self.max_batch)
            elif kind == "ShepardsLoss":
                val = shepards_loss(gt, out["prediction"], out["q_map"],
                                    cfg.get("loss", "L2"),
                                    cfg.get("window_size", 9),
                                    cfg.get("p", 8), self.max_batch)
            else:
                raise ValueError(f"unknown loss type {kind}")
            losses[ident] = val
            total = total + val
        return total, losses
