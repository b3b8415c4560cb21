"""Coded-occupancy refinement: the lossless-geometry mode.

The top-k synthesis prunes by ranking the occupancy logits; this mode
instead entropy-codes the true occupancy bit of every candidate with the
learned logit as the coding context, so geometry decodes exactly and the
rate cost is the cross-entropy of the heads.

Split of labor (deterministic and shared bit for bit by encoder and
decoder):
 - device: staged synthesis passes (``UnifiedModel.decode_refine_device``)
   emit per-candidate logits, quantized on the device to uint8 context
   bins (one byte per candidate crosses to the host);
 - host: candidate keys are never fetched — children of the selected
   parent set are enumerated here with the same ``morton << 3 | slot`` rule
   as ``ops/sparse.upsample_children_keys``, and the selected set is
   carried level to level;
 - host: occupancy bits are coded by ``coding/occ.py``.
"""

import numpy as np
import torch

from ..coding.rans import pmf_to_quantized_cdf
from ..ops.coords import BATCH_SHIFT

# Logit context binning: 32 bins over the clipped logit range.  sigmoid
# saturates past +-8, so clipping costs no usable probability resolution;
# bin probabilities are clamped away from {0, 1} so a coder never sees a
# zero-frequency symbol.
LOGIT_LO = -8.0
LOGIT_HI = 8.0
N_BINS = 32
_P_MIN = 1.0 / 4096.0


def bin_logits(logits):
    """uint8 context bin of each candidate logit (a torch tensor): clip,
    scale, truncate toward zero, cap at the last bin."""
    t = (torch.clamp(logits, LOGIT_LO, LOGIT_HI) - LOGIT_LO) \
        / (LOGIT_HI - LOGIT_LO)
    return torch.clamp((t * N_BINS).to(torch.int32), max=N_BINS - 1
                       ).to(torch.uint8)


def bin_probabilities():
    """Representative occupancy probability of each context bin."""
    w = (LOGIT_HI - LOGIT_LO) / N_BINS
    centers = LOGIT_LO + (np.arange(N_BINS) + 0.5) * w
    p = 1.0 / (1.0 + np.exp(-centers))
    return np.clip(p, _P_MIN, 1.0 - _P_MIN)


def _tables_from_probs(probs, precision=16):
    """Binary CDF tables (one per context bin) in the rANS coder's
    (cdf, cdf_length, offset) convention — symbols are {0, 1}."""
    cdfs = np.zeros((len(probs), 4), np.int32)
    lengths = np.zeros((len(probs),), np.int32)
    for i, p in enumerate(probs):
        qc = pmf_to_quantized_cdf([1.0 - p, p], _P_MIN, precision)
        cdfs[i, :len(qc)] = qc
        lengths[i] = len(qc)
    return {"cdf": cdfs, "cdf_length": lengths,
            "offset": np.zeros((len(probs),), np.int32)}


def build_occ_cdf_tables(precision=16):
    """Static tables: sigmoid of each bin center.  The v6 container codes
    occupancy with the adaptive coder of ``coding/occ.py``; these stay for
    rate comparisons."""
    return _tables_from_probs(bin_probabilities(), precision)


# Per-frame measured tables: 12-bit quantized per-bin occupancy frequency.
TABLE_SCALE = 4096


def quantize_tables(occ, bins):
    """uint16[N_BINS] quantized empirical P(occ=1 | bin) for one level,
    KT-smoothed so empty and rare bins stay sane."""
    occ = np.asarray(occ, np.float64)
    bins = np.asarray(bins, np.int64)
    n = np.bincount(bins, minlength=N_BINS).astype(np.float64)[:N_BINS]
    k = np.bincount(bins, weights=occ, minlength=N_BINS)[:N_BINS]
    p = (k + 0.5) / (n + 1.0)
    pq = np.clip(np.round(p * TABLE_SCALE), 1, TABLE_SCALE - 1)
    return pq.astype(np.uint16)


def tables_from_quantized(pq, precision=16):
    """rANS tables for one level from a container's quantized row."""
    p = np.clip(np.asarray(pq, np.float64) / TABLE_SCALE,
                _P_MIN, 1.0 - _P_MIN)
    return _tables_from_probs(p, precision)


def children_np(parent_keys):
    """All 8 children of each (valid, sorted) parent key, flat parent-major
    order — the host mirror of ``ops/sparse.upsample_children_keys`` minus
    the padding rows (parents here are exact arrays, not capacity-padded)."""
    parent_keys = np.asarray(parent_keys, np.int64)
    key_mask = (np.int64(1) << np.int64(BATCH_SHIFT)) - 1
    bbits = parent_keys & ~key_mask
    m = parent_keys & key_mask
    child = bbits[:, None] | ((m[:, None] << 3)
                              | np.arange(8, dtype=np.int64)[None, :])
    return child.reshape(-1)


def occupancy_np(cand_keys, gt_sorted):
    """Membership of each candidate key in the sorted true level set."""
    cand_keys = np.asarray(cand_keys, np.int64)
    gt_sorted = np.asarray(gt_sorted, np.int64)
    if len(gt_sorted) == 0:
        return np.zeros(len(cand_keys), bool)
    idx = np.minimum(np.searchsorted(gt_sorted, cand_keys),
                     len(gt_sorted) - 1)
    return gt_sorted[idx] == cand_keys
