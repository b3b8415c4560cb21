"""Exact per-batch top-k selection and pruning on flat sparse tensors
(frozen plain copy: ``topk_mask`` is ``topk_mask_plain`` on every device).

Radix select: 4 passes of 256-bin per-batch histograms walk down the
32-bit order-preserving image of the logits to the exact k-th largest
value of every batch; ties at the threshold are filled by position (first
wins).
"""

import torch

from . import coords as C
from .sparse import SparseTensor, compact


def _float_to_ordered_int(x):
    """Monotone bijection f32 -> int64 in [0, 2^32): flip the sign bit for
    positives, all bits for negatives (-0.0 and +0.0 stay distinct)."""
    bits = x.to(torch.float32).contiguous().view(torch.int32)
    b = bits.to(torch.int64) & 0xFFFFFFFF
    return torch.where(bits < 0, (~b) & 0xFFFFFFFF, b | 0x80000000)


def _per_batch_count(b, weight, maxb):
    """int64 [maxb]: sum of ``weight`` per batch index b (b == maxb is the
    dump bin)."""
    out = torch.zeros(maxb + 1, dtype=torch.int64, device=b.device)
    out.index_add_(0, b, weight.to(torch.int64))
    return out[:maxb]


def topk_mask_plain(keys, logits, k_per_batch):
    """Plain PyTorch version of ``topk_mask`` (same mask bit for bit)."""
    maxb = k_per_batch.shape[0]
    dev = keys.device
    valid = C.key_is_valid(keys)
    bc = C.key_batch(keys).to(torch.int64).clamp(0, maxb - 1)
    b = torch.where(valid, bc, maxb)
    u = torch.where(valid, _float_to_ordered_int(logits), -1)
    k = k_per_batch.to(torch.int64).clamp(min=0)
    bins_ids = torch.arange(256, dtype=torch.int64, device=dev)
    prefix = torch.zeros(maxb, dtype=torch.int64, device=dev)
    krem = k.clone()
    for j in range(4):
        shift = 24 - 8 * j
        hi_match = (u >> (shift + 8)) == (prefix >> (shift + 8))[bc]
        active = hi_match & valid
        bins = (u >> shift) & 255
        hist = torch.zeros(maxb * 256 + 1, dtype=torch.int64, device=dev)
        hist.index_add_(0, torch.where(active, bc * 256 + bins, maxb * 256),
                        torch.ones_like(bins))
        hist = hist[:-1].reshape(maxb, 256)
        # desc[t] = count of active elements in bins > t
        desc = torch.flip(torch.cumsum(torch.flip(hist, [1]), 1), [1]) - hist
        hit = (desc < krem[:, None]) & (desc + hist >= krem[:, None])
        any_hit = hit.any(1)
        t = torch.where(hit, bins_ids, 256).amin(1).clamp(max=255)
        new_prefix = prefix | (t << shift)
        new_krem = krem - torch.gather(desc, 1, t[:, None])[:, 0]
        prefix = torch.where(any_hit, new_prefix, prefix)
        krem = torch.where(any_hit, new_krem.clamp(min=0), krem)
    thr = torch.where(k > 0, prefix, 1 << 32)
    gt = (u > thr[bc]) & valid
    tie = (u == thr[bc]) & valid
    n_gt = _per_batch_count(b, gt, maxb)
    ties_per_batch = _per_batch_count(b, tie, maxb)
    need = (k - n_gt).clamp(min=0)
    # rank ties within each batch by position: slots are batch-major
    # sorted, so a global cumsum minus the batch's prior-tie total
    onehot_tie = tie.to(torch.int64)
    before_this = torch.cumsum(onehot_tie, 0) - onehot_tie
    prior = torch.cumsum(ties_per_batch, 0) - ties_per_batch
    rank_in_batch = before_this - prior[bc]
    fill = tie & (rank_in_batch < need[bc])
    return gt | fill


def topk_mask(st: SparseTensor, logits, k_per_batch, plan=None):
    """Boolean mask of the top-k(batch) logits within each batch.

    st: the candidate set (its keys give validity and batch); logits: f32
    [N]; k_per_batch: int [maxb].  Invalid slots never win; k <= 0 keeps
    nothing.  ``plan`` is accepted and ignored."""
    return topk_mask_plain(st.keys, logits, k_per_batch)


def prune(st: SparseTensor, keep, capacity=None):
    """Drop slots where keep is False; stable compaction keeps keys sorted."""
    capacity = capacity or st.capacity
    keys, feats = compact(st.keys, keep & st.valid, st.feats)
    return SparseTensor(keys=keys[:capacity], feats=feats[:capacity],
                        stride=st.stride)
