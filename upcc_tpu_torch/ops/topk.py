"""Exact per-batch top-k selection and pruning on flat sparse tensors.

Radix select: 4 passes of 256-bin per-batch histograms walk down the
32-bit order-preserving image of the logits to the exact k-th largest
value of every batch; ties at the threshold are filled by position (first
wins), identically on encoder and decoder.  ``topk_mask`` is kernel K2 on
the card (``csrc/topk.cu``, one cooperative launch planned by
``topk_plan``) and ``topk_mask_plain`` on the CPU.
"""

import ctypes
import functools
from typing import NamedTuple

import torch

from .. import kernels
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


# csrc/topk.cu: a block takes 4096 candidates a step, keeps 256-bin
# histograms of a window of 4 batches and 5 int32 arrays per batch in
# shared memory, and, resident, 6 bytes per candidate of its slice (on the
# card the wrapper holds a plan's shared memory to the library's count)
TOPK_CHUNK = 4096
TOPK_WIN = 4
TOPK_STATIC_SMEM = 1024  # bytes kept for the kernel's static shared memory


class TopkPlan(NamedTuple):
    resident: bool   # slices kept in shared memory (else re-read per phase)
    grid: int        # blocks, one per SM at most, all resident at once
    per_block: int   # candidates of one block's slice, a multiple of 4096
    smem: int        # dynamic shared memory bytes of one block
    hist: int        # int32 histogram words, kept zero: 4 passes x maxb x 256


def topk_smem(maxb, per_block, resident):
    """Dynamic shared memory of one K2 block."""
    per_batch = 4 * (-(-5 * maxb // 4) * 4)  # 5 int32 arrays, 16-aligned
    return (TOPK_WIN * 256 * 4 + per_batch
            + (6 * per_block if resident else 0))


@functools.lru_cache(maxsize=256)
def topk_plan(n, maxb, sm_count, smem_optin):
    """Launch plan of kernel K2 for n candidates and maxb batches on a card
    with ``sm_count`` SMs whose blocks may opt in to ``smem_optin`` bytes of
    shared memory: one block per SM, each over an equal slice rounded up to
    4096 candidates; resident when a slice fits the shared memory left."""
    per_block = max(1, -(-n // (sm_count * TOPK_CHUNK))) * TOPK_CHUNK
    room = (smem_optin - TOPK_STATIC_SMEM - topk_smem(maxb, 0, False)) \
        // 6 // TOPK_CHUNK * TOPK_CHUNK
    resident = per_block <= room
    grid = max(1, -(-n // per_block))
    return TopkPlan(resident, grid, per_block,
                    topk_smem(maxb, per_block, resident), 4 * 256 * maxb)


_fits = {}  # (device, resident, maxb, per_block) -> (smem, blocks per SM)
# (device index, stream) -> int32 buffers on that stream, grown as needed:
# K2's histograms, which it leaves zero (calls on one stream run one after
# another), and its per-block tie totals, which need no initial value
_hist = {}
_totals = {}


def _check_fit(plan, maxb, device, sms):
    """Ask the library (once per shape) for the shared memory of the plan's
    blocks, which must be the planner's, and how many fit an SM: a
    cooperative grid must be resident at once."""
    key = (device, plan.resident, maxb, plan.per_block)
    if key not in _fits:
        smem, blocks = ctypes.c_int64(), ctypes.c_int64()
        kernels.check(kernels.lib("topk_mask").upcc_topk_fit(
            int(plan.resident), maxb, plan.per_block, ctypes.byref(smem),
            ctypes.byref(blocks)), "upcc_topk_fit")
        _fits[key] = smem.value, blocks.value
    smem, blocks = _fits[key]
    if plan.smem != smem:
        raise ValueError(f"topk_mask: the plan's {plan.smem} bytes of shared "
                         f"memory differ from the kernel's {smem}")
    if plan.grid > blocks * sms:
        raise ValueError(f"topk_mask: grid {plan.grid} exceeds the "
                         f"{blocks} x {sms} blocks the card holds at once")


def _buffer(store, key, size, device):
    buf = store.get(key)
    if buf is None or buf.numel() < size:
        buf = store[key] = torch.zeros(size, dtype=torch.int32, device=device)
    return buf


def topk_mask(st: SparseTensor, logits, k_per_batch, plan=None):
    """Boolean mask of the top-k(batch) logits within each batch.

    st: the candidate set (its keys give validity and batch); logits: f32
    [N]; k_per_batch: int [maxb].  Invalid slots never win; k <= 0 keeps
    nothing.  On CUDA tensors this launches kernel K2 with ``plan`` (a
    ``TopkPlan``; default ``topk_plan`` for the card)."""
    keys = st.keys
    if not keys.is_cuda:
        return topk_mask_plain(keys, logits, k_per_batch)
    n = keys.shape[0]
    maxb = k_per_batch.shape[0]
    kernels.require_cuda(keys, torch.int64, 1, "topk keys")
    kernels.require_cuda(logits, torch.float32, 1, "topk logits")
    k32 = k_per_batch.to(device=keys.device, dtype=torch.int32).contiguous()
    if logits.shape[0] != n or not 1 <= maxb <= 1024 or n >= 2 ** 31:
        raise ValueError("topk_mask: logits must match keys, 1 <= maxb <= "
                         "1024, n < 2^31")
    out = torch.empty(n, dtype=torch.bool, device=keys.device)
    if n == 0:
        return out
    sms, optin = kernels.device_limits(keys.device)
    if plan is None:
        plan = topk_plan(n, maxb, sms, optin)
    _check_fit(plan, maxb, keys.device, sms)
    stream = kernels.stream_ptr(keys)
    key = (keys.device.index, stream)
    hist = _buffer(_hist, key, plan.hist, keys.device)
    totals = _buffer(_totals, key, plan.grid, keys.device)
    kernels.count_launch("topk_mask", keys, logits, k32)
    kernels.check(kernels.lib("topk_mask").upcc_topk_mask(
        keys.data_ptr(), logits.data_ptr(), k32.data_ptr(), n, maxb,
        int(plan.resident), plan.grid, plan.per_block, hist.data_ptr(),
        totals.data_ptr(), out.data_ptr(), stream), "topk_mask")
    return out


def prune(st: SparseTensor, keep, capacity=None):
    """Drop slots where keep is False; stable compaction keeps keys sorted."""
    capacity = capacity or st.capacity
    keys, feats = compact(st.keys, keep & st.valid, st.feats)
    return SparseTensor(keys=keys[:capacity], feats=feats[:capacity],
                        stride=st.stride)
