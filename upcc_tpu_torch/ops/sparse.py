"""Sorted sparse voxel tensor and the set operations on the codec's path.

``SparseTensor`` is a fixed-capacity, sorted, sentinel-padded array of
Morton keys plus a feature matrix.  ``compact`` is kernel K3 on the card
(``csrc/compact.cu``, one single-pass launch planned by ``compact_plan``)
and its plain PyTorch version on the CPU.
"""

import array
import ctypes
import dataclasses
import functools
import math
import os
import threading
from typing import NamedTuple

import numpy as np
import torch

from .. import kernels
from . import coords as C
from .scan import cumsum_i32


@dataclasses.dataclass
class SparseTensor:
    """keys int64[N] sorted ascending (SENTINEL padding), feats [N, C]
    (zeros at padding slots), stride the tensor stride."""

    keys: torch.Tensor
    feats: torch.Tensor
    stride: int = 1

    @property
    def capacity(self):
        return self.keys.shape[0]

    @property
    def num_channels(self):
        return self.feats.shape[-1]

    @property
    def valid(self):
        return C.key_is_valid(self.keys)

    @property
    def batch(self):
        return C.key_batch(self.keys)

    @property
    def units(self):
        return C.key_units(self.keys)

    def coordinates(self):
        """int32 [N, 4] (batch, x, y, z) in raw (stride-scaled)
        coordinates; batch -1 at padding slots."""
        b = torch.where(self.valid, self.batch.to(torch.int32), -1)
        xyz = self.units * self.stride
        return torch.cat([b[:, None], xyz], dim=1)

    def count(self):
        """Number of valid points (a 0-d int32 tensor)."""
        return self.valid.sum(dtype=torch.int32)

    def counts_per_batch(self, max_batch):
        """int32[max_batch] valid point count per batch index."""
        b = torch.where(self.valid, self.batch.to(torch.int64), max_batch)
        b = b.clamp(0, max_batch)  # batches >= max_batch go to the dump bin
        counts = torch.zeros(max_batch + 1, dtype=torch.int32,
                             device=self.keys.device)
        counts.index_add_(0, b, torch.ones_like(b, dtype=torch.int32))
        return counts[:max_batch]

    def mask_feats(self):
        """feats with padding rows zeroed."""
        return self.feats * self.valid[:, None].to(self.feats.dtype)

    def replace(self, **kw):
        return dataclasses.replace(self, **kw)


def take_rows(x, idx):
    """``x[idx]`` along the first dimension, by ``index_select``: its
    gradient is one ``index_add_``.  Advanced indexing's gradient sorts
    the indices and adds repeats of one index one after another, and the
    gathers of training repeat one index thousands of times (padding and
    clipped rows, every point of a batch item); the repeats carry masked
    zeros, so the sum does not depend on the order."""
    flat = torch.index_select(x, 0, idx.reshape(-1).to(torch.int64))
    return flat.reshape(tuple(idx.shape) + tuple(x.shape[1:]))


def compact_plain(keys, keep, *arrays, out_capacity=None):
    """Plain PyTorch version of ``compact`` (same results bit for bit)."""
    n = keys.shape[0]
    m = out_capacity if out_capacity is not None else n
    dev = keys.device
    if n == 0:
        return (torch.full((m,), C.SENTINEL, dtype=torch.int64, device=dev),
                *[torch.zeros((m,) + a.shape[1:], dtype=a.dtype, device=dev)
                  for a in arrays])
    dest = cumsum_i32(keep) - 1
    # rows past the capacity, and dropped rows, land in the dump slot m
    dest = torch.where(keep & (dest < m), dest, m).to(torch.int64)
    src = torch.full((m + 1,), n, dtype=torch.int32, device=dev)
    src[dest] = torch.arange(n, dtype=torch.int32, device=dev)
    src = src[:m]
    ok = src < n
    srcc = src.clamp(max=n - 1).to(torch.int64)
    out_keys = torch.where(ok, keys[srcc], C.sentinel_like(keys))
    outs = []
    for a in arrays:
        g = a[srcc]
        okr = ok.reshape((m,) + (1,) * (a.dim() - 1))
        outs.append(torch.where(okr, g, torch.zeros((), dtype=g.dtype,
                                                    device=dev)))
    return (out_keys, *outs)


# csrc/compact.cu: blocks of 256 threads, each scanning 4, 8 or 16 keep
# bytes (a tile of 1024, 2048 or 4096 rows, its kept rows listed in int32
# shared memory); at most 8 payloads in one launch's parameter struct
COMPACT_THREADS = 256
COMPACT_TILES = (4096, 2048, 1024)
COMPACT_MAX_PAYLOADS = 8
COMPACT_UNITS = (16, 4, 1)
COMPACT_TAIL_ROWS = 2048  # output rows per tail block, at least
EPOCH_MAX = 2 ** 32 - 1   # status words carry a 32-bit epoch


class CompactPlan(NamedTuple):
    tile: int      # keep bytes a block scans: 256 threads x 4, 8 or 16
    tiles: int     # blocks that scan and move rows: ceil(n / tile)
    tail: int      # blocks after them that write the rows [total, m)
    smem: int      # dynamic shared memory of a block: its kept rows, int32
    status: int    # 64-bit status words a launch uses: one per tile
    units: tuple   # per payload: bytes a lane moves at once
    lanes: tuple   # per payload: lanes that move one row together
    groups: tuple  # (first, end) payloads of each launch, keys in the first


def alignment(t):
    """The largest power of two, at most 16, dividing the tensor's address."""
    ptr = t.data_ptr() | 16
    return ptr & -ptr


@functools.lru_cache(maxsize=256)
def compact_plan(n, m, rows, sms, smem_optin):
    """Launch plan of kernel K3 for n candidates, out_capacity m and
    payloads with ``rows`` = ((row bytes, alignment of both pointers), ...)
    on a card with ``sms`` SMs whose blocks may opt in to ``smem_optin``
    bytes of shared memory.  The largest tile that still gives 4 blocks
    per SM (the smallest where none does); tail blocks for up to m rows,
    at most two per SM; per payload the widest unit dividing its row bytes
    and alignment, and the power of two of lanes covering a row's units
    (at most 32, which then loop over the row); 8 payloads a launch."""
    fit = [t for t in COMPACT_TILES if 4 * t <= smem_optin]
    tile = next((t for t in fit if -(-n // t) >= 4 * sms), fit[-1])
    units, lanes = [], []
    for row_bytes, align in rows:
        unit = next(u for u in COMPACT_UNITS
                    if row_bytes % u == 0 and align % u == 0)
        units.append(unit)
        lanes.append(min(32, 1 << max(0, row_bytes // unit - 1).bit_length()))
    groups = tuple((i, min(i + COMPACT_MAX_PAYLOADS, len(rows)))
                   for i in range(0, len(rows), COMPACT_MAX_PAYLOADS))
    tiles = -(-n // tile)
    return CompactPlan(tile, tiles,
                       min(2 * sms, max(1, -(-m // COMPACT_TAIL_ROWS))),
                       4 * tile, tiles, tuple(units), tuple(lanes),
                       groups or ((0, 0),))


_compact_fits = {}  # (device, tile) -> (smem, blocks per SM)
# (device index, stream) -> [int64 status words, last epoch handed out]:
# K3's tile status on that stream, grown as needed; a word counts only in
# the launch whose epoch it carries, so no launch clears it
_status = {}
_status_lock = threading.Lock()


def _status_words(store, key, words, device):
    """The status buffer of ``key`` (at least ``words`` long) and a new
    epoch for one launch; zeroed when the epochs run out."""
    with _status_lock:
        entry = store.get(key)
        if entry is None or entry[0].numel() < words:
            entry = store[key] = [
                torch.zeros(max(words, 1), dtype=torch.int64, device=device),
                entry[1] if entry is not None else 0]
        if entry[1] >= EPOCH_MAX:
            entry[0].zero_()
            entry[1] = 0
        entry[1] += 1
        return entry[0], entry[1]


def _check_compact_fit(plan, device):
    """Ask the library (once per tile size) for a block's shared memory,
    which must be the planner's, and whether a block fits an SM."""
    key = (device, plan.tile)
    if key not in _compact_fits:
        smem, blocks = ctypes.c_int64(), ctypes.c_int64()
        kernels.check(kernels.lib("compact").upcc_compact_fit(
            plan.tile, ctypes.byref(smem), ctypes.byref(blocks)),
            "upcc_compact_fit")
        _compact_fits[key] = smem.value, blocks.value
    smem, blocks = _compact_fits[key]
    if plan.smem != smem or blocks < 1:
        raise ValueError(f"compact: the plan's {plan.smem} bytes of shared "
                         f"memory differ from the kernel's {smem}, or no "
                         f"block fits an SM ({blocks})")


def compact_grad(keep, grad_out, m):
    """The gradient of one ``compact`` payload at its source rows: the
    output gradient at each kept row's rank (the inclusive prefix count of
    ``keep``, less one), zero at dropped rows and at rows past ``m``.  The
    transpose of the compaction; plain torch (a gather)."""
    dest = cumsum_i32(keep) - 1
    ok = keep & (dest < m)
    g = grad_out[dest.clamp(0, max(m - 1, 0)).to(torch.int64)] if m else \
        grad_out.new_zeros((keep.shape[0],) + grad_out.shape[1:])
    okr = ok.reshape((-1,) + (1,) * (grad_out.dim() - 1))
    return torch.where(okr, g, torch.zeros((), dtype=g.dtype,
                                           device=g.device))


class _Compact(torch.autograd.Function):
    """``compact`` with gradients to the payloads that need them."""

    @staticmethod
    def forward(ctx, keys, keep, m, *arrays):
        ctx.save_for_backward(keep)
        ctx.m = m
        outs = _compact(keys, keep, *arrays, out_capacity=m)
        ctx.mark_non_differentiable(*[o for o in outs
                                      if not o.is_floating_point()])
        return outs

    @staticmethod
    def backward(ctx, *grads):
        (keep,) = ctx.saved_tensors
        need = ctx.needs_input_grad[3:]
        return (None, None, None, *[
            compact_grad(keep, g, ctx.m) if n and g is not None else None
            for n, g in zip(need, grads[1:])])


def compact(keys, keep, *arrays, out_capacity=None):
    """Stable compaction: move kept rows to the front, sentinel/zero the tail.

    keys: sorted int64 [n]; keep: bool [n]; arrays: payloads with n rows.
    Output rows are truncated at ``out_capacity`` (default n).  Because the
    input keys are sorted and the compaction is stable, the output stays
    sorted.  On a CUDA tensor this launches kernel K3 (one launch for up to
    8 payloads, planned by ``compact_plan``); on a CPU tensor it runs
    ``compact_plain``.  With gradients on, a payload that requires one gets
    it back through ``compact_grad``."""
    m = out_capacity if out_capacity is not None else keys.shape[0]
    if torch.is_grad_enabled() and any(a.requires_grad for a in arrays):
        return _Compact.apply(keys, keep, m, *arrays)
    return _compact(keys, keep, *arrays, out_capacity=m)


def _compact(keys, keep, *arrays, out_capacity=None):
    if not keys.is_cuda:
        return compact_plain(keys, keep, *arrays, out_capacity=out_capacity)
    n = keys.shape[0]
    m = out_capacity if out_capacity is not None else n
    kernels.require_cuda(keys, torch.int64, 1, "compact keys")
    kernels.require_cuda(keep, torch.bool, 1, "compact keep")
    if keep.shape[0] != n or n >= 2 ** 31 or not 0 <= m < 2 ** 31:
        raise ValueError("compact: keep must match keys; n, m < 2^31")
    dev = keys.device
    for a in arrays:
        if a.device != dev or not a.is_contiguous() or a.shape[0] != n:
            raise ValueError("compact: payloads must be contiguous tensors on "
                             "the keys' device with one row per key")
    out_keys = torch.empty(m, dtype=torch.int64, device=dev)
    outs = [torch.empty((m,) + a.shape[1:], dtype=a.dtype, device=dev)
            for a in arrays]
    # zero-width payloads have nothing to move
    moving = [(a, o, math.prod(a.shape[1:]) * a.element_size())
              for a, o in zip(arrays, outs)]
    moving = [(a, o, rb) for a, o, rb in moving if rb]
    if m == 0:
        return (out_keys, *outs)
    plan = compact_plan(n, m, tuple((rb, min(alignment(a), alignment(o)))
                                    for a, o, rb in moving),
                        *kernels.device_limits(dev))
    _check_compact_fit(plan, dev)
    lib = kernels.lib("compact")
    stream = kernels.stream_ptr(keys)
    kernels.count_launch("compact", keys, keep, arrays, m)
    for first, end in plan.groups:
        desc = array.array("q")
        for i in range(first, end):
            a, o, rb = moving[i]
            desc.extend((a.data_ptr(), o.data_ptr(), rb, plan.units[i],
                         plan.lanes[i]))
        status, epoch = _status_words(_status, (dev.index, stream),
                                      plan.status, dev)
        kernels.check(lib.upcc_compact(
            keep.data_ptr(), keys.data_ptr() if first == 0 else None,
            out_keys.data_ptr() if first == 0 else None, n, m, plan.tile,
            plan.tail, status.data_ptr(), epoch, end - first,
            desc.buffer_info()[0], stream), "compact")
    return (out_keys, *outs)


def downsample_keys(keys, capacity=None):
    """Parent keys at 2x stride: morton >> 3, dedup.  Input keys sorted."""
    capacity = capacity or keys.shape[0]
    parent = (keys & ~C.KEY_MASK) | ((keys & C.KEY_MASK) >> 3)
    parent = torch.where(C.key_is_valid(keys), parent, C.sentinel_like(keys))
    dup = torch.zeros_like(parent, dtype=torch.bool)
    dup[1:] = parent[1:] == parent[:-1]
    keep = ~dup & C.key_is_valid(parent)
    (parent,) = compact(parent, keep, out_capacity=capacity)
    return parent


def upsample_children_keys(keys):
    """All 8 children at half stride: morton << 3 | c, int64[8N]; children
    of sorted parents are sorted globally."""
    bbits = keys & ~C.KEY_MASK
    m = keys & C.KEY_MASK
    c = torch.arange(8, dtype=torch.int64, device=keys.device)
    child = bbits[:, None] | ((m[:, None] << 3) | c[None, :])
    child = torch.where(C.key_is_valid(keys)[:, None], child,
                        C.sentinel_like(keys))
    return child.reshape(-1)


def lookup(st: SparseTensor, query_keys):
    """(idx int32, found bool) of query keys in ``st``; idx is clipped to a
    valid gather index even where not found."""
    idx = torch.searchsorted(st.keys, query_keys.contiguous())
    idx = idx.clamp(max=st.capacity - 1)
    found = (st.keys[idx] == query_keys) & C.key_is_valid(query_keys)
    return idx.to(torch.int32), found


def features_at(st: SparseTensor, query_keys):
    """Features of ``st`` at the query keys, zeros where absent."""
    idx, found = lookup(st, query_keys)
    return take_rows(st.feats, idx) * found[:, None].to(st.feats.dtype)


def with_feats(st: SparseTensor, feats, stride=None):
    return SparseTensor(keys=st.keys, feats=feats, stride=stride or st.stride)


def mask_feats(st: SparseTensor):
    return st.mask_feats()


def from_points(batch, xyz, feats, capacity, stride=1, dedup=True):
    """SparseTensor from (batch [N], integer xyz [N, 3], feats [N, C])
    tensors: coordinates quantized to ``stride``, padded to ``capacity``,
    sorted into Morton order (stable), clipped to ``capacity``, then
    duplicate voxels dropped (first occurrence wins).  Rows with batch < 0
    are padding."""
    n = xyz.shape[0]
    units = torch.div(xyz.to(torch.int32), stride, rounding_mode="floor")
    keys = torch.where(batch >= 0, C.make_keys(batch.clamp(min=0), units),
                       C.sentinel_like(units.to(torch.int64)))
    if n < capacity:
        keys = torch.cat([keys, torch.full((capacity - n,), C.SENTINEL,
                                           dtype=torch.int64,
                                           device=keys.device)])
        feats = torch.cat([feats, feats.new_zeros((capacity - n,
                                                   feats.shape[1]))])
    order = torch.sort(keys, stable=True).indices[:capacity]
    keys, feats = keys[order], feats[order].contiguous()
    if dedup:
        dup = torch.zeros_like(keys, dtype=torch.bool)
        dup[1:] = keys[1:] == keys[:-1]
        keys, feats = _compact(keys, ~dup & C.key_is_valid(keys), feats)
    feats = feats * C.key_is_valid(keys)[:, None].to(feats.dtype)
    return SparseTensor(keys=keys, feats=feats, stride=stride)


def from_points_host(batch, xyz, feats, capacity, stride=1, device="cpu"):
    """Host voxelization (``voxelize_host_np``), then the arrays moved to
    ``device``."""
    keys, f = voxelize_host_np(batch, xyz, feats, capacity, stride)
    return SparseTensor(keys=torch.from_numpy(keys).to(device),
                        feats=torch.from_numpy(f).to(device), stride=stride)


def concat(tensors, capacity):
    """Concatenate sparse tensors (same stride and channels) into one
    sorted tensor, clipped to ``capacity``."""
    keys = torch.cat([t.keys for t in tensors])
    feats = torch.cat([t.feats for t in tensors])
    order = torch.sort(keys, stable=True).indices
    return SparseTensor(keys=keys[order][:capacity],
                        feats=feats[order][:capacity],
                        stride=tensors[0].stride)


def _dedup_sorted(cand, capacity, total=False):
    """Sorted, duplicate-free, SENTINEL-padded keys of ``cand``, clipped to
    ``capacity``: sort, mark repeats SENTINEL, sort again (torch.sort is
    the plain implementation here; these run only in region mode).  With
    ``total``, also the count of distinct valid keys before the clip (a
    0-d device tensor)."""
    cand = torch.sort(cand).values
    dup = torch.zeros_like(cand, dtype=torch.bool)
    dup[1:] = cand[1:] == cand[:-1]
    cand = torch.where(dup & C.key_is_valid(cand), C.sentinel_like(cand),
                       cand)
    out = torch.sort(cand).values[:capacity]
    if total:
        return out, C.key_is_valid(cand).sum()
    return out


def expand_region_keys(keys, region_offsets, capacity):
    """Generative expansion: candidates = {2u + d : d in region}, dedup'd.
    ``region_offsets`` is a static numpy [K, 3] array (e.g.
    ``coords.kernel_offsets(5)``).  Sorted, clipped to ``capacity``."""
    cand = torch.stack([C.shift_units(keys, tuple(int(v) for v in d),
                                      scale=2)[0]
                        for d in region_offsets], dim=1).reshape(-1)
    return _dedup_sorted(cand, capacity)


def dilate_keys(keys, capacity, total=False):
    """27-neighbourhood dilation of a sorted key set, dedup({u + e,
    |e| <= 1}); the candidate parents of region-candidate g_s.  Sorted,
    SENTINEL-padded, clipped to ``capacity``; with ``total`` also the
    number of distinct dilated keys before the clip.  The 27 neighbours
    come from one [P, 27, 3] pass: a shift per neighbour would launch
    some 1,900 int64 kernels a level and bind the decode to the host."""
    from .family import _neighbor_queries  # family imports this module
    return _dedup_sorted(_neighbor_queries(keys)[0].reshape(-1), capacity,
                         total)


_vox_lib = None


def _load_voxelize():
    """The native voxelizer (``coding/csrc/voxelize.cpp``), or False (then
    the numpy path runs)."""
    global _vox_lib
    if _vox_lib is None:
        from ..coding.build import try_native
        src = os.path.join(os.path.dirname(__file__), "..", "coding", "csrc",
                           "voxelize.cpp")
        lib = try_native(src, "voxelize")
        if lib:
            i32p = ctypes.POINTER(ctypes.c_int32)
            i64p = ctypes.POINTER(ctypes.c_int64)
            f32p = ctypes.POINTER(ctypes.c_float)
            lib.voxelize.restype = ctypes.c_int64
            lib.voxelize.argtypes = [i32p, i32p, f32p, ctypes.c_int64,
                                     ctypes.c_int64, ctypes.c_int64,
                                     ctypes.c_int64, i64p, f32p]
        _vox_lib = lib
    return _vox_lib


def voxelize_host_np(batch, xyz, feats, capacity, stride=1, dedup=True):
    """Host voxelization: sorted, sentinel-padded numpy arrays (keys int64
    [capacity], feats f32 [capacity, C]); rows with batch < 0 are padding.
    With ``dedup`` a voxel's first occurrence wins, through the native
    ``voxelize.cpp`` where it builds; the numpy path gives the same arrays
    and is the only path without ``dedup``."""
    lib = _load_voxelize() if dedup else False
    if not lib:
        return _voxelize_np(batch, xyz, feats, capacity, stride, dedup)
    batch = np.ascontiguousarray(batch, np.int32)
    xyz = np.ascontiguousarray(xyz, np.int32)
    feats = np.ascontiguousarray(feats, np.float32)
    n, c = feats.shape
    out_keys = np.empty(capacity, np.int64)
    out_feats = np.empty((capacity, c), np.float32)
    lib.voxelize(
        batch.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        xyz.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        feats.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        n, c, stride, capacity,
        out_keys.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        out_feats.ctypes.data_as(ctypes.POINTER(ctypes.c_float)))
    return out_keys, out_feats


def _voxelize_np(batch, xyz, feats, capacity, stride, dedup):
    batch = np.asarray(batch)
    feats = np.asarray(feats, np.float32)
    units = np.asarray(xyz).astype(np.int64) // stride
    keys = np.where(batch >= 0, C.morton_encode_np(units)
                    | (batch.astype(np.int64) << C.BATCH_SHIFT), C.SENTINEL)
    order = np.argsort(keys, kind="stable")
    keys, feats = keys[order], feats[order]
    if dedup:
        keep = np.ones(len(keys), bool)
        keep[1:] = keys[1:] != keys[:-1]
        keep &= keys != C.SENTINEL
        keys, feats = keys[keep], feats[keep]
    n = min(len(keys), capacity)
    out_keys = np.full(capacity, C.SENTINEL, np.int64)
    out_feats = np.zeros((capacity, feats.shape[1]), np.float32)
    out_keys[:n] = keys[:n]
    out_feats[:n] = feats[:n]
    return out_keys, out_feats
