"""Sorted sparse voxel tensor and the set operations on the codec's path.

``SparseTensor`` is a fixed-capacity, sorted, sentinel-padded array of
Morton keys plus a feature matrix.  ``compact`` is kernel K3 on the card
(``csrc/compact.cu``) and its plain PyTorch version on the CPU.
"""

import ctypes
import dataclasses
import os

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
    def valid(self):
        return C.key_is_valid(self.keys)

    @property
    def batch(self):
        return C.key_batch(self.keys)

    def counts_per_batch(self, max_batch):
        """int32[max_batch] valid point count per batch index."""
        b = torch.where(self.valid, self.batch.to(torch.int64), max_batch)
        b = b.clamp(0, max_batch)  # batches >= max_batch go to the dump bin
        counts = torch.zeros(max_batch + 1, dtype=torch.int32,
                             device=self.keys.device)
        counts.index_add_(0, b, torch.ones_like(b, dtype=torch.int32))
        return counts[:max_batch]

    def replace(self, **kw):
        return dataclasses.replace(self, **kw)


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


def compact(keys, keep, *arrays, out_capacity=None):
    """Stable compaction: move kept rows to the front, sentinel/zero the tail.

    keys: sorted int64 [n]; keep: bool [n]; arrays: payloads with n rows.
    Output rows are truncated at ``out_capacity`` (default n).  Because the
    input keys are sorted and the compaction is stable, the output stays
    sorted.  On a CUDA tensor this launches kernel K3; on a CPU tensor it
    runs ``compact_plain``."""
    if not keys.is_cuda:
        return compact_plain(keys, keep, *arrays, out_capacity=out_capacity)
    n = keys.shape[0]
    m = out_capacity if out_capacity is not None else n
    kernels.require_cuda(keys, torch.int64, 1, "compact keys")
    kernels.require_cuda(keep, torch.bool, 1, "compact keep")
    if keep.shape[0] != n or n >= 2 ** 31 or m >= 2 ** 31:
        raise ValueError("compact: keep must match keys; n, m < 2^31")
    for a in arrays:
        if not a.is_cuda or not a.is_contiguous() or a.shape[0] != n:
            raise ValueError("compact: payloads must be contiguous CUDA "
                             "tensors with one row per key")
    lib = kernels.lib("compact")
    stream = kernels.stream_ptr(keys)
    nblk = max(1, -(-n // 4096))  # one count per 4096-row tile (compact.cu)
    src = torch.empty(max(m, 1), dtype=torch.int32, device=keys.device)
    blk = torch.empty(nblk, dtype=torch.int32, device=keys.device)
    kernels.count_launch("compact", keys, keep, arrays, m)
    kernels.check(lib.upcc_compact_index(keep.data_ptr(), n, m,
                                         src.data_ptr(), blk.data_ptr(),
                                         stream), "compact index")
    out_keys = torch.empty(m, dtype=torch.int64, device=keys.device)
    kernels.check(lib.upcc_compact_keys(keys.data_ptr(), src.data_ptr(), n,
                                        m, out_keys.data_ptr(), stream),
                  "compact keys")
    outs = []
    for a in arrays:
        out = torch.empty((m,) + a.shape[1:], dtype=a.dtype, device=a.device)
        row_bytes = a[0].numel() * a.element_size() if n else 0
        kernels.check(lib.upcc_compact_rows(a.data_ptr(), src.data_ptr(), n,
                                            m, row_bytes, out.data_ptr(),
                                            stream), "compact rows")
        outs.append(out)
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


_vox_lib = None


def voxelize_host_np(batch, xyz, feats, capacity, stride=1):
    """Host voxelization through the native ``voxelize.cpp``: sorted,
    dedup'd (first occurrence wins), sentinel-padded numpy arrays
    (keys int64 [capacity], feats f32 [capacity, C])."""
    global _vox_lib
    if _vox_lib is None:
        from ..coding.build import load_native
        src = os.path.join(os.path.dirname(__file__), "..", "coding", "csrc",
                           "voxelize.cpp")
        lib = load_native(src, "voxelize")
        i32p = ctypes.POINTER(ctypes.c_int32)
        i64p = ctypes.POINTER(ctypes.c_int64)
        f32p = ctypes.POINTER(ctypes.c_float)
        lib.voxelize.restype = ctypes.c_int64
        lib.voxelize.argtypes = [i32p, i32p, f32p, ctypes.c_int64,
                                 ctypes.c_int64, ctypes.c_int64,
                                 ctypes.c_int64, i64p, f32p]
        _vox_lib = lib
    batch = np.ascontiguousarray(batch, np.int32)
    xyz = np.ascontiguousarray(xyz, np.int32)
    feats = np.ascontiguousarray(feats, np.float32)
    n, c = feats.shape
    out_keys = np.empty(capacity, np.int64)
    out_feats = np.empty((capacity, c), np.float32)
    _vox_lib.voxelize(
        batch.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        xyz.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        feats.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        n, c, stride, capacity,
        out_keys.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        out_feats.ctypes.data_as(ctypes.POINTER(ctypes.c_float)))
    return out_keys, out_feats
