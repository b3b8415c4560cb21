"""rANS entropy coder: ctypes binding to the native C++ coder (``csrc/rans.cpp``,
a byte-identical copy of the JAX package's coder, so both packages write
the same bytes for the same symbols)."""

import ctypes
import os

import numpy as np

from .build import load_native

_PROB_BITS = 16
_src = os.path.join(os.path.dirname(__file__), "csrc", "rans.cpp")
_lib = None


def _load():
    global _lib
    if _lib is None:
        lib = load_native(_src, "rans")
        i32p = ctypes.POINTER(ctypes.c_int32)
        u8p = ctypes.POINTER(ctypes.c_uint8)
        lib.upcc_rans_encode.restype = ctypes.c_int64
        lib.upcc_rans_encode.argtypes = [i32p, i32p, ctypes.c_int64, i32p,
                                         ctypes.c_int64, ctypes.c_int64, i32p,
                                         i32p, u8p, ctypes.c_int64]
        lib.upcc_rans_decode.restype = ctypes.c_int64
        lib.upcc_rans_decode.argtypes = [u8p, ctypes.c_int64, i32p,
                                         ctypes.c_int64, i32p, ctypes.c_int64,
                                         ctypes.c_int64, i32p, i32p, i32p]
        _lib = lib
    return _lib


def _asi32(a):
    return np.ascontiguousarray(a, dtype=np.int32)


def encode_with_indexes(values, indexes, cdfs, cdf_lengths, offsets):
    """values/indexes: int arrays [N]; cdfs: int32 [ncdf, L]. -> bytes."""
    values, indexes = _asi32(values), _asi32(indexes)
    cdfs, cdf_lengths, offsets = _asi32(cdfs), _asi32(cdf_lengths), _asi32(offsets)
    lib = _load()
    cap = max(values.size * 8 + 1024, 1 << 16)
    out = np.empty(cap, np.uint8)
    i32p = ctypes.POINTER(ctypes.c_int32)
    u8p = ctypes.POINTER(ctypes.c_uint8)
    n = lib.upcc_rans_encode(
        values.ctypes.data_as(i32p), indexes.ctypes.data_as(i32p),
        values.size, cdfs.ctypes.data_as(i32p), cdfs.shape[0],
        cdfs.shape[1], cdf_lengths.ctypes.data_as(i32p),
        offsets.ctypes.data_as(i32p), out.ctypes.data_as(u8p), cap)
    if n < 0:
        raise RuntimeError("rANS encode buffer overflow")
    return out[:n].tobytes()


def decode_with_indexes(data, indexes, cdfs, cdf_lengths, offsets):
    """Inverse of encode_with_indexes. -> int32 values [N]."""
    indexes = _asi32(indexes)
    cdfs, cdf_lengths, offsets = _asi32(cdfs), _asi32(cdf_lengths), _asi32(offsets)
    buf = np.ascontiguousarray(np.frombuffer(data, np.uint8))
    lib = _load()
    out = np.empty(indexes.size, np.int32)
    i32p = ctypes.POINTER(ctypes.c_int32)
    u8p = ctypes.POINTER(ctypes.c_uint8)
    rc = lib.upcc_rans_decode(
        buf.ctypes.data_as(u8p), buf.size,
        indexes.ctypes.data_as(i32p), indexes.size,
        cdfs.ctypes.data_as(i32p), cdfs.shape[0], cdfs.shape[1],
        cdf_lengths.ctypes.data_as(i32p), offsets.ctypes.data_as(i32p),
        out.ctypes.data_as(i32p))
    if rc != 0:
        raise RuntimeError(f"rANS decode failed: {rc}")
    return out


def pmf_to_quantized_cdf(pmf, tail_mass, precision=_PROB_BITS):
    """Quantize a pmf (+ tail bin) into an integer CDF summing to 2^precision.

    Every bin gets frequency >= 1; the excess/deficit is balanced against
    the largest bins so the coder never sees a zero-probability symbol."""
    pmf = np.asarray(pmf, np.float64)
    p = np.concatenate([pmf, [max(float(tail_mass), 1e-12)]])
    p = np.maximum(p, 1e-12)
    total = 1 << precision
    freq = np.maximum(np.round(p / p.sum() * total).astype(np.int64), 1)
    diff = total - freq.sum()
    while diff != 0:
        if diff > 0:
            i = int(np.argmax(p / freq))
            add = min(diff, max(1, abs(diff)))
            freq[i] += add
            diff -= add
        else:
            order = np.argsort(-(freq.astype(np.float64)))
            for i in order:
                take = min(freq[i] - 1, -diff)
                freq[i] -= take
                diff += take
                if diff == 0:
                    break
            else:
                raise ValueError("cannot normalize pmf")
    cdf = np.zeros(len(freq) + 1, np.int32)
    cdf[1:] = np.cumsum(freq)
    assert cdf[-1] == total
    return cdf
