"""rANS entropy coder: ctypes binding to the native C++ coder (``csrc/rans.cpp``,
a byte-identical copy of the JAX package's coder, so both packages write
the same bytes for the same symbols), with a pure-Python twin of the same
algorithm that writes the same bytes where the library cannot be built.

Streams are decoded by ``csrc/rans_lut.cpp``: the same arithmetic, with
each symbol found through a small per-row bucket table in place of
``rans.cpp``'s binary search over the CDF row.  ``rans.cpp``'s decoder
stays as the yardstick (``search_decode``) that the table decoder is
held against; where either library cannot be built, its twin runs."""

import ctypes
import os

import numpy as np

from ..utils import profiling
from .build import try_native

_PROB_BITS = 16
_RANS_L = 1 << 23
_src = os.path.join(os.path.dirname(__file__), "csrc", "rans.cpp")
_lut_src = os.path.join(os.path.dirname(__file__), "csrc", "rans_lut.cpp")
_lib = None
_lut_lib = None
_i32p = ctypes.POINTER(ctypes.c_int32)
_u8p = ctypes.POINTER(ctypes.c_uint8)
# upcc_rans_decode's arguments: bytes, their count, indexes, n, cdfs, rows,
# row stride, row lengths, offsets, values out
_DECODE_ARGS = [_u8p, ctypes.c_int64, _i32p, ctypes.c_int64, _i32p,
                ctypes.c_int64, ctypes.c_int64, _i32p, _i32p, _i32p]


def _load():
    """The native library, or False (then the twin runs)."""
    global _lib
    if _lib is None:
        lib = try_native(_src, "rans")
        if lib:
            lib.upcc_rans_encode.restype = ctypes.c_int64
            lib.upcc_rans_encode.argtypes = [
                _i32p, _i32p, ctypes.c_int64, _i32p, ctypes.c_int64,
                ctypes.c_int64, _i32p, _i32p, _u8p, ctypes.c_int64]
            lib.upcc_rans_decode.restype = ctypes.c_int64
            lib.upcc_rans_decode.argtypes = _DECODE_ARGS
        _lib = lib
    return _lib


def _load_lut():
    """The table decoder's native library, or False (then the twin runs)."""
    global _lut_lib
    if _lut_lib is None:
        lib = try_native(_lut_src, "rans_lut")
        if lib:
            lib.upcc_rans_lut_decode.restype = ctypes.c_int64
            lib.upcc_rans_lut_decode.argtypes = [
                *_DECODE_ARGS, ctypes.POINTER(ctypes.c_int64)]
        _lut_lib = lib
    return _lut_lib


def _asi32(a):
    return np.ascontiguousarray(a, dtype=np.int32)


@profiling.coder("rans.enc")
def encode_with_indexes(values, indexes, cdfs, cdf_lengths, offsets):
    """values/indexes: int arrays [N]; cdfs: int32 [ncdf, L]. -> bytes."""
    values, indexes = _asi32(values), _asi32(indexes)
    cdfs, cdf_lengths, offsets = _asi32(cdfs), _asi32(cdf_lengths), _asi32(offsets)
    lib = _load()
    if not lib:
        return _py_encode(values, indexes, cdfs, cdf_lengths, offsets)
    cap = max(values.size * 8 + 1024, 1 << 16)
    out = np.empty(cap, np.uint8)
    n = lib.upcc_rans_encode(
        values.ctypes.data_as(_i32p), indexes.ctypes.data_as(_i32p),
        values.size, cdfs.ctypes.data_as(_i32p), cdfs.shape[0],
        cdfs.shape[1], cdf_lengths.ctypes.data_as(_i32p),
        offsets.ctypes.data_as(_i32p), out.ctypes.data_as(_u8p), cap)
    if n < 0:
        raise RuntimeError("rANS encode buffer overflow")
    return out[:n].tobytes()


@profiling.coder("rans.dec")
def decode_with_indexes(data, indexes, cdfs, cdf_lengths, offsets):
    """Inverse of encode_with_indexes. -> int32 values [N].  Counts
    ``coder.rans.dec.direct``, the symbols one table entry resolved."""
    lib = _load_lut()
    if not lib:
        return _py_decode(*_decode_inputs(data, indexes, cdfs, cdf_lengths,
                                          offsets))
    direct = ctypes.c_int64(0)
    rc, out = _native_decode(lib.upcc_rans_lut_decode, np.empty, data,
                             indexes, cdfs, cdf_lengths, offsets,
                             ctypes.byref(direct))
    if rc != 0:
        raise RuntimeError(f"rANS decode failed: {rc}")
    profiling.count("coder.rans.dec.direct", direct.value)
    return out


def table_decode(data, indexes, cdfs, cdf_lengths, offsets):
    """``rans_lut.cpp``'s decoder, as ``decode_with_indexes`` runs it. ->
    (its return code, the values [N], the symbols one table entry
    resolved); on a nonzero code the values from the failing symbol on
    are 0."""
    direct = ctypes.c_int64(0)
    rc, out = _native_decode(_load_lut().upcc_rans_lut_decode, np.zeros,
                             data, indexes, cdfs, cdf_lengths, offsets,
                             ctypes.byref(direct))
    return rc, out, direct.value


def search_decode(data, indexes, cdfs, cdf_lengths, offsets):
    """``rans.cpp``'s decoder (a binary search over the CDF row a symbol),
    the yardstick of ``table_decode``. -> (its return code, the values),
    as ``table_decode``'s."""
    return _native_decode(_load().upcc_rans_decode, np.zeros, data, indexes,
                          cdfs, cdf_lengths, offsets)


def _decode_inputs(data, indexes, cdfs, cdf_lengths, offsets):
    return (np.ascontiguousarray(np.frombuffer(data, np.uint8)),
            _asi32(indexes), _asi32(cdfs), _asi32(cdf_lengths),
            _asi32(offsets))


def _native_decode(fn, alloc, data, indexes, cdfs, cdf_lengths, offsets,
                   *extra):
    """``fn`` on the arrays, its values in ``alloc(n, np.int32)``: the
    decode path takes ``np.empty``, which leaves a frame's 16 MB of values
    untouched until the decoder writes them once."""
    buf, indexes, cdfs, cdf_lengths, offsets = _decode_inputs(
        data, indexes, cdfs, cdf_lengths, offsets)
    out = alloc(indexes.size, np.int32)
    rc = fn(buf.ctypes.data_as(_u8p), buf.size,
            indexes.ctypes.data_as(_i32p), indexes.size,
            cdfs.ctypes.data_as(_i32p), cdfs.shape[0], cdfs.shape[1],
            cdf_lengths.ctypes.data_as(_i32p), offsets.ctypes.data_as(_i32p),
            out.ctypes.data_as(_i32p), *extra)
    return rc, out


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


# -- the pure-Python twin ----------------------------------------------------

def _py_encode(values, indexes, cdfs, cdf_lengths, offsets):
    out = bytearray()
    x = _RANS_L

    def put(start, freq):
        nonlocal x
        x_max = ((_RANS_L >> _PROB_BITS) << 8) * freq
        while x >= x_max:
            out.append(x & 0xFF)
            x >>= 8
        x = ((x // freq) << _PROB_BITS) + (x % freq) + start

    for i in range(len(values) - 1, -1, -1):
        idx = int(indexes[i])
        cdf = cdfs[idx]
        max_sym = int(cdf_lengths[idx]) - 2
        s = int(values[i]) - int(offsets[idx])
        if s < 0 or s >= max_sym:
            # escape: the overflow magnitude in 3-bit chunks (bit 3 marks
            # a chunk that is followed by another), each at 1/16
            ov = -2 * s - 1 if s < 0 else 2 * (s - max_sym)
            chunks = []
            u = ov
            while True:
                c = u & 0x7
                u >>= 3
                if u:
                    c |= 0x8
                chunks.append(c)
                if not u:
                    break
            for c in reversed(chunks):
                put(c << 12, 1 << 12)
            s = max_sym
        put(int(cdf[s]), int(cdf[s + 1] - cdf[s]))
    for i in range(3, -1, -1):
        out.append((x >> (8 * i)) & 0xFF)
    return bytes(reversed(out))


def _py_decode(buf, indexes, cdfs, cdf_lengths, offsets):
    pos = 0
    x = 0
    for i in range(4):
        if pos < len(buf):
            x |= int(buf[pos]) << (8 * i)
            pos += 1

    def advance(start, freq):
        nonlocal x, pos
        x = freq * (x >> _PROB_BITS) + (x & ((1 << _PROB_BITS) - 1)) - start
        while x < _RANS_L and pos < len(buf):
            x = (x << 8) | int(buf[pos])
            pos += 1

    out = np.empty(len(indexes), np.int32)
    for i in range(len(indexes)):
        idx = int(indexes[i])
        cdf = cdfs[idx]
        ln = int(cdf_lengths[idx])
        max_sym = ln - 2
        cum = x & ((1 << _PROB_BITS) - 1)
        s = int(np.searchsorted(cdf[:ln], cum, side="right")) - 1
        advance(int(cdf[s]), int(cdf[s + 1] - cdf[s]))
        if s == max_sym:
            u, shift = 0, 0
            while True:
                cum = x & ((1 << _PROB_BITS) - 1)
                c = cum >> 12
                advance(c << 12, 1 << 12)
                u |= (c & 0x7) << shift
                shift += 3
                if not (c & 0x8):
                    break
            s = -((u + 1) // 2) if (u & 1) else max_sym + u // 2
        out[i] = s + int(offsets[idx])
    return out
