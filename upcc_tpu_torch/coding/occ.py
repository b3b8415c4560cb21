"""ctypes binding for the native context-adaptive occupancy bit coder
(``csrc/occ.cpp``, a byte-identical copy of the JAX package's coder), with
a pure-Python twin that writes and reads the same stream where the library
cannot be built.

One-pass adaptive KT coding of a candidate's occupancy bit under a context
of (logit bin x number of occupied siblings so far), seeded from the
bin-center sigmoid prior: no table side information.  The twin runs the
octree coder's binary range coder (``octree._Encoder``/``_Decoder``), so
it keeps ``occ.cpp``'s stream format exactly, including the carry that is
lost through an all-0xFF prefix.
"""

import ctypes
import math
import os

import numpy as np

from ..utils import profiling
from .build import try_native
from .octree import _Ctx, _Decoder, _Encoder

_src = os.path.join(os.path.dirname(__file__), "csrc", "occ.cpp")
_lib = None

N_BINS = 32          # codec/refine.py N_BINS
_PREFIX_STATES = 5   # 0..3 occupied siblings so far, 4 = 4+
_LOGIT_LO, _LOGIT_HI = -8.0, 8.0
_SEED_TOTAL = 16     # prior strength in the coder's half-units


def _load():
    """The native library, or False (then the twin runs)."""
    global _lib
    if _lib is None:
        lib = try_native(_src, "occ")
        if lib:
            u8p = ctypes.POINTER(ctypes.c_uint8)
            lib.occ_encode.restype = ctypes.c_int64
            lib.occ_encode.argtypes = [u8p, u8p, ctypes.c_int64, u8p,
                                       ctypes.c_int64]
            lib.occ_decode.restype = ctypes.c_int64
            lib.occ_decode.argtypes = [u8p, ctypes.c_int64, u8p,
                                       ctypes.c_int64, u8p]
        _lib = lib
    return _lib


@profiling.coder("occ.enc")
def encode(bits, bins):
    """bits: bool/uint8 [N]; bins: uint8 [N] logit context bins; N % 8 == 0,
    parent-major candidate order.  Returns bytes."""
    bits = np.ascontiguousarray(np.asarray(bits).astype(np.uint8))
    bins = np.ascontiguousarray(np.asarray(bins, np.uint8))
    if bits.shape != bins.shape or bits.size % 8:
        raise ValueError("occ encode: bits and bins must match, 8 per parent")
    if bits.size == 0:
        return b""
    lib = _load()
    if not lib:
        return _py_encode(bits, bins)
    cap = bits.size + (1 << 12)
    out = np.empty(cap, np.uint8)
    u8 = ctypes.POINTER(ctypes.c_uint8)
    n = lib.occ_encode(bits.ctypes.data_as(u8), bins.ctypes.data_as(u8),
                       bits.size, out.ctypes.data_as(u8), cap)
    if n < 0:
        raise RuntimeError(f"occ encode failed: {n}")
    return out[:n].tobytes()


@profiling.coder("occ.dec")
def decode(data, bins):
    """bytes + the same context bins -> uint8 bits [N]."""
    bins = np.ascontiguousarray(np.asarray(bins, np.uint8))
    if bins.size % 8:
        raise ValueError("occ decode: 8 candidates per parent")
    if bins.size == 0:
        return np.zeros(0, np.uint8)
    lib = _load()
    if not lib:
        return _py_decode(bytes(data), bins)
    buf = np.ascontiguousarray(np.frombuffer(bytes(data), np.uint8))
    out = np.empty(bins.size, np.uint8)
    u8 = ctypes.POINTER(ctypes.c_uint8)
    n = lib.occ_decode(
        buf.ctypes.data_as(u8) if buf.size else
        ctypes.cast(ctypes.c_void_p(), u8),
        buf.size, bins.ctypes.data_as(u8), bins.size,
        out.ctypes.data_as(u8))
    if n < 0:
        raise RuntimeError(f"occ decode failed: {n}")
    return out


# -- the pure-Python twin ----------------------------------------------------

def _seeded_ctxs():
    ctxs = []
    w = (_LOGIT_HI - _LOGIT_LO) / N_BINS
    for b in range(N_BINS):
        center = _LOGIT_LO + (b + 0.5) * w
        p = 1.0 / (1.0 + math.exp(-center))
        c1 = int(p * _SEED_TOTAL + 0.5)
        c1 = min(max(c1, 1), _SEED_TOTAL - 1)
        for _s in range(_PREFIX_STATES):
            c = _Ctx()
            c.c1 = c1
            c.c0 = _SEED_TOTAL - c1
            ctxs.append(c)
    return ctxs


def _ctx_index(b, prefix):
    return b * _PREFIX_STATES + (4 if prefix > 4 else prefix)


def _py_encode(bits, bins):
    ctxs = _seeded_ctxs()
    enc = _Encoder()
    prefix = 0
    for i in range(bits.size):
        if (i & 7) == 0:
            prefix = 0
        bit = int(bits[i] != 0)
        b = int(bins[i])
        enc.encode(bit, ctxs[_ctx_index(min(b, N_BINS - 1), prefix)])
        prefix += bit
    enc.flush()
    return bytes(enc.out)


def _py_decode(data, bins):
    ctxs = _seeded_ctxs()
    dec = _Decoder(data)
    out = np.empty(bins.size, np.uint8)
    prefix = 0
    for i in range(bins.size):
        if (i & 7) == 0:
            prefix = 0
        b = int(bins[i])
        bit = dec.decode(ctxs[_ctx_index(min(b, N_BINS - 1), prefix)])
        out[i] = bit
        prefix += bit
    return out
