"""ctypes binding for the native context-adaptive occupancy bit coder
(``csrc/occ.cpp``, a byte-identical copy of the JAX package's coder).

One-pass adaptive KT coding of a candidate's occupancy bit under a context
of (logit bin x number of occupied siblings so far), seeded from the
bin-center sigmoid prior: no table side information.  A failed build
raises; the pure-Python twin of the JAX package is not ported.
"""

import ctypes
import os

import numpy as np

from .build import load_native

_src = os.path.join(os.path.dirname(__file__), "csrc", "occ.cpp")
_lib = None


def _load():
    global _lib
    if _lib is None:
        lib = load_native(_src, "occ")
        u8p = ctypes.POINTER(ctypes.c_uint8)
        lib.occ_encode.restype = ctypes.c_int64
        lib.occ_encode.argtypes = [u8p, u8p, ctypes.c_int64, u8p,
                                   ctypes.c_int64]
        lib.occ_decode.restype = ctypes.c_int64
        lib.occ_decode.argtypes = [u8p, ctypes.c_int64, u8p,
                                   ctypes.c_int64, u8p]
        _lib = lib
    return _lib


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
    cap = bits.size + (1 << 12)
    out = np.empty(cap, np.uint8)
    u8 = ctypes.POINTER(ctypes.c_uint8)
    n = lib.occ_encode(bits.ctypes.data_as(u8), bins.ctypes.data_as(u8),
                       bits.size, out.ctypes.data_as(u8), cap)
    if n < 0:
        raise RuntimeError(f"occ encode failed: {n}")
    return out[:n].tobytes()


def decode(data, bins):
    """bytes + the same context bins -> uint8 bits [N]."""
    bins = np.ascontiguousarray(np.asarray(bins, np.uint8))
    if bins.size % 8:
        raise ValueError("occ decode: 8 candidates per parent")
    if bins.size == 0:
        return np.zeros(0, np.uint8)
    lib = _load()
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
