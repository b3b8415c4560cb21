"""ctypes binding for the native octree coordinate codec (``csrc/octree.cpp``,
a byte-identical copy of the JAX package's coder)."""

import ctypes
import os

import numpy as np

from .build import load_native

_src = os.path.join(os.path.dirname(__file__), "csrc", "octree.cpp")
_lib = None


def _load():
    global _lib
    if _lib is None:
        lib = load_native(_src, "octree")
        i64p = ctypes.POINTER(ctypes.c_int64)
        u8p = ctypes.POINTER(ctypes.c_uint8)
        lib.octree_encode.restype = ctypes.c_int64
        lib.octree_encode.argtypes = [i64p, ctypes.c_int64, ctypes.c_int,
                                      u8p, ctypes.c_int64]
        lib.octree_decode.restype = ctypes.c_int64
        lib.octree_decode.argtypes = [u8p, ctypes.c_int64, ctypes.c_int,
                                      i64p, ctypes.c_int64]
        _lib = lib
    return _lib


def encode(morton_codes, levels):
    """morton_codes: sorted unique int64 [N] (< 8**levels) -> bytes."""
    codes = np.ascontiguousarray(morton_codes, np.int64)
    if codes.size == 0:
        return b""
    lib = _load()
    cap = codes.size * 8 + (1 << 12)
    out = np.empty(cap, np.uint8)
    n = lib.octree_encode(
        codes.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)), codes.size,
        levels, out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)), cap)
    if n < 0:
        raise RuntimeError(f"octree encode failed: {n}")
    return out[:n].tobytes()


def decode(data, levels, max_points):
    """bytes -> sorted int64 morton codes [N]."""
    if len(data) == 0:
        return np.zeros(0, np.int64)
    buf = np.ascontiguousarray(np.frombuffer(data, np.uint8))
    lib = _load()
    out = np.empty(max_points, np.int64)
    n = lib.octree_decode(
        buf.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)), buf.size, levels,
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)), max_points)
    if n < 0:
        raise RuntimeError(f"octree decode failed: {n}")
    return out[:n].copy()
