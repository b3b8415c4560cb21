"""ctypes binding for the native octree coordinate codec (``csrc/octree.cpp``,
a byte-identical copy of the JAX package's coder), with a pure-Python twin
that writes and reads the same stream where the library cannot be built.

The twin is the v3 coder of ``octree.cpp``: causal neighbour-child
contexts, KT counting probabilities and a 32-bit carry-propagating binary
range coder (``_Ctx``, ``_Encoder``, ``_Decoder``, which ``occ.py``
reuses)."""

import bisect
import ctypes
import os

import numpy as np

from ..utils import profiling
from .build import try_native

_src = os.path.join(os.path.dirname(__file__), "csrc", "octree.cpp")
_lib = None

_MAX_LEVELS = 21
_MASK32 = 0xFFFFFFFF
_TOP = 1 << 24
_PROB_BITS = 16


def _load():
    """The native library, or False (then the twin runs)."""
    global _lib
    if _lib is None:
        lib = try_native(_src, "octree")
        if lib:
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


@profiling.coder("octree.enc")
def encode(morton_codes, levels):
    """morton_codes: sorted unique int64 [N] (< 8**levels) -> bytes."""
    codes = np.ascontiguousarray(morton_codes, np.int64)
    if codes.size == 0:
        return b""
    lib = _load()
    if not lib:
        return _py_encode(codes, levels)
    cap = codes.size * 8 + (1 << 12)
    out = np.empty(cap, np.uint8)
    n = lib.octree_encode(
        codes.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)), codes.size,
        levels, out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)), cap)
    if n < 0:
        raise RuntimeError(f"octree encode failed: {n}")
    return out[:n].tobytes()


@profiling.coder("octree.dec")
def decode(data, levels, max_points):
    """bytes -> sorted int64 morton codes [N]."""
    if len(data) == 0:
        return np.zeros(0, np.int64)
    lib = _load()
    if not lib:
        return _py_decode(bytes(data), levels, max_points)
    buf = np.ascontiguousarray(np.frombuffer(data, np.uint8))
    out = np.empty(max_points, np.int64)
    n = lib.octree_decode(
        buf.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)), buf.size, levels,
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)), max_points)
    if n < 0:
        raise RuntimeError(f"octree decode failed: {n}")
    return out[:n].copy()


# -- the pure-Python twin ----------------------------------------------------

_HALVE_AT = 128
_PMIN, _PMAX = 64, (1 << _PROB_BITS) - 64


class _Ctx:
    """Adaptive binary context: KT counts in half-units, halved at 128."""

    __slots__ = ("c0", "c1")

    def __init__(self):
        self.c0 = 1
        self.c1 = 1

    def p0(self):
        p = (self.c0 << _PROB_BITS) // (self.c0 + self.c1)
        return _PMIN if p < _PMIN else (_PMAX if p > _PMAX else p)

    def update(self, bit):
        if bit:
            self.c1 += 2
        else:
            self.c0 += 2
        if self.c0 + self.c1 >= _HALVE_AT:
            self.c0 = (self.c0 + 1) >> 1
            self.c1 = (self.c1 + 1) >> 1


class _Encoder:
    """32-bit binary range coder; a carry out of ``low`` propagates into
    the bytes already written."""

    def __init__(self):
        self.out = bytearray()
        self.low = 0
        self.range = _MASK32

    def encode(self, bit, ctx):
        split = (self.range * ctx.p0()) >> _PROB_BITS
        if bit == 0:
            self.range = split
        else:
            nlow = (self.low + split) & _MASK32
            if nlow < self.low:
                self._carry()
            self.low = nlow
            self.range -= split
        ctx.update(bit)
        while self.range < _TOP:
            self.out.append((self.low >> 24) & 0xFF)
            self.low = (self.low << 8) & _MASK32
            self.range = (self.range << 8) & _MASK32

    def _carry(self):
        # a carry through an all-0xFF prefix is lost, as in the C++ coder
        out = self.out
        for i in range(len(out) - 1, -1, -1):
            if out[i] != 0xFF:
                out[i] += 1
                return
            out[i] = 0

    def flush(self):
        for _ in range(4):
            self.out.append((self.low >> 24) & 0xFF)
            self.low = (self.low << 8) & _MASK32


class _Decoder:
    """The decoder of ``_Encoder``'s stream; reads zeros past its end."""

    def __init__(self, data):
        self.data = data
        self.pos = 0
        self.code = 0
        self.range = _MASK32
        for _ in range(4):
            self.code = ((self.code << 8) | self._next()) & _MASK32

    def _next(self):
        if self.pos < len(self.data):
            b = self.data[self.pos]
            self.pos += 1
            return b
        return 0

    def decode(self, ctx):
        split = (self.range * ctx.p0()) >> _PROB_BITS
        if self.code < split:
            bit = 0
            self.range = split
        else:
            bit = 1
            self.code -= split
            self.range -= split
        ctx.update(bit)
        while self.range < _TOP:
            self.code = ((self.code << 8) | self._next()) & _MASK32
            self.range = (self.range << 8) & _MASK32
        return bit


def _level_bucket(level, levels):
    from_leaf = levels - level
    if from_leaf <= 1:
        return 0
    if from_leaf == 2:
        return 1
    if from_leaf == 3:
        return 2
    return 3


def _ctx_index(lb, ext, sib, slot):
    return (((lb * 64) + ext) * 27 + sib) * 8 + slot


def _morton_to_xyz(m):
    x = [0, 0, 0]
    for a in range(3):
        v = 0
        for b in range(21):
            v |= ((m >> (3 * b + 2 - a)) & 1) << b
        x[a] = v
    return x


def _xyz_to_morton(x):
    m = 0
    for a in range(3):
        for b in range(21):
            m |= ((x[a] >> b) & 1) << (3 * b + 2 - a)
    return m


def _find_nbrs(nodes, code, level_bits):
    """[axis][dir] index of the face-neighbour node in ``nodes`` or -1."""
    x = _morton_to_xyz(code)
    lim = 1 << level_bits
    nb = [[-1, -1], [-1, -1], [-1, -1]]
    for a in range(3):
        for d in range(2):
            q = list(x)
            q[a] += 1 if d else -1
            if q[a] < 0 or q[a] >= lim:
                continue
            mc = _xyz_to_morton(q)
            i = bisect.bisect_left(nodes, mc)
            if i < len(nodes) and nodes[i] == mc:
                nb[a][d] = i
    return nb


def _ext_state(nb, occ, k, c):
    """Per axis: no neighbour (0), a neighbour not coded yet (1), or the
    coded neighbour's facing child empty (2) / occupied (3)."""
    ext = 0
    for a in range(3):
        bit_a = (c >> (2 - a)) & 1
        qi = nb[a][bit_a]
        s = 0
        if qi >= 0:
            if qi < k:
                cq = c ^ (1 << (2 - a))
                s = 2 + ((occ[qi] >> cq) & 1)
            else:
                s = 1
        ext = ext * 4 + s
    return ext


def _sib_state(c, occ_so_far):
    """Per axis: the face sibling not coded yet (0), empty (1), occupied
    (2)."""
    sib = 0
    for a in range(3):
        s = c ^ (1 << (2 - a))
        v = 0
        if s < c:
            v = 1 + ((occ_so_far >> s) & 1)
        sib = sib * 3 + v
    return sib


def _py_encode(codes, levels):
    if levels > _MAX_LEVELS:
        raise RuntimeError("octree encode failed: -3")
    codes = [int(v) for v in codes]
    ctxs = {}
    enc = _Encoder()
    starts, ends, nodes = [0], [len(codes)], [0]
    for level in range(levels):
        shift = 3 * (levels - level - 1)
        lb = _level_bucket(level, levels)
        nstarts, nends, nnodes = [], [], []
        occ = [0] * len(nodes)
        for k in range(len(starts)):
            s, e = starts[k], ends[k]
            cs = [0] * 9
            p = s
            for c in range(8):
                cs[c] = p
                while p < e and ((codes[p] >> shift) & 7) == c:
                    p += 1
            cs[8] = e
            nb = _find_nbrs(nodes, nodes[k], level)
            pattern = 0
            for c in range(8):
                bit = 1 if cs[c + 1] > cs[c] else 0
                ci = _ctx_index(lb, _ext_state(nb, occ, k, c),
                                _sib_state(c, pattern), c)
                ctx = ctxs.get(ci)
                if ctx is None:
                    ctx = ctxs[ci] = _Ctx()
                enc.encode(bit, ctx)
                pattern |= bit << c
                if bit and level + 1 < levels:
                    nstarts.append(cs[c])
                    nends.append(cs[c + 1])
                    nnodes.append((nodes[k] << 3) | c)
            occ[k] = pattern
        starts, ends, nodes = nstarts, nends, nnodes
    enc.flush()
    return bytes(enc.out)


def _py_decode(data, levels, max_points):
    if levels > _MAX_LEVELS:
        raise RuntimeError("octree decode failed: -3")
    ctxs = {}
    dec = _Decoder(data)
    nodes = [0]
    for level in range(levels):
        lb = _level_bucket(level, levels)
        nxt = []
        occ = [0] * len(nodes)
        for k in range(len(nodes)):
            nb = _find_nbrs(nodes, nodes[k], level)
            pattern = 0
            for c in range(8):
                ci = _ctx_index(lb, _ext_state(nb, occ, k, c),
                                _sib_state(c, pattern), c)
                ctx = ctxs.get(ci)
                if ctx is None:
                    ctx = ctxs[ci] = _Ctx()
                bit = dec.decode(ctx)
                pattern |= bit << c
                if bit:
                    nxt.append((nodes[k] << 3) | c)
            occ[k] = pattern
        nodes = nxt
        if len(nodes) > max_points:
            raise RuntimeError("octree decode failed: -1")
    return np.array(nodes, np.int64)
