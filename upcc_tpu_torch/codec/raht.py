"""Native G-PCC-class anchor codec: octree geometry + RAHT attributes.

The construction of MPEG's G-PCC test model (tmc3: octree geometry + RAHT
attribute coding), implemented natively so anchor RD curves run without
that binary.  Numpy only; the same arithmetic as the JAX package's module
of this name, so payloads are byte-identical.  The residual color layer
(codec/color_resid.py) uses its transform and stream coders.

  * geometry: positions scaled by ``q_g`` (tmc3's
    positionQuantizationScale), voxelized with attribute averaging over
    merged duplicates, occupancy coded by the native adaptive-context
    octree coder (coding/csrc/octree.cpp);
  * attributes: BT.709 YUV, Region-Adaptive Hierarchical Transform
    (de Queiroz & Chou, 2016 — the weighted Haar butterfly over the octree,
    one bit-merge per step, 3 steps per level), uniform quantization with
    step 2^((qp-4)/6), and rANS with per-channel Laplace-fit CDFs (scale
    parameters are transmitted; out-of-range symbols ride the coder's
    escape/bypass path);
  * the decoder replays the transform structure from the decoded geometry,
    so no side information beyond the two Laplace scales per channel class
    is needed.

This is an honest reimplementation of the anchor's construction, not the
tmc3 bitstream; results are labeled ``gpcc_native`` everywhere.
"""

import struct

import numpy as np

from ..coding import octree, rans
from ..ops.coords import morton_decode_np, morton_encode_np

_MAGIC = b"UPR1"
_TAIL = 1e-9


def _yuv_from_rgb01(rgb01):
    """BT.709 full-range YUV in [0,255] floats (same matrix as
    eval/metrics.rgb_to_yuv_bt709)."""
    rgb = np.clip(np.asarray(rgb01, np.float64), 0.0, 1.0) * 255.0
    y = 0.2126 * rgb[:, 0] + 0.7152 * rgb[:, 1] + 0.0722 * rgb[:, 2]
    u = -0.1146 * rgb[:, 0] - 0.3854 * rgb[:, 1] + 0.5 * rgb[:, 2] + 128.0
    v = 0.5 * rgb[:, 0] - 0.4542 * rgb[:, 1] - 0.0458 * rgb[:, 2] + 128.0
    return np.stack([y, u, v], 1)


def _rgb01_from_yuv(yuv):
    y = yuv[:, 0]
    u = yuv[:, 1] - 128.0
    v = yuv[:, 2] - 128.0
    r = y + 1.5748 * v
    b = y + 1.8556 * u
    g = (y - 0.2126 * r - 0.0722 * b) / 0.7152
    return np.clip(np.stack([r, g, b], 1) / 255.0, 0.0, 1.0)


def _raht_structure(keys, depth):
    """Replay the RAHT merge structure for a sorted unique morton key set.

    Returns a list of (pair_start_positions, keep_mask, w1, w2) per step —
    identical on encoder and decoder because it depends only on geometry."""
    steps = []
    w = np.ones(len(keys), np.float64)
    for _ in range(3 * depth):
        parent = keys >> 1
        same = np.nonzero(parent[1:] == parent[:-1])[0]
        keep = np.ones(len(keys), bool)
        keep[same + 1] = False
        w1, w2 = w[same].copy(), w[same + 1].copy()
        steps.append((same, keep, w1, w2))
        w[same] += w2
        keys, w = parent[keep], w[keep]
        if len(keys) == 1 and np.all(keys == 0):
            break
    return steps


def raht_forward(keys, attrs, depth):
    """-> (dc [R, C] roots in final order, acs: list of [M_i, C])."""
    vals = np.asarray(attrs, np.float64).copy()
    acs = []
    for same, keep, w1, w2 in _raht_structure(keys, depth):
        s = np.sqrt(w1 + w2)
        a = (np.sqrt(w1) / s)[:, None]
        b = (np.sqrt(w2) / s)[:, None]
        v1, v2 = vals[same], vals[same + 1]
        acs.append(-b * v1 + a * v2)
        vals[same] = a * v1 + b * v2
        vals = vals[keep]
        keys = (keys >> 1)[keep]
    return vals, acs


def raht_inverse(keys, depth, dc, acs):
    """Inverse transform given decoded geometry + coefficient stacks."""
    steps = _raht_structure(keys, depth)
    vals = np.asarray(dc, np.float64).copy()
    for (same, keep, w1, w2), ac in zip(reversed(steps), reversed(acs)):
        s = np.sqrt(w1 + w2)
        a = (np.sqrt(w1) / s)[:, None]
        b = (np.sqrt(w2) / s)[:, None]
        out = np.empty((len(keep), vals.shape[1]), np.float64)
        out[keep] = vals
        dcv = out[same]
        out[same] = a * dcv - b * ac
        out[same + 1] = b * dcv + a * ac
        vals = out
    return vals


def _laplace_cdf(b, max_abs):
    """Quantized CDF for a zero-mean Laplace over [-max_abs, max_abs]."""
    k = np.arange(-max_abs, max_abs + 1, dtype=np.float64)
    pmf = np.exp(-np.abs(k) / max(float(b), 1e-3))
    pmf /= pmf.sum()
    return rans.pmf_to_quantized_cdf(pmf, _TAIL)


def _code_streams(streams):
    """streams: list of (values int32 [N], b float, max_abs int).  One rANS
    pass with one CDF per stream; returns bytes."""
    cdfs, lengths, offsets = [], [], []
    values, indexes = [], []
    for i, (v, b, ma) in enumerate(streams):
        cdf = _laplace_cdf(b, ma)
        cdfs.append(cdf)
        lengths.append(len(cdf))
        offsets.append(-ma)
        values.append(v)
        indexes.append(np.full(len(v), i, np.int32))
    L = max(lengths)
    table = np.zeros((len(cdfs), L), np.int32)
    for i, c in enumerate(cdfs):
        table[i, :len(c)] = c
    return rans.encode_with_indexes(
        np.concatenate(values) if values else np.zeros(0, np.int32),
        np.concatenate(indexes) if indexes else np.zeros(0, np.int32),
        table, np.array(lengths, np.int32), np.array(offsets, np.int32))


def _decode_streams(data, specs):
    """specs: list of (count, b, max_abs) in the same order as encoding."""
    cdfs, lengths, offsets, indexes = [], [], [], []
    for i, (n, b, ma) in enumerate(specs):
        cdf = _laplace_cdf(b, ma)
        cdfs.append(cdf)
        lengths.append(len(cdf))
        offsets.append(-ma)
        indexes.append(np.full(n, i, np.int32))
    L = max(lengths)
    table = np.zeros((len(cdfs), L), np.int32)
    for i, c in enumerate(cdfs):
        table[i, :len(c)] = c
    flat = rans.decode_with_indexes(
        data, np.concatenate(indexes) if indexes else np.zeros(0, np.int32),
        table, np.array(lengths, np.int32), np.array(offsets, np.int32))
    out, pos = [], 0
    for n, _, _ in specs:
        out.append(flat[pos:pos + n])
        pos += n
    return out


def compress(points6, q_g=1.0, qp=34, with_color=True):
    """points6: [N, 6] xyz + rgb(in [0,1]).  -> bytes."""
    pts = np.asarray(points6, np.float64)
    xyz = np.floor(pts[:, :3] * q_g).astype(np.int64)
    mins = xyz.min(axis=0)
    xyz = xyz - mins
    depth = max(1, int(np.ceil(np.log2(xyz.max() + 1))) if xyz.max() > 0
                else 1)
    keys = morton_encode_np(xyz)
    order = np.argsort(keys, kind="stable")
    keys = keys[order]
    uniq, inv_start = np.unique(keys, return_index=True)
    geom = octree.encode(uniq, depth)

    header = struct.pack("<4sBBIIf3i", _MAGIC, depth, int(qp),
                         len(uniq), len(pts), float(q_g),
                         int(mins[0]), int(mins[1]), int(mins[2]))
    blob = header + struct.pack("<I", len(geom)) + geom
    if not with_color or pts.shape[1] < 6:
        return blob + struct.pack("<B", 0)

    # average the colors of merged duplicates (tmc3 mergeDuplicatedPoints)
    yuv = _yuv_from_rgb01(pts[order, 3:6])
    seg = np.searchsorted(uniq, keys)
    sums = np.zeros((len(uniq), 3), np.float64)
    np.add.at(sums, seg, yuv)
    counts = np.bincount(seg, minlength=len(uniq)).astype(np.float64)
    attrs = sums / counts[:, None]

    qstep = 2.0 ** ((qp - 4) / 6.0)
    dc, acs = raht_forward(uniq, attrs, depth)
    ac_all = (np.concatenate(acs, axis=0) if acs
              else np.zeros((0, 3), np.float64))
    qac = np.round(ac_all / qstep).astype(np.int64)
    qdc = np.round(dc / qstep).astype(np.int64)

    streams, spec_bytes = [], b""
    for arr in (qac, qdc):
        for ch in range(3):
            v = arr[:, ch]
            b = float(np.mean(np.abs(v))) + 1e-3 if len(v) else 1e-3
            ma = int(min(max(np.abs(v).max() if len(v) else 1, 1), 4096))
            streams.append((np.clip(v, -2 ** 30, 2 ** 30).astype(np.int32),
                            np.float32(b), ma))
            spec_bytes += struct.pack("<fH", np.float32(b), ma)
    coded = _code_streams([(v, b, ma) for v, b, ma in streams])
    return (blob + struct.pack("<B", 1) + spec_bytes
            + struct.pack("<I", len(coded)) + coded)


def decompress(data):
    """-> [M, 6] xyz + rgb (rgb zeros for geometry-only streams)."""
    (magic, depth, qp, n_uniq, n_in, q_g, m0, m1,
     m2) = struct.unpack_from("<4sBBIIf3i", data)
    if magic != _MAGIC:
        raise ValueError("not a RAHT anchor bitstream")
    pos = struct.calcsize("<4sBBIIf3i")
    (geom_len,) = struct.unpack_from("<I", data, pos)
    pos += 4
    uniq = octree.decode(data[pos:pos + geom_len], depth, n_uniq)
    pos += geom_len
    xyz = morton_decode_np(uniq).astype(np.float64)
    xyz += np.array([m0, m1, m2], np.float64)
    xyz = (xyz + 0.5) / q_g if q_g != 1.0 else xyz

    (has_color,) = struct.unpack_from("<B", data, pos)
    pos += 1
    if not has_color:
        return np.concatenate(
            [xyz, np.zeros((len(xyz), 3), np.float64)], axis=1)

    specs = []
    for _ in range(6):
        b, ma = struct.unpack_from("<fH", data, pos)
        pos += struct.calcsize("<fH")
        specs.append((float(b), int(ma)))
    (coded_len,) = struct.unpack_from("<I", data, pos)
    pos += 4

    steps = _raht_structure(uniq, depth)
    ac_counts = [len(s[0]) for s in steps]
    n_ac = int(sum(ac_counts))
    n_dc = len(uniq) - n_ac
    counts = [n_ac] * 3 + [n_dc] * 3
    chans = _decode_streams(data[pos:pos + coded_len],
                            [(n, b, ma) for n, (b, ma) in zip(counts, specs)])
    qstep = 2.0 ** ((qp - 4) / 6.0)
    qac = np.stack(chans[:3], 1).astype(np.float64) * qstep
    qdc = np.stack(chans[3:], 1).astype(np.float64) * qstep
    acs, p = [], 0
    for n in ac_counts:
        acs.append(qac[p:p + n])
        p += n
    yuv = raht_inverse(uniq, depth, qdc, acs)
    return np.concatenate([xyz, _rgb01_from_yuv(yuv)], axis=1)
