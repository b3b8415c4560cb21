"""Signaled residual color enhancement layer (RAHT-coded YUV residuals).

The synthesis color head saturates near the top of the rate range:
eval-time *global* corrections (codec/color_affine.py) cannot move
that ceiling because the remaining error is spatial.  The standard scalable-
codec answer is an enhancement layer: the encoder decodes its own stream,
nearest-neighbor-associates each decoded point with the source (exactly the
evaluation metric's BA association incl. equidistant-tie averaging,
eval/metrics.py::_directional), and codes the quantized YUV residuals as an
optional second layer.

Coding per-point residuals memorylessly would cost several bits/point; the
residuals are still spatially correlated, so they ride the same
Region-Adaptive Hierarchical Transform used by the native anchor
(codec/raht.py, de Queiroz & Chou 2016): orthonormal, structure replayed
from the *decoded* geometry on both sides, so the only side information is
the per-subband quantizer selection and the Laplace stream specs.

Rate-distortion optimization is per (subband, channel) — the transform is
orthonormal and the streams are independent, so the Lagrangian
J = bits + lam * w_c * sse is fully separable: every octree-level band of
every YUV channel independently picks a step from the ladder (or drops the
band outright at zero bits), like classic subband coders.  Two caps keep
the search honest against the *symmetric* metric:
  * lam is the experiment's own lambda_A(q_a) schedule (training-loss
    units), so the layer engages exactly where the base layer's RD slope
    has flattened and stays off at low q_a;
  * the per-channel AB-direction floor (estimate_ab_floor): once the BA
    error is below what the metric's other direction can see, refining
    further is wasted rate — the per-channel lambda backs off until the
    achieved distortion sits at the floor.

The payload rides the container's first block under FLAG_COLOR_RESID
(bitstream.py v6) and is counted in every reported bpp; it is applied
after the affine refit.  Numpy and scipy only; the same arithmetic as the
JAX package's module of this name, so payloads are byte-identical.
"""

import struct

import numpy as np

from ..ops.coords import morton_encode_np
from . import raht

# Quantization step ladder (any channel/band); index 255 = band dropped
# (all coefficients zero at zero bits).  float32-signaled per selection so
# the ladder can change without a container bump.
CANDIDATE_STEPS = (1.0, 1.5, 2.0, 3.0, 4.0, 6.0, 8.0, 12.0,
                   16.0, 24.0, 32.0, 48.0, 64.0)
_DROP = 255
_MAGIC = b"U2"
_MAX_ABS_CAP = 4096
# AC bands = octree levels, finest first; levels past the cap share the
# last band (they hold few coefficients)
MAX_AC_BANDS = 6


def _metric_w():
    """Channel weights of the metric's yuv_psnr = (6y+u+v)/8."""
    return np.array([6.0, 1.0, 1.0], np.float64) / 8.0


def _sorted_unique_keys(xyz):
    """Morton keys of the decoded geometry in canonical (sorted) order.

    Returns (ukeys, depth, inv) with ``inv`` mapping each input row to its
    unique-key slot — identical on encoder and decoder because it depends
    only on the decoded coordinates.  Duplicate voxels (possible after
    multi-block concatenation at block seams) share one slot; their
    residuals are averaged and they receive the same correction.
    """
    ipts = np.round(np.asarray(xyz, np.float64)).astype(np.int64)
    mins = ipts.min(axis=0)
    loc = ipts - mins
    top = int(loc.max()) if len(loc) else 0
    depth = max(1, int(np.ceil(np.log2(top + 1))) if top > 0 else 1)
    keys = morton_encode_np(loc)
    ukeys, inv = np.unique(keys, return_inverse=True)
    return ukeys, depth, inv


def _avg_by_slot(values, inv, n_slots):
    sums = np.zeros((n_slots, values.shape[1]), np.float64)
    np.add.at(sums, inv, values)
    counts = np.bincount(inv, minlength=n_slots).astype(np.float64)
    return sums / counts[:, None]


def _ba_targets_yuv(rec, source, source_tree):
    """The metric's BA association targets: for each decoded point, the
    equidistant-tie-averaged color of its nearest source points, in the
    0-255 YUV convention (raht._yuv_from_rgb01)."""
    k = min(8, len(source))
    dist, idx = source_tree.query(rec[:, :3], k=k)
    if k == 1:
        dist, idx = dist[:, None], idx[:, None]
    src_yuv = raht._yuv_from_rgb01(source[:, 3:6])
    d2 = dist ** 2
    ties = (d2 - d2[:, :1]) < 1e-8
    w = ties.astype(np.float64)
    return (src_yuv[idx] * w[..., None]).sum(1) / w.sum(1, keepdims=True)


def _band_slices(ac_counts):
    """(start, end) into the concatenated AC stack per band: one octree
    level (3 merge steps) per band, finest first, tail levels merged into
    the last band.  Derived from geometry alone — identical both sides."""
    edges = []
    pos = 0
    for step, cnt in enumerate(ac_counts):
        band = min(step // 3, MAX_AC_BANDS - 1)
        if band >= len(edges):
            edges.append([pos, pos])
        edges[band][1] = pos + cnt
        pos += cnt
    return [tuple(e) for e in edges]


def _laplace_bits(q):
    """Codelength estimate (bits) of an int stream under its own Laplace
    fit — matches raht._code_streams' model within ~1%."""
    if len(q) == 0:
        return 0.0
    b = float(np.mean(np.abs(q))) + 1e-3
    kmax = int(min(max(np.abs(q).max(), 1), _MAX_ABS_CAP))
    k = np.arange(-kmax, kmax + 1, dtype=np.float64)
    pmf = np.exp(-np.abs(k) / b)
    pmf /= pmf.sum()
    lp = -np.log2(np.maximum(pmf, 1e-12))
    return float(lp[np.clip(q, -kmax, kmax) + kmax].sum())


def estimate_ab_floor(rec, source, source_tree=None, sample=25_000, seed=0):
    """Sampled per-channel estimate ([Y, U, V] mse01) of the metric's
    AB-direction color floor under a perfect BA correction.

    The sym metric is min(AB, BA): once the residual layer drives the BA
    error to ~0, each source point s still reads the corrected color of its
    nearest rec point r, which is r's own nearest-source tie-average — for
    voxel-exact hits that is s itself (error -> quantization only), for
    misses it is a neighbor's color.  Quantizing far below that neighbor-
    variation floor buys nothing the metric can see, so fit() backs its
    per-channel lambda off at the floor.  Depends on geometry + source
    colors only (geometry is q_g-driven), so callers can cache it per
    (sequence, q_g)."""
    from scipy.spatial import cKDTree

    rec = np.asarray(rec, np.float64)
    source = np.asarray(source, np.float64)
    if len(rec) == 0 or len(source) == 0 or source.shape[1] < 6:
        return np.zeros(3)
    if source_tree is None:
        source_tree = cKDTree(source[:, :3])
    rng = np.random.default_rng(seed)
    idx = (rng.choice(len(source), sample, replace=False)
           if len(source) > sample else np.arange(len(source)))
    s_pts = source[idx, :3]
    # nearest rec point of each sampled source point...
    rtree = cKDTree(rec[:, :3])
    _, i_r = rtree.query(s_pts, k=1)
    # ...whose corrected color will be its own tie-averaged source target
    t = _ba_targets_yuv(rec[i_r], source, source_tree)
    s_yuv = raht._yuv_from_rgb01(source[idx, 3:6])
    return ((t - s_yuv) ** 2).mean(axis=0) / 255.0 ** 2


def fit(rec, source, lam, source_tree=None, steps=CANDIDATE_STEPS,
        d_floor=0.0):
    """Fit the residual enhancement layer for one decoded frame.

    rec, source: [N, 6] (xyz, rgb01); ``rec`` colors should already carry
    any upstream correction (the affine refit).  ``lam`` is the Lagrangian
    color weight in training-loss units (lambda_A(q_a); J = bpp + lam *
    weighted YUV mse on the [0,1] scale).  ``d_floor``: scalar or [3]
    per-channel mse01 floor from estimate_ab_floor.

    Returns (payload bytes | None, corrected rgb01 | None, info dict).  The
    corrected colors are bit-identical to what ``apply`` produces on the
    decoder side (both dequantize the same integer coefficients through
    raht_inverse on the same geometry-derived structure).
    """
    from scipy.spatial import cKDTree

    rec = np.asarray(rec, np.float64)
    source = np.asarray(source, np.float64)
    info = {"engaged": False}
    if (len(rec) == 0 or len(source) == 0 or rec.shape[1] < 6
            or source.shape[1] < 6 or lam <= 0.0):
        return None, None, info
    if source_tree is None:
        source_tree = cKDTree(source[:, :3])
    floor3 = np.broadcast_to(np.asarray(d_floor, np.float64), (3,)).copy()

    ukeys, depth, inv = _sorted_unique_keys(rec[:, :3])
    targets = _ba_targets_yuv(rec, source, source_tree)
    rec_yuv = raht._yuv_from_rgb01(rec[:, 3:6])
    resid = _avg_by_slot(targets - rec_yuv, inv, len(ukeys))

    dc, acs = raht.raht_forward(ukeys, resid, depth)
    ac_all = (np.concatenate(acs, axis=0) if acs
              else np.zeros((0, 3), np.float64))
    bands = _band_slices([len(a) for a in acs])  # AC bands
    nb = len(bands) + 1                          # + DC band (last)

    n = float(len(rec))
    w = _metric_w()
    steps = np.asarray(steps, np.float64)
    ns = len(steps)

    def _coefs(b):
        return dc if b == nb - 1 else ac_all[bands[b][0]:bands[b][1]]

    # RD tables per (band, channel): sse + estimated bits per ladder step,
    # and the drop candidate (sse = band energy, 0 bits).  Also cache the
    # quantized ints so the winning selection encodes without re-quantizing.
    sse = np.zeros((nb, 3, ns + 1))
    bits = np.zeros((nb, 3, ns + 1))
    qcache = {}
    for b in range(nb):
        v = _coefs(b)
        for si, s in enumerate(steps):
            q = np.round(v / s).astype(np.int64)
            qcache[(b, si)] = q
            e = v - q * s
            sse[b, :, si] = (e ** 2).sum(axis=0)
            for c in range(3):
                bits[b, c, si] = _laplace_bits(q[:, c])
        sse[b, :, ns] = (v ** 2).sum(axis=0)  # drop
        bits[b, :, ns] = 0.0

    # Lagrangian in ABSOLUTE totals: total bits + lam * w_c * total SSE on
    # the [0,1] scale — the per-point form (bpp + lam * mse01) times n
    sse01 = sse / 255.0 ** 2
    per_item_overhead = 8 * 10  # spec bytes per coded (band, channel)

    def _select(c, lam_c):
        cost = bits[:, c, :] + np.where(
            np.arange(ns + 1) < ns, per_item_overhead, 0.0) \
            + lam_c * w[c] * sse01[:, c, :]
        return np.argmin(cost, axis=1)

    # per-channel lambda backs off geometrically until the achieved
    # distortion is at (not far below) the channel's AB floor
    sel = np.zeros((nb, 3), np.int64)
    for c in range(3):
        lam_c = lam
        pick = _select(c, lam_c)
        floor_sse01 = floor3[c] * n
        for _ in range(12):
            d_c = sse01[np.arange(nb), c, pick].sum()
            if floor_sse01 <= 0 or d_c >= 0.8 * floor_sse01:
                break
            lam_c *= 0.25
            pick = _select(c, lam_c)
        sel[:, c] = pick

    d_sel01 = np.array([sse01[np.arange(nb), c, sel[:, c]].sum() / n
                        for c in range(3)])
    d_off01 = np.array([sse01[:, c, ns].sum() / n for c in range(3)])
    d_eff = float((w * np.maximum(d_sel01, floor3)).sum())
    d_off_eff = float((w * np.maximum(d_off01, floor3)).sum())
    info["d_off_mse01"] = d_off_eff
    info["d_floor"] = floor3
    if np.all(sel == ns):  # everything dropped: nothing to signal
        return None, None, info

    # ---- encode the winning selection --------------------------------
    # the spec of each coded stream carries its own f32 step, so the
    # decoder never depends on the encoder's candidate ladder
    streams, spec_bytes, order = [], b"", []
    for b in range(nb):
        for c in range(3):
            if sel[b, c] == ns:
                continue
            vq = qcache[(b, int(sel[b, c]))][:, c]
            bl = float(np.mean(np.abs(vq))) + 1e-3 if len(vq) else 1e-3
            ma = int(min(max(np.abs(vq).max() if len(vq) else 1, 1),
                         _MAX_ABS_CAP))
            streams.append((np.clip(vq, -2 ** 30, 2 ** 30).astype(np.int32),
                            np.float32(bl), ma))
            spec_bytes += struct.pack("<ffH",
                                      np.float32(steps[sel[b, c]]),
                                      np.float32(bl), ma)
            order.append((b, c))
    coded = raht._code_streams(streams)
    sel_bytes = bytes(
        1 if sel[b, c] != ns else _DROP
        for b in range(nb) for c in range(3))
    payload = (_MAGIC + struct.pack("<B", nb) + sel_bytes + spec_bytes
               + struct.pack("<I", len(coded)) + coded)

    # final decision against the actual coded size (the estimate is ~1%
    # optimistic); only signal when the layer genuinely pays
    if len(payload) * 8 / n + lam * d_eff >= lam * d_off_eff:
        return None, None, info

    corr = _apply_sel(rec, ukeys, depth, inv, acs, sel, steps, qcache)
    y_steps = [float(steps[sel[b, 0]]) for b in range(nb) if sel[b, 0] != ns]
    info.update({"engaged": True,
                 "step": float(np.median(y_steps)) if y_steps else None,
                 "bytes": len(payload), "d_mse01": d_eff,
                 "n_streams": len(order)})
    return payload, corr, info


def _dequant_stacks(acs_counts, nb, bands, q_by_stream, step_by_stream,
                    n_dc):
    """Rebuild dequantized (dc, acs-concatenated) float arrays from the
    coded (band, channel) streams — shared by encoder and decoder so the
    correction is bit-identical on both sides."""
    total_ac = sum(acs_counts)
    ac_val = np.zeros((total_ac, 3), np.float64)
    dc_val = np.zeros((n_dc, 3), np.float64)
    for (b, c), vq in q_by_stream.items():
        s = float(step_by_stream[(b, c)])
        if b == nb - 1:
            dc_val[:, c] = vq.astype(np.float64) * s
        else:
            lo, hi = bands[b]
            ac_val[lo:hi, c] = vq.astype(np.float64) * s
    return dc_val, ac_val


def _apply_sel(rec, ukeys, depth, inv, acs, sel, steps, qcache):
    """Encoder-side application of the winning selection (must equal the
    decoder's apply): dequantize, inverse transform, add, round to the
    8-bit RGB grid (the decompress contract)."""
    acs_counts = [len(a) for a in acs]
    bands = _band_slices(acs_counts)
    nb = len(bands) + 1
    ns = len(steps)
    q_by_stream, step_by_stream = {}, {}
    for b in range(nb):
        for c in range(3):
            if sel[b, c] != ns:
                q_by_stream[(b, c)] = qcache[(b, int(sel[b, c]))][:, c]
                # float32 through the signaling path, exactly as decoded
                step_by_stream[(b, c)] = float(
                    np.float32(steps[sel[b, c]]))
    dc_val, ac_val = _dequant_stacks(acs_counts, nb, bands, q_by_stream,
                                     step_by_stream,
                                     len(ukeys) - sum(acs_counts))
    return _reconstruct(rec, ukeys, depth, inv, acs_counts, dc_val, ac_val)


def _reconstruct(rec, ukeys, depth, inv, acs_counts, dc_val, ac_val):
    acs_out, p = [], 0
    for m in acs_counts:
        acs_out.append(ac_val[p:p + m])
        p += m
    resid = raht.raht_inverse(ukeys, depth, dc_val, acs_out)
    yuv = raht._yuv_from_rgb01(rec[:, 3:6]) + resid[inv]
    rgb = raht._rgb01_from_yuv(yuv)
    return (np.round(rgb * 255.0) / 255.0).astype(np.float32)


def apply(rec, payload):
    """Decoder side: rec [N, 6] (xyz on the voxel grid, rgb01) -> corrected
    rgb01 on the 8-bit grid.  Inverse of ``fit``'s signaling."""
    rec = np.asarray(rec, np.float64)
    if payload is None or len(rec) == 0:
        return rec[:, 3:6].astype(np.float32)
    if payload[:2] != _MAGIC:
        raise ValueError("bad color-residual payload magic")
    pos = 2
    (nb,) = struct.unpack_from("<B", payload, pos)
    pos += 1
    sel = np.frombuffer(payload[pos:pos + nb * 3],
                        np.uint8).reshape(nb, 3).astype(np.int64)
    pos += nb * 3

    ukeys, depth, inv = _sorted_unique_keys(rec[:, :3])
    tsteps = raht._raht_structure(ukeys, depth)
    acs_counts = [len(s[0]) for s in tsteps]
    bands = _band_slices(acs_counts)
    if nb != len(bands) + 1:
        raise ValueError(
            f"color-residual band mismatch: payload has {nb} bands, "
            f"geometry implies {len(bands) + 1}")
    n_dc = len(ukeys) - sum(acs_counts)

    specs, counts, order, step_by_stream = [], [], [], {}
    for b in range(nb):
        for c in range(3):
            if sel[b, c] == _DROP:
                continue
            step, bl, ma = struct.unpack_from("<ffH", payload, pos)
            pos += struct.calcsize("<ffH")
            specs.append((float(bl), int(ma)))
            counts.append(n_dc if b == nb - 1
                          else bands[b][1] - bands[b][0])
            order.append((b, c))
            step_by_stream[(b, c)] = float(step)
    (coded_len,) = struct.unpack_from("<I", payload, pos)
    pos += 4
    chans = raht._decode_streams(
        payload[pos:pos + coded_len],
        [(cn, bl, ma) for cn, (bl, ma) in zip(counts, specs)])
    q_by_stream = {bc: vq for bc, vq in zip(order, chans)}
    dc_val, ac_val = _dequant_stacks(acs_counts, nb, bands, q_by_stream,
                                     step_by_stream, n_dc)
    return _reconstruct(rec, ukeys, depth, inv, acs_counts, dc_val, ac_val)
