"""The codec's reference: a frame's encode and decode through the frozen
plain model, without the entropy coders, the bytes its blocks' y and z
streams take (``rate``), and the numbers that judge the port's decoded
frames against it.

The block partition, the host voxelization, level counts and root maps,
g_a, h_a, the z rounding, the decoder's params graph, the y symbols, the
decode groups, the prune capacities, dequantization and g_s follow the
port's ``Codec`` (``codec/codec.py``) rule for rule.  The rANS and octree
coders are lossless, so the reference hands its own symbols, coordinates
and counts from the encode to the decode; a port whose coders or
container lose or change anything decodes another frame and is judged
by what it decoded.
"""

import math

import numpy as np
import torch

from .plain.ops import coords as C
from .plain.ops import family as F
from .plain.ops.sparse import SparseTensor, voxelize_host_np
from . import rate, work

MAX_GROUP = 63
DEC_GROUP_PTS = 800_000
ENC_GROUP_PTS = 800_000
DEC_GROUP_L0 = 262_144
DEC_GROUP_L1 = 524_288
CODEC_MAX_BATCH = 64


def _bucket(n, lo=512):
    return max(lo, 1 << max(0, math.ceil(math.log2(max(n, 1)))))


def _z_hs_caps(n_s16, n_z):
    return (_bucket(n_s16), _bucket(n_z)), (_bucket(8 * n_z),
                                            _bucket(64 * n_z))


def _downsample_levels(keys_np, n_levels):
    m = np.asarray(keys_np)
    m = m[m != C.SENTINEL]
    out = []
    for _ in range(n_levels):
        m = np.unique((m & ~C.KEY_MASK) | ((m & C.KEY_MASK) >> 3))
        out.append(m)
    return out


def _decode_groups(blocks):
    """Runs of blocks decoded in one device pass (the codec's rule)."""
    items, cur, pts, l1, l0 = [], [], 0, 0, 0
    for b in blocks:
        bp, b1, b0 = int(b["k"][-1]), int(b["k"][1]), int(b["k"][0])
        if cur and (len(cur) == MAX_GROUP or pts + bp > DEC_GROUP_PTS
                    or l1 + b1 > DEC_GROUP_L1 or l0 + b0 > DEC_GROUP_L0):
            items.append(cur)
            cur, pts, l1, l0 = [], 0, 0, 0
        cur.append(b)
        pts += bp
        l1 += b1
        l0 += b0
    if cur:
        items.append(cur)
    return items


def partition(frame, block_size):
    """[(blocks [(local xyz, rgb)], origins)], octree levels."""
    pts = np.asarray(frame)
    xyz = pts[:, :3].astype(np.float64).astype(np.int32)
    rgb = pts[:, 3:6].astype(np.float32)
    mins = xyz.min(axis=0)
    bidx = (xyz - mins) // block_size
    order = np.lexsort((bidx[:, 2], bidx[:, 1], bidx[:, 0]))
    sidx = bidx[order]
    change = np.any(np.diff(sidx, axis=0) != 0, axis=1)
    bounds = np.concatenate([[0], np.where(change)[0] + 1, [len(xyz)]])
    xyz, rgb = xyz[order], rgb[order]
    levels = max(1, int(math.ceil(math.log2(max(block_size // 8, 2)))))
    groups, group, origins, gpts = [], [], [], 0
    for s, e in zip(bounds[:-1], bounds[1:]):
        bxyz = xyz[s:e]
        if group and (len(group) == MAX_GROUP
                      or gpts + (e - s) > ENC_GROUP_PTS):
            groups.append((group, origins))
            group, origins, gpts = [], [], 0
        origin = mins + ((bxyz[0] - mins) // block_size) * block_size
        group.append((bxyz - origin, rgb[s:e]))
        origins.append(tuple(int(v) for v in origin))
        gpts += e - s
    if group:
        groups.append((group, origins))
    return groups, levels


def _dev(x, device):
    return torch.as_tensor(np.ascontiguousarray(x)).to(device)


def _encode_group(model, group, origins, q, device, tables):
    """One encode group: the blocks' symbols, coordinates and counts, and
    the bytes of their y and z streams under ``tables``."""
    g = len(group)
    batch = np.concatenate([np.full(len(x), i, np.int32)
                            for i, (x, _) in enumerate(group)])
    local = np.concatenate([x for x, _ in group])
    colors = np.concatenate([c for _, c in group])
    keys_host, feats_host = voxelize_host_np(batch, local, colors,
                                             _bucket(len(local)))
    lvl_keys = _downsample_levels(keys_host, 5)
    ga_caps4 = tuple(_bucket(len(k)) for k in lvl_keys[:4])
    _, rn_idx, rn_ok = F.host_root_neighbors(keys_host, 4, ga_caps4[3],
                                             list(ga_caps4))
    colors_u8 = np.clip(np.round(feats_host * 255.0), 0, 255).astype(np.uint8)
    feats = colors_u8.astype(np.float32) / np.float32(255.0)
    x = SparseTensor(keys=_dev(keys_host, device), feats=_dev(feats, device))
    enc = model.ga_device(x, (_dev(rn_idx, device), _dev(rn_ok, device)),
                          ga_caps4, max_batch=CODEC_MAX_BATCH)
    n_y = len(lvl_keys[2])
    y_keys_np = np.full(_bucket(n_y), C.SENTINEL, np.int64)
    y_keys_np[:n_y] = lvl_keys[2]
    z_caps, hs_caps = _z_hs_caps(len(lvl_keys[3]), len(lvl_keys[4]))
    _, z_idx, z_ok = F.host_root_neighbors(y_keys_np, 2, z_caps[1],
                                           list(z_caps))
    z_rn = (_dev(z_idx, device), _dev(z_ok, device))
    hyp = model.hyper_analyze_device(enc["y_keys"], enc["y_feats"], z_rn,
                                     z_caps)
    qv = _dev(np.asarray(q, np.float32).reshape(1, 2), device)
    dec = model.decode_params_device(enc["y_keys"], hyp["z_sym"], qv, z_rn,
                                     z_caps, hs_caps)
    y_sym = model.encode_symbols_device(enc["y_feats"], dec)
    n_z = len(lvl_keys[4])
    y_vals = y_sym[:n_y].cpu().numpy()
    z_vals = hyp["z_sym"][:n_z].cpu().numpy()
    k_all = enc["k"].cpu().numpy()
    yv = y_keys_np[:n_y]
    ny_b = np.bincount((yv >> C.BATCH_SHIFT).astype(np.int64),
                       minlength=g)[:g]
    nz_b = np.bincount((lvl_keys[4] >> C.BATCH_SHIFT).astype(np.int64),
                       minlength=g)[:g]
    y_ofs = np.concatenate([[0], np.cumsum(ny_b)])
    z_ofs = np.concatenate([[0], np.cumsum(nz_b)])
    z_sym = hyp["z_sym"][:n_z]
    z_idx = torch.arange(z_sym.shape[1], device=device).expand_as(z_sym)
    y_bytes = rate.stream_bytes(rate.row_bits(
        y_sym[:n_y], dec["indexes"][:n_y], tables["y"]), y_ofs)
    z_bytes = rate.stream_bytes(rate.row_bits(z_sym, z_idx, tables["z"]),
                                z_ofs)
    blocks = []
    for i, origin in enumerate(origins):
        blocks.append({
            "origin": origin, "q": tuple(float(v) for v in q),
            "k": k_all[:, i].tolist(), "n_y": int(ny_b[i]),
            "n_z": int(nz_b[i]), "y_bytes": float(y_bytes[i]),
            "z_bytes": float(z_bytes[i]),
            "morton": yv[y_ofs[i]:y_ofs[i + 1]] & C.KEY_MASK,
            "y": y_vals[y_ofs[i]:y_ofs[i + 1]],
            "z": z_vals[z_ofs[i]:z_ofs[i + 1]]})
    return blocks


def _decode_group(model, blks, device):
    """One decode group: the decoded [N, 6] points of its blocks."""
    n_y = sum(len(b["morton"]) for b in blks)
    ycap = _bucket(n_y)
    y_keys_np = np.full(ycap, C.SENTINEL, np.int64)
    pos = 0
    for i, b in enumerate(blks):
        y_keys_np[pos:pos + len(b["morton"])] = \
            b["morton"] | (np.int64(i) << C.BATCH_SHIFT)
        pos += len(b["morton"])
    lvl = _downsample_levels(y_keys_np, 2)
    z_caps, hs_caps = _z_hs_caps(len(lvl[0]), len(lvl[1]))
    z_all = np.concatenate([b["z"] for b in blks])
    z_sym = np.zeros((z_caps[1], z_all.shape[1]), np.int16)
    z_sym[:len(z_all)] = z_all
    _, z_idx, z_ok = F.host_root_neighbors(y_keys_np, 2, z_caps[1],
                                           list(z_caps))
    y_keys = _dev(y_keys_np, device)
    qv = _dev(np.asarray(blks[0]["q"], np.float32).reshape(1, 2), device)
    dec = model.decode_params_device(
        y_keys, _dev(z_sym, device), qv,
        (_dev(z_idx, device), _dev(z_ok, device)), z_caps, hs_caps)
    y_all = np.concatenate([b["y"] for b in blks])
    y_sym = np.zeros((ycap, y_all.shape[1]), np.int16)
    y_sym[:len(y_all)] = y_all
    k = np.zeros((3, CODEC_MAX_BATCH), np.int32)
    for i, b in enumerate(blks):
        k[:, i] = b["k"]
    slack = model.g_s.prune_slack
    prune_caps = tuple(
        _bucket(int(np.ceil(k[lv].astype(np.float64)
                            * (slack[lv] if lv < len(slack) else 1.0)).sum()))
        for lv in range(3))
    st = model.decode_reconstruct_device(y_keys, _dev(y_sym, device), dec,
                                         _dev(k, device), prune_caps)
    n = int(st.valid.sum())
    keys = st.keys[:n].cpu().numpy()
    colors8 = torch.clamp(torch.round(st.feats[:n].float() * 255.0), 0, 255
                          ).to(torch.uint8).cpu().numpy()
    bu = np.minimum(keys >> C.BATCH_SHIFT, len(blks) - 1)
    origins = np.asarray([b["origin"] for b in blks], np.int32)
    xyz = C.morton_decode_np(keys & C.KEY_MASK) + origins[bu]
    return np.concatenate([xyz.astype(np.float32),
                           colors8.astype(np.float32) / 255.0], axis=1)


@torch.no_grad()
def roundtrip(model, frame, q, block_size, device, counts=None,
              blocks=None):
    """The reference's decoded [N, 6] frame.  ``counts``: a dict that gets
    the encode's and the decode's operation counts (``work.counting``)
    under "enc" and "dec"; ``blocks``: a list that gets each block's
    origin, n_y, n_z, k and y and z bytes, in the container's order."""
    counts = {} if counts is None else counts
    blocks = [] if blocks is None else blocks
    F.full_f32()
    tables = rate.tables(model, device)
    with work.counting(counts.setdefault("enc", {})):
        groups, _levels = partition(frame, block_size)
        for group, origins in groups:
            blocks += _encode_group(model, group, origins, q, device,
                                    tables)
    with work.counting(counts.setdefault("dec", {})):
        outs = [_decode_group(model, blks, device)
                for blks in _decode_groups(blocks)]
    return np.concatenate(outs, axis=0)


def _voxel_keys(points):
    xyz = np.asarray(points[:, :3]).astype(np.int64)
    return (xyz[:, 0] << 42) | (xyz[:, 1] << 21) | xyz[:, 2]


def decoded_gaps(port, ref):
    """(geometry gap, color gap) of a decoded frame against the
    reference's: the voxels in one set and not the other over the
    reference's count, and the mean absolute difference of the colors of
    the voxels in both, in 8-bit levels."""
    kp, kr = _voxel_keys(port), _voxel_keys(ref)
    if len(np.unique(kp)) != len(kp):
        return float("inf"), float("inf")
    common, ip, ir = np.intersect1d(kp, kr, assume_unique=True,
                                    return_indices=True)
    geom = (len(kp) + len(kr) - 2 * len(common)) / max(len(kr), 1)
    if not len(common):
        return geom, float("inf")
    dc = np.abs(np.round(port[ip, 3:6].astype(np.float64) * 255.0)
                - np.round(ref[ir, 3:6].astype(np.float64) * 255.0))
    return float(geom), float(dc.mean())


GAPS = ("count_gap", "geom_gap", "color_gap", "fields_differ", "rate_gap")


def frame_gaps(decoded, blocks, ref, ref_blocks):
    """The numbers of one frame: a side's decoded frame and its blocks
    (``rate.container_blocks`` of its container, or its own estimate)
    against the reference's."""
    geom, color = decoded_gaps(decoded, ref)
    differ, gap = rate.block_gaps(blocks, ref_blocks)
    return {"count_gap": abs(len(decoded) - len(ref)), "geom_gap": geom,
            "color_gap": color, "fields_differ": differ, "rate_gap": gap}
