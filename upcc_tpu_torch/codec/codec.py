"""Point-cloud codec: host orchestration around the model's device methods.

compress: partition the cloud into blocks; per group of up to 63 blocks
(carried in the key batch bits, one device pass) voxelize on the host,
run g_a and h_a on the device, code z with the factorized bottleneck's
rANS tables, derive the Gaussian parameters through the decoder's own
params graph, code y with Gaussian rANS and the y coordinates with the
octree coder, and write the v6 container.  decompress inverts it: octree
and z decode, the same params graph, y decode, dequantization and g_s.

Static capacities are the JAX package's (powers of two, the same group
constants), so the two packages truncate identically.  Not ported yet:
geom="coded", compress_multi, streaming, refit_colors and the color
affine/residual layers (decompress rejects containers that carry them).
"""

import contextlib
import math
import time

import numpy as np
import torch

from .. import resolve_device
from ..coding import octree, rans
from ..models.entropy import gaussian
from ..models.entropy.bottleneck import build_cdf_tables
from ..ops import coords as C
from ..ops import family as F
from ..ops.sparse import SparseTensor, voxelize_host_np
from . import bitstream

MAX_GROUP = 63  # batch bits hold 6 bits; batch index 63 is reserved
DEC_GROUP_PTS = 800_000
ENC_GROUP_PTS = 800_000
DEC_GROUP_L0 = 262_144
DEC_GROUP_L1 = 524_288
CODEC_MAX_BATCH = 64


def _bucket(n, lo=512):
    return max(lo, 1 << max(0, math.ceil(math.log2(max(n, 1)))))


def _chunk_decode_groups(blocks):
    """Split a container's block list into device decode groups: runs of
    equal q, at most MAX_GROUP blocks and bounded summed output and
    level-1/level-0 counts (the JAX package's group rule, so group splits
    match)."""
    items = []
    cur, pts, l1, l0 = [], 0, 0, 0
    for b in blocks:
        bp, b1, b0 = int(b["k"][-1]), int(b["k"][1]), int(b["k"][0])
        if cur and (cur[-1]["q"] != b["q"] or len(cur) == MAX_GROUP
                    or pts + bp > DEC_GROUP_PTS
                    or l1 + b1 > DEC_GROUP_L1
                    or l0 + b0 > DEC_GROUP_L0):
            items.append(cur)
            cur, pts, l1, l0 = [], 0, 0, 0
        cur.append(b)
        pts += bp
        l1 += b1
        l0 += b0
    if cur:
        items.append(cur)
    return items


def _host_downsample_levels(keys_np, n_levels):
    """Exact per-level octree downsamples (numpy): the sorted valid key
    array of each coarser level, batch bits preserved."""
    m = np.asarray(keys_np)
    m = m[m != C.SENTINEL]
    out = []
    for _ in range(n_levels):
        m = np.unique((m & ~C.KEY_MASK) | ((m & C.KEY_MASK) >> 3))
        out.append(m)
    return out


def _z_hs_caps(n_s16, n_z):
    """Static caps shared bit-exactly by encoder and decoder."""
    z_caps = (_bucket(n_s16), _bucket(n_z))
    hs_caps = (_bucket(8 * n_z), _bucket(64 * n_z))
    return z_caps, hs_caps


class Codec:
    """``Codec(model, device="cuda")``; call ``update()`` once, then
    ``compress(pointcloud, q, block_size)`` and ``decompress(data)``."""

    def __init__(self, model, device="cuda"):
        self.device = resolve_device(device)
        if self.device.type == "cuda":
            # plain f32 products stay full f32 (the kernels use bf16 operands
            # with f32 accumulation explicitly)
            torch.backends.cuda.matmul.allow_tf32 = False
            torch.backends.cudnn.allow_tf32 = False
        self.model = model.to(self.device).eval()
        self.tables = None
        self.debug = False
        self.debug_info = []
        # profile=True: synchronize around each stage and add its wall
        # seconds to stage_times (the JAX codec's `profile` counterpart)
        self.profile = False
        self.stage_times = {}

    @contextlib.contextmanager
    def _stage(self, name):
        if not self.profile:
            yield
            return
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        t0 = time.perf_counter()
        yield
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        self.stage_times[name] = self.stage_times.get(name, 0.0) \
            + time.perf_counter() - t0

    def _dev(self, x):
        return torch.as_tensor(np.ascontiguousarray(x)).to(self.device)

    def update(self):
        """Freeze the entropy models into integer CDF tables."""
        bn = self.model.entropy_model.bottleneck
        self.tables = {
            "z": build_cdf_tables(bn.numpy_params(), bn.channels),
            "y": gaussian.build_cdf_tables(),
        }

    # -- encode --------------------------------------------------------------

    @torch.no_grad()
    def compress(self, pointcloud, q, block_size=1024, scaling_factor=1.0):
        """pointcloud: numpy [N, 6] (xyz int, rgb in [0, 1]); q: (q_g, q_a).
        Returns the container bytes.  block_size <= 1024."""
        if self.tables is None:
            raise RuntimeError("call update() first")
        if block_size > 1024:
            # block-local Morton codes hold 3 x 10 coordinate bits
            raise ValueError("block_size > 1024 not supported")
        with self._stage("enc.partition"):
            groups, levels = self._partition_blocks(pointcloud, block_size,
                                                    scaling_factor)
        qv = np.asarray(q, np.float32).reshape(1, 2)
        blocks = []
        for group, origins in groups:
            shared = self._encode_shared(group, origins, levels)
            blocks += self._encode_at_q(shared, qv)
        return bitstream.write_container(None, blocks, scaling_factor)

    def _partition_blocks(self, pointcloud, block_size, scaling_factor):
        """Sort points into per-block groups of up to MAX_GROUP blocks;
        returns ([(blocks, origins), ...], octree levels)."""
        pts = np.asarray(pointcloud)
        xyz = pts[:, :3].astype(np.float64)
        if scaling_factor != 1.0:
            xyz = np.round(xyz / scaling_factor)
        xyz = xyz.astype(np.int32)
        rgb = pts[:, 3:6].astype(np.float32)

        mins = xyz.min(axis=0)
        bidx = (xyz - mins) // block_size
        order = np.lexsort((bidx[:, 2], bidx[:, 1], bidx[:, 0]))
        xyz, rgb, bidx = xyz[order], rgb[order], bidx[order]
        change = np.any(np.diff(bidx, axis=0) != 0, axis=1)
        bounds = np.concatenate([[0], np.where(change)[0] + 1, [len(xyz)]])

        levels = max(1, int(math.ceil(math.log2(max(block_size // 8, 2)))))
        groups = []
        group, group_origins, gpts = [], [], 0
        for s, e in zip(bounds[:-1], bounds[1:]):
            bxyz = xyz[s:e]
            if group and (len(group) == MAX_GROUP
                          or gpts + (e - s) > ENC_GROUP_PTS):
                groups.append((group, group_origins))
                group, group_origins, gpts = [], [], 0
            origin = mins + ((bxyz[0] - mins) // block_size) * block_size
            group.append((bxyz - origin, rgb[s:e]))
            group_origins.append(tuple(int(v) for v in origin))
            gpts += e - s
        if group:
            groups.append((group, group_origins))
        return groups, levels

    def _encode_shared(self, group, origins, levels):
        """q-independent half of the encode: voxelize, host level counts and
        root maps, g_a and h_a on the device."""
        m = self.model
        g = len(group)
        batch = np.concatenate([np.full(len(x), i, np.int32)
                                for i, (x, _) in enumerate(group)])
        local = np.concatenate([x for x, _ in group])
        colors = np.concatenate([c for _, c in group])
        cap = _bucket(len(local))
        with self._stage("enc.voxelize"):
            keys_host, feats_host = voxelize_host_np(batch, local, colors,
                                                     cap)

        # exact host downsample chain (s2..s32) sizes every device pyramid
        with self._stage("enc.host_levels"):
            lvl_keys = _host_downsample_levels(keys_host, 5)
            ga_caps4 = tuple(_bucket(len(k)) for k in lvl_keys[:4])
            _, ga_rn_idx, ga_rn_ok = F.host_root_neighbors(
                keys_host, 4, ga_caps4[3], list(ga_caps4))

        # colors travel on the 8-bit grid (padding rows are zero)
        colors_u8 = np.clip(np.round(feats_host * 255.0), 0, 255
                            ).astype(np.uint8)
        feats = colors_u8.astype(np.float32) / np.float32(255.0)
        with self._stage("enc.analysis"):
            x = SparseTensor(keys=self._dev(keys_host),
                             feats=self._dev(feats))
            enc = m.ga_device(x, (self._dev(ga_rn_idx),
                                  self._dev(ga_rn_ok)),
                              ga_caps4, max_batch=CODEC_MAX_BATCH)

        # y is the exact s8 downsample of the input keys
        n_y = len(lvl_keys[2])
        ycap = _bucket(n_y)
        assert ycap == ga_caps4[2]
        y_keys_np = np.full(ycap, C.SENTINEL, np.int64)
        y_keys_np[:n_y] = lvl_keys[2]

        z_caps, hs_caps = _z_hs_caps(len(lvl_keys[3]), len(lvl_keys[4]))
        with self._stage("enc.hyper"):
            _, z_rn_idx, z_rn_ok = F.host_root_neighbors(
                y_keys_np, 2, z_caps[1], list(z_caps))
            z_rn = (self._dev(z_rn_idx), self._dev(z_rn_ok))
            hyp = m.hyper_analyze_device(enc["y_keys"], enc["y_feats"], z_rn,
                                         z_caps)

        yv = y_keys_np != C.SENTINEL
        y_batches = (y_keys_np[yv] >> C.BATCH_SHIFT).astype(np.int32)
        ny_b = np.bincount(y_batches, minlength=g)[:g]
        n_z = len(lvl_keys[4])
        z_batches = (lvl_keys[4] >> C.BATCH_SHIFT).astype(np.int32)
        nz_b = np.bincount(z_batches, minlength=g)[:g]
        return {"levels": levels, "origins": origins, "enc": enc,
                "hyp": hyp, "z_rn": z_rn, "y_keys_np": y_keys_np, "yv": yv,
                "n_y": n_y, "z_caps": z_caps,
                "hs_caps": hs_caps, "n_z": n_z, "ny_b": ny_b,
                "y_ofs": np.concatenate([[0], np.cumsum(ny_b)]),
                "nz_b": nz_b, "z_ofs": np.concatenate([[0], np.cumsum(nz_b)])}

    def _encode_at_q(self, sh, qv):
        """q-dependent half: the decoder's params graph, y symbols, and the
        per-block rANS and octree streams."""
        m = self.model
        enc, hyp = sh["enc"], sh["hyp"]
        n_y, n_z = sh["n_y"], sh["n_z"]
        y_keys_np, yv = sh["y_keys_np"], sh["yv"]
        y_ofs, z_ofs = sh["y_ofs"], sh["z_ofs"]
        with self._stage("enc.params"):
            dec = m.decode_params_device(enc["y_keys"], hyp["z_sym"],
                                         self._dev(qv), sh["z_rn"],
                                         sh["z_caps"], sh["hs_caps"])
        with self._stage("enc.symbols"):
            y_sym = m.encode_symbols_device(enc["y_feats"], dec)
            z_vals = hyp["z_sym"][:n_z].cpu().numpy()
            y_vals = y_sym[:n_y].cpu().numpy()
            y_idx = dec["indexes"][:n_y].cpu().numpy().astype(np.int32)
            k_all = enc["k"].cpu().numpy()

        zch = hyp["z_sym"].shape[1]
        if self.debug:
            scales = dec["scales_hat"][:n_y].cpu().numpy()
            means = dec["means_hat"][:n_y].cpu().numpy()

        blocks = []
        with self._stage("enc.entropy_coding"):
            for i, origin in enumerate(sh["origins"]):
                blocks.append(self._code_block(sh, i, origin, qv, z_vals,
                                               y_vals, y_idx, k_all, zch))
        if self.debug:
            for i in range(len(blocks)):
                sl = slice(y_ofs[i], y_ofs[i + 1])
                self.debug_info.append({
                    "side": "enc", "y_sym": y_vals[sl].reshape(-1).copy(),
                    "z_sym": z_vals[z_ofs[i]:z_ofs[i + 1]].reshape(-1).copy(),
                    "y_idx": y_idx[sl].reshape(-1).copy(),
                    "y_keys": y_keys_np[yv][sl] & C.KEY_MASK,
                    "scales": scales[sl].copy(), "means": means[sl].copy()})
        return blocks

    def _code_block(self, sh, i, origin, qv, z_vals, y_vals, y_idx, k_all,
                    zch):
        """rANS (z, y) and octree (y coordinates) streams of block i."""
        zt, yt = self.tables["z"], self.tables["y"]
        y_ofs, z_ofs = sh["y_ofs"], sh["z_ofs"]
        zi = z_vals[z_ofs[i]:z_ofs[i + 1]].reshape(-1)
        z_idx = np.tile(np.arange(zch, dtype=np.int32), int(sh["nz_b"][i]))
        z_bytes = rans.encode_with_indexes(zi, z_idx, zt["cdf"],
                                           zt["cdf_length"], zt["offset"])
        yi = y_vals[y_ofs[i]:y_ofs[i + 1]].reshape(-1)
        yidx_i = y_idx[y_ofs[i]:y_ofs[i + 1]].reshape(-1)
        y_bytes = rans.encode_with_indexes(yi, yidx_i, yt["cdf"],
                                           yt["cdf_length"], yt["offset"])
        morton = sh["y_keys_np"][sh["yv"]][y_ofs[i]:y_ofs[i + 1]] & C.KEY_MASK
        return {"origin": origin, "levels": sh["levels"],
                "n_y": int(sh["ny_b"][i]), "n_z": int(sh["nz_b"][i]),
                "q": (float(qv[0, 0]), float(qv[0, 1])),
                "k": k_all[:, i].tolist(),
                "coord_bytes": octree.encode(morton, sh["levels"]),
                "y_bytes": y_bytes, "z_bytes": z_bytes}

    # -- decode --------------------------------------------------------------

    @torch.no_grad()
    def decompress(self, data):
        """Returns numpy [N, 6] (xyz int, rgb in [0, 1] on the 8-bit grid)."""
        if self.tables is None:
            raise RuntimeError("call update() first")
        blocks, scaling_factor = bitstream.read_container(data)
        for b in blocks:
            for key in ("occ_bytes", "color_affine", "color_resid"):
                if b.get(key) is not None:
                    raise NotImplementedError(
                        f"container carries {key}: coded geometry and the "
                        "color layers are not ported")
        outs = [self._decompress_group(blks)
                for blks in _chunk_decode_groups(blocks)]
        x = np.concatenate(outs, axis=0)
        if scaling_factor != 1.0:
            x[:, :3] = x[:, :3] * scaling_factor
        return x

    def _decompress_group(self, blks):
        """Decode up to MAX_GROUP blocks in one batched device pass."""
        m = self.model
        g = len(blks)
        zt, yt = self.tables["z"], self.tables["y"]
        q0 = np.asarray(blks[0]["q"], np.float32)
        for b in blks[1:]:
            if not np.array_equal(np.asarray(b["q"], np.float32), q0):
                raise ValueError("mixed per-block q inside one decode group")

        with self._stage("dec.octree"):
            mortons = [octree.decode(b["coord_bytes"], b["levels"],
                                     b["n_y"] + 8) for b in blks]
        for b, mo in zip(blks, mortons):
            if mo.size != b["n_y"]:
                raise ValueError("coordinate count mismatch")
        n_y = sum(b["n_y"] for b in blks)
        ycap = _bucket(n_y)
        y_keys_np = np.full(ycap, C.SENTINEL, np.int64)
        pos = 0
        for i, mo in enumerate(mortons):
            y_keys_np[pos:pos + len(mo)] = mo | (np.int64(i) << C.BATCH_SHIFT)
            pos += len(mo)
        y_keys = self._dev(y_keys_np)

        zch = zt["cdf"].shape[0]
        z_rows = []
        with self._stage("dec.rans_z"):
            for b in blks:
                z_idx = np.tile(np.arange(zch, dtype=np.int32), b["n_z"])
                vals = rans.decode_with_indexes(
                    b["z_bytes"], z_idx, zt["cdf"], zt["cdf_length"],
                    zt["offset"])
                z_rows.append(vals.reshape(b["n_z"], zch))
        lvl = _host_downsample_levels(y_keys_np, 2)
        if len(lvl[1]) != sum(b["n_z"] for b in blks):
            raise ValueError("bitstream z-count mismatch")
        z_caps, hs_caps = _z_hs_caps(len(lvl[0]), len(lvl[1]))
        zcap = z_caps[1]
        z_sym = np.zeros((zcap, zch), np.int16)
        z_all = np.concatenate(z_rows)
        z_sym[:len(z_all)] = z_all

        with self._stage("dec.params"):
            _, z_rn_idx, z_rn_ok = F.host_root_neighbors(y_keys_np, 2, zcap,
                                                         list(z_caps))
            dec = m.decode_params_device(
                y_keys, self._dev(z_sym),
                self._dev(np.asarray(blks[0]["q"], np.float32).reshape(1, 2)),
                (self._dev(z_rn_idx), self._dev(z_rn_ok)), z_caps, hs_caps)
            y_idx = dec["indexes"][:n_y].cpu().numpy().astype(np.int32)

        cb = m.entropy_model.C_bottleneck
        y_sym = np.zeros((ycap, cb), np.int16)
        pos = 0
        with self._stage("dec.rans_y"):
            for b in blks:
                idx_i = y_idx[pos:pos + b["n_y"]].reshape(-1)
                vals = rans.decode_with_indexes(
                    b["y_bytes"], idx_i, yt["cdf"], yt["cdf_length"],
                    yt["offset"])
                y_sym[pos:pos + b["n_y"]] = vals.reshape(b["n_y"], cb)
                pos += b["n_y"]

        if self.debug:
            scales = dec["scales_hat"][:n_y].cpu().numpy()
            means = dec["means_hat"][:n_y].cpu().numpy()
            pos, zpos = 0, 0
            for b in blks:
                sl = slice(pos, pos + b["n_y"])
                self.debug_info.append({
                    "side": "dec", "y_sym": y_sym[sl].reshape(-1).copy(),
                    "z_sym": z_all[zpos:zpos + b["n_z"]].reshape(-1).copy(),
                    "y_idx": y_idx[sl].reshape(-1).copy(),
                    "y_keys": (y_keys_np[sl] & C.KEY_MASK).copy(),
                    "scales": scales[sl].copy(), "means": means[sl].copy()})
                pos += b["n_y"]
                zpos += b["n_z"]

        k = np.zeros((3, CODEC_MAX_BATCH), np.int32)
        for i, b in enumerate(blks):
            k[:, i] = b["k"]
        slack = m.g_s.prune_slack
        prune_caps = tuple(
            _bucket(int(np.ceil(k[lv].astype(np.float64)
                                * (slack[lv] if lv < len(slack) else 1.0))
                        .sum())) for lv in range(3))
        with self._stage("dec.synthesis"):
            st = m.decode_reconstruct_device(y_keys, self._dev(y_sym), dec,
                                             self._dev(k), prune_caps)
        with self._stage("dec.fetch"):
            return self._fetch_points(blks, st)

    def _fetch_points(self, blks, st):
        """Assemble the [N, 6] host cloud from the decoded sparse tensor."""
        # the final compaction leaves the valid rows in a contiguous prefix
        n = int(st.valid.sum())
        keys = st.keys[:n].cpu().numpy()
        colors8 = torch.clamp(torch.round(st.feats[:n].float() * 255.0),
                              0, 255).to(torch.uint8).cpu().numpy()
        g = len(blks)
        bu = np.minimum(keys >> C.BATCH_SHIFT, g - 1)
        units = C.morton_decode_np(keys & C.KEY_MASK)
        origins = np.asarray([b["origin"] for b in blks], np.int32)
        xyz = units + origins[bu]
        colors = colors8.astype(np.float32) / 255.0
        return np.concatenate([xyz.astype(np.float32), colors], axis=1)
