"""Point-cloud codec: host orchestration around the model's device methods.

compress: upload the cloud once and sort it on the device by block and
Morton code (``_partition_blocks``); per group of up to 63 blocks (carried
in the key batch bits, one device pass) drop duplicate voxels on the
device and copy the keys back for the host level counts, run g_a and h_a
on the device, code z with the factorized bottleneck's
rANS tables, derive the Gaussian parameters through the decoder's own
params graph, code y with Gaussian rANS and the y coordinates with the
octree coder, and write the v6 container.  decompress inverts it: octree
and z decode, the same params graph, y decode, dequantization and g_s.

geom="coded" replaces the ranked top-k selection by entropy-coded
occupancy bits (codec/refine.py): three staged synthesis passes per side
emit context bins, the host codes each candidate's true bit, and geometry
decodes exactly.  compress_multi shares the q-independent half of the
encode between operating points; compress_stream / decompress_stream keep
several frames in flight on worker threads; a frame's groups run on two
worker threads, or with ``devices=[...]`` round-robin over those devices,
one worker thread per listed entry and one model replica per distinct
device (``parallel/block_parallel.py``).  All of them give the bytes of
the sequential calls.
refit_colors attaches the signaled color layers (codec/color_affine.py,
codec/color_resid.py) that decompress applies.

Static capacities are the JAX package's (powers of two, the same group
constants), so the two packages truncate identically.
"""

import contextlib
import contextvars
import copy
import math
import time
from collections import deque
from concurrent.futures import ThreadPoolExecutor
from typing import NamedTuple

import numpy as np
import torch

from .. import resolve_device
from ..coding import occ as occ_coder
from ..coding import octree, rans
from ..models.entropy import gaussian
from ..models.entropy.bottleneck import build_cdf_tables
from ..models.layers import _TapConv
from ..ops import coords as C
from ..ops import family as F
from ..ops.sparse import SparseTensor, compact
from ..parallel.block_parallel import parallel_map_blocks
from ..utils import profiling
from . import bitstream, color_affine, color_resid, refine

MAX_GROUP = 63  # batch bits hold 6 bits; batch index 63 is reserved
DEC_GROUP_PTS = 800_000
ENC_GROUP_PTS = 800_000
DEC_GROUP_L0 = 262_144
DEC_GROUP_L1 = 524_288
CODEC_MAX_BATCH = 64
LOCAL_BITS = 30  # block-local Morton codes: 3 x 10 bits (block_size <= 1024)
LEX_BLOCKS = 2048  # blocks an axis below which the lexicographic index fits


def _bucket(n, lo=512):
    return max(lo, 1 << max(0, math.ceil(math.log2(max(n, 1)))))


def _chunk_decode_groups(blocks):
    """Split a container's block list into device decode groups: runs of
    equal q, at most MAX_GROUP blocks and bounded summed output and
    level-1/level-0 counts, never mixing coded-occupancy blocks with top-k
    ones (the JAX package's group rule, so group splits match)."""
    items = []
    cur, pts, l1, l0 = [], 0, 0, 0
    for b in blocks:
        bp, b1, b0 = int(b["k"][-1]), int(b["k"][1]), int(b["k"][0])
        if cur and (cur[-1]["q"] != b["q"] or len(cur) == MAX_GROUP
                    or pts + bp > DEC_GROUP_PTS
                    or l1 + b1 > DEC_GROUP_L1
                    or l0 + b0 > DEC_GROUP_L0
                    or (cur[-1].get("occ_bytes") is None)
                    != (b.get("occ_bytes") is None)):
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
    return F.host_levels(keys_np, [None] * n_levels)[1:]


def _z_hs_caps(n_s16, n_z):
    """Static caps shared bit-exactly by encoder and decoder."""
    z_caps = (_bucket(n_s16), _bucket(n_z))
    hs_caps = (_bucket(8 * n_z), _bucket(64 * n_z))
    return z_caps, hs_caps


class EncodeGroup(NamedTuple):
    """Blocks that share one batched encode pass: their points sorted by
    key ``(rank of the block in the group << BATCH_SHIFT) | block-local
    Morton code``, duplicates still in, on the device; and each block's
    origin."""
    keys: torch.Tensor   # int64 [n]
    rgb: torch.Tensor    # f32 [n, 3]
    origins: list        # (x, y, z) ints a block

    @property
    def cap(self):
        return _bucket(self.keys.shape[0])


def _to_device(keys, rgb, device):
    """A group's keys and colors moved to ``device`` in one copy."""
    packed = torch.cat([keys.view(torch.int32).view(-1, 2),
                        rgb.view(torch.int32)], 1).to(device)
    return (packed[:, :2].reshape(-1).view(torch.int64),
            packed[:, 2:].contiguous().view(torch.float32))


def _device_key(device):
    """torch.device with the current CUDA index filled in, so that "cuda"
    and "cuda:0" name one device."""
    dev = resolve_device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


class Codec:
    """``Codec(model, device="cuda", devices=None)``; call ``update()``
    once, then ``compress(pointcloud, q, path=None, block_size=1024)`` and
    ``decompress(data)``.

    devices: a list of devices to dispatch groups of blocks over,
    round-robin, one worker thread per entry (entries may repeat); the
    codec's own device is then the first, and ``update()`` gives every
    other distinct device a replica of the model.  debug and profile run
    the groups in order on the first device."""

    def __init__(self, model, device="cuda", devices=None):
        self.devices = [_device_key(d) for d in devices] if devices else None
        self.device = self.devices[0] if devices else resolve_device(device)
        self._replicas = {}
        if self.device.type == "cuda":
            # plain f32 products stay full f32 (the kernels use bf16 operands
            # with f32 accumulation explicitly)
            torch.backends.cuda.matmul.allow_tf32 = False
            torch.backends.cudnn.allow_tf32 = False
        self.model = model.to(self.device).eval()
        self.tables = None
        self.prepared_bytes = 0
        # debug=True records each block's symbols and entropy parameters
        # (debug_info) and each coded-occupancy stage's context bins
        # (debug_bins) on both sides, and runs everything sequentially
        self.debug = False
        self.debug_info = []
        self.debug_bins = []
        # profile=True: synchronize around each stage and add its wall
        # seconds to stage_times (the JAX codec's `profile` counterpart)
        self.profile = False
        self.stage_times = {}

    @contextlib.contextmanager
    def _stage(self, name):
        """A stage of a frame: a tracer span (``utils/profiling.py``), and
        with ``profile`` its synchronized wall seconds in stage_times (the
        ``sync=True`` spans inside synchronize too)."""
        with profiling.span(name):
            if not self.profile:
                yield
                return
            if self.device.type == "cuda":
                torch.cuda.synchronize(self.device)
            t0 = time.perf_counter()
            with profiling.synchronizing(self.device):
                yield
            if self.device.type == "cuda":
                torch.cuda.synchronize(self.device)
            self.stage_times[name] = self.stage_times.get(name, 0.0) \
                + time.perf_counter() - t0

    def _dev(self, x):
        return torch.as_tensor(np.ascontiguousarray(x)).to(self.device)

    def update(self):
        """Freeze the entropy models into integer CDF tables and prepare
        every tap conv's weights for the gather-GEMM (block list + packed
        operands, once per layer instead of once per call).  Sets
        ``prepared_bytes``, the bytes the prepared weights hold."""
        self.prepared_bytes = sum(
            m.prepare() for m in self.model.modules()
            if isinstance(m, _TapConv))
        bn = self.model.entropy_model.bottleneck
        self.tables = {
            "z": build_cdf_tables(bn.numpy_params(), bn.channels),
            "y": gaussian.build_cdf_tables(),
        }
        # 8-bit color level -> f32 by lookup: CUDA's division by a host
        # scalar multiplies by its reciprocal, one ulp off numpy's quotient
        self._color_levels = self._dev(
            np.arange(256, dtype=np.float32) / 255.0)
        self._replicas = {self.device: self}
        for dev in self.devices or ():
            if dev not in self._replicas:
                self._replicas[dev] = self._replica(dev)

    def _replica(self, device):
        """A codec on ``device`` with its own copy of the model, prepared
        there, for the block-parallel workers (which run with debug and
        profile off)."""
        rep = copy.copy(self)
        rep.device, rep.devices = device, None
        rep.debug = rep.profile = False
        rep.model = copy.deepcopy(self.model).to(device).eval()
        rep.update()
        return rep

    # -- encode --------------------------------------------------------------

    def _check_encode(self, block_size, geom):
        if self.tables is None:
            raise RuntimeError("call update() first")
        if geom not in ("topk", "coded"):
            raise ValueError(f"geom must be 'topk' or 'coded', got {geom!r}")
        if geom == "coded" and self.model.g_s.region_candidates:
            # the JAX codec fails here later, at its prune site
            raise ValueError("geom='coded' is not supported with "
                             "region_candidates: the coded occupancy "
                             "covers 8 children a parent, the region "
                             "candidates the 27-dilated set")
        if block_size > 1024:
            # block-local Morton codes hold 3 x 10 coordinate bits
            raise ValueError("block_size > 1024 not supported")

    @torch.no_grad()
    def compress(self, pointcloud, q, path=None, block_size=1024,
                 scaling_factor=1.0, geom="topk"):
        """pointcloud: numpy [N, 6] (xyz int, rgb in [0, 1]); q: (q_g, q_a).
        Returns the container bytes; with ``path``, writes them there and
        returns None (as the JAX codec does).  block_size <= 1024.

        geom: "topk" (the lossy ranked selection) or "coded" — every
        candidate's true occupancy bit is entropy-coded with the learned
        logit as context, so geometry decodes exactly."""
        self._check_encode(block_size, geom)
        with profiling.frame("codec.compress"):
            with self._stage("enc.partition"):
                groups, levels = self._partition_blocks(
                    pointcloud, block_size, scaling_factor)
            qv = np.asarray(q, np.float32).reshape(1, 2)
            results = self._map_groups(
                lambda c, grp: c._encode_at_q(
                    c._encode_shared(grp, levels), qv, geom),
                groups)
            blocks = [b for r in results for b in r]
            return bitstream.write_container(path, blocks, scaling_factor)

    @torch.no_grad()
    def compress_multi(self, pointcloud, qs, block_size=1024,
                       scaling_factor=1.0, geom="topk"):
        """Multi-rate encode: one container per q in ``qs``, byte-identical
        to ``[compress(pointcloud, q) for q in qs]``.  q conditions only
        the gain and rescale nets after the analysis transform, so g_a, the
        hyper-encoder, the octree coordinate streams and the z streams run
        once; each further operating point pays the params graph, the
        symbols and its y streams (and, for geom="coded", its occupancy
        stages, whose context logits read the dequantized latents)."""
        self._check_encode(block_size, geom)
        with profiling.frame("codec.compress"):
            with self._stage("enc.partition"):
                groups, levels = self._partition_blocks(
                    pointcloud, block_size, scaling_factor)
            # group i runs on the same device (round-robin) in every pass,
            # so each q pass finds its group's shared state there
            shareds = self._map_groups(
                lambda c, grp: c._encode_shared(grp, levels), groups)
            out = []
            for q in qs:
                qv = np.asarray(q, np.float32).reshape(1, 2)
                results = self._map_groups(
                    lambda c, sh: c._encode_at_q(sh, qv, geom), shareds)
                blocks = [b for r in results for b in r]
                out.append(bitstream.write_container(None, blocks,
                                                     scaling_factor))
            return out

    # -- worker threads --------------------------------------------------------

    def _in_worker(self, fn, *args):
        """Body of a worker thread: grad mode and the current CUDA device
        are per thread, so each worker sets its own."""
        ctx = torch.cuda.device(self.device) if self.device.type == "cuda" \
            else contextlib.nullcontext()
        with torch.no_grad(), ctx:
            return fn(*args)

    def _map_groups(self, fn, items):
        """``[fn(codec, item) for item in items]``, ``codec`` the codec of
        the item's device.  Groups go round-robin over ``devices``
        (``parallel_map_blocks``), one worker thread per entry; without
        ``devices``, two workers on this codec overlap one group's host
        entropy coding with another's device passes.  Results keep input
        order, so containers stay byte-identical to the sequential path.
        debug and profile recording need a deterministic stage order and
        force it."""
        if len(items) <= 1 or self.debug or self.profile:
            return [fn(self, item) for item in items]
        return parallel_map_blocks(
            lambda item, dev: self._replicas[dev]._in_worker(
                fn, self._replicas[dev], item),
            items, self.devices or [self.device] * 2)

    def _stream(self, items, fn, depth):
        """Bounded-depth pipeline: up to ``depth`` frames in flight on
        worker threads, results yielded in input order.  While one frame
        runs host entropy coding, the next frame's device passes are
        enqueued.  debug and profile force depth 1."""
        if self.debug or self.profile:
            depth = 1
        depth = max(1, int(depth))
        window = deque()
        with ThreadPoolExecutor(max_workers=depth) as ex:
            for item in items:
                # the worker runs in a copy of this thread's context, so
                # its frame's root span nests where the caller stands
                window.append(ex.submit(contextvars.copy_context().run,
                                        self._in_worker, fn, item))
                if len(window) > depth:
                    yield window.popleft().result()
            while window:
                yield window.popleft().result()

    def compress_stream(self, frames, q, block_size=1024, scaling_factor=1.0,
                        depth=2, geom="topk"):
        """Pipelined encode of an iterable of frames; yields container
        bytes in input order, byte-identical to sequential compress()."""
        yield from self._stream(
            frames, lambda f: self.compress(f, q, block_size=block_size,
                                            scaling_factor=scaling_factor,
                                            geom=geom),
            depth)

    def decompress_stream(self, containers, depth=2):
        """Pipelined decode of an iterable of container byte strings;
        yields [N, 6] frames in input order."""
        yield from self._stream(containers, self.decompress, depth)

    # -- coded-occupancy stages (lossless geometry) ----------------------------
    # Encoder and decoder run the same function on the same shapes and
    # dtypes at every stage, so the context bins agree bit for bit; bins
    # that differ desync the occupancy streams.

    def _refine_stage(self, y_keys, y_sym, dec, keeps, caps, lvl):
        """Stage ``lvl``: levels below it select by the supplied keep
        masks, level ``lvl`` emits the uint8 context bins of its logits."""
        logits = self.model.decode_refine_device(
            y_keys, y_sym, dec, ext_keep=tuple(keeps), num_levels=lvl + 1,
            prune_caps=tuple(caps) + (8,) * (3 - len(caps)))
        if self.debug and not bool(torch.isfinite(logits).all()):
            raise FloatingPointError(f"non-finite occupancy logits at "
                                     f"stage {lvl}")
        return refine.bin_logits(logits)

    def _coded_final(self, y_keys, y_sym, dec, keeps, caps):
        """Final coded-mode pass: all three selections external, the color
        head on the exact decoded voxel set."""
        return self.model.decode_refine_device(
            y_keys, y_sym, dec, ext_keep=tuple(keeps), num_levels=3,
            prune_caps=tuple(caps), emit_last_logits=False)

    def _occ_stages(self, side, y_keys, y_sym, dec, ycap, parents0, g,
                    get_bits):
        """Shared driver of the three staged occupancy passes.

        parents0: sorted valid y keys (numpy).  get_bits(lvl, parents,
        bins_np, block_slices) -> occupancy bool array: the encoder codes
        the true bits and returns them, the decoder decodes them from the
        streams.  Returns (keeps_dev, caps): the three keep masks on the
        device and the selected levels' capacities."""
        keeps_dev, caps = [], ()
        parents = parents0
        for lvl in range(3):
            cap_in = ycap if lvl == 0 else caps[-1]
            with self._stage(f"{side}.occ_bins{lvl}"):
                bins = self._refine_stage(y_keys, y_sym, dec, keeps_dev,
                                          caps, lvl)
                bins_np = bins[:8 * len(parents)].cpu().numpy()
            if self.debug:
                self.debug_bins.append({"side": side, "stage": lvl,
                                        "bins": bins_np.copy()})
            pb = (parents >> C.BATCH_SHIFT).astype(np.int32)
            counts = np.bincount(pb, minlength=g)[:g] * 8
            ofs = np.concatenate([[0], np.cumsum(counts)])
            slices = [slice(int(ofs[i]), int(ofs[i + 1])) for i in range(g)]
            with self._stage(f"{side}.occ_coder"):
                occ = get_bits(lvl, parents, bins_np, slices)
            if profiling.enabled():  # the coded selection is g_s's prune
                profiling.count("gs.generated", len(occ))
                profiling.count("gs.kept", np.count_nonzero(occ))
            sel = refine.children_np(parents)[occ]
            keep_pad = np.zeros(8 * cap_in, bool)
            keep_pad[:len(occ)] = occ
            keeps_dev.append(self._dev(keep_pad))
            caps = caps + (_bucket(len(sel)),)
            parents = sel
        return keeps_dev, caps

    def _partition_blocks(self, pointcloud, block_size, scaling_factor):
        """Upload the cloud once and sort its points on the device by
        (block, block-local Morton code), stably, so that the first
        occurrence of a voxel comes first; form groups of up to MAX_GROUP
        blocks and ENC_GROUP_PTS points from the blocks' point counts.
        Returns ([EncodeGroup, ...], octree levels)."""
        pts = np.asarray(pointcloud)
        if pts.dtype not in (np.float32, np.float64):
            pts = pts.astype(np.float64)
        profiling.count("enc.partition.h2d_bytes", pts.nbytes)
        pts = self._dev(pts)
        xyz = pts[:, :3]
        if scaling_factor != 1.0:
            # a device divisor: CUDA divides by a host scalar through its
            # reciprocal, which can round differently from numpy
            sf = torch.tensor(scaling_factor, dtype=torch.float64,
                              device=self.device)
            xyz = torch.round(xyz.to(torch.float64) / sf)
        xyz = xyz.to(torch.int32)
        mins = xyz.amin(0)
        d = (xyz - mins).to(torch.int64)
        bidx = torch.div(d, block_size, rounding_mode="floor")
        morton = C.morton_encode(d - bidx * block_size)
        head = torch.cat([mins.to(torch.int64), bidx.amax(0)]).tolist()
        mins, nb = head[:3], [b + 1 for b in head[3:]]
        lex = max(nb) < LEX_BLOCKS
        if lex:
            # the lexicographic block index, below 2^33
            bid = (bidx[:, 0] * nb[1] + bidx[:, 1]) * nb[2] + bidx[:, 2]
        else:
            # the block's dense rank in lexicographic order, below N
            corners, bid = torch.unique(bidx, dim=0, return_inverse=True)
        skeys, order = torch.sort((bid << LOCAL_BITS) | morton, stable=True)
        ids, counts = torch.unique_consecutive(skeys >> LOCAL_BITS,
                                               return_counts=True)
        if lex:
            corners = torch.stack([ids // (nb[1] * nb[2]),
                                   ids // nb[2] % nb[1], ids % nb[2]], 1)
        nblk = ids.shape[0]
        host = torch.cat([corners.reshape(-1), counts]).tolist()
        corners, sizes = host[:3 * nblk], host[3 * nblk:]
        # each point's block ordinal, then its key within its group
        blk = torch.repeat_interleave(
            torch.arange(nblk, device=self.device), counts,
            output_size=xyz.shape[0])
        skeys = skeys & ((1 << LOCAL_BITS) - 1)
        rgb = pts[:, 3:6].to(torch.float32)[order]

        def group(j0, j1, s, e):
            keys = ((blk[s:e] - j0) << C.BATCH_SHIFT) | skeys[s:e]
            return EncodeGroup(keys, rgb[s:e], [
                tuple(mins[a] + corners[3 * j + a] * block_size
                      for a in range(3)) for j in range(j0, j1)])

        levels = max(1, int(math.ceil(math.log2(max(block_size // 8, 2)))))
        groups = []
        first = start = end = 0
        for j, n in enumerate(sizes):
            if j > first and (j - first == MAX_GROUP
                              or end - start + n > ENC_GROUP_PTS):
                groups.append(group(first, j, start, end))
                first, start = j, end
            end += n
        groups.append(group(first, nblk, start, end))
        return groups, levels

    def _voxelize_group(self, group):
        """The group's voxels on this codec's device: duplicates dropped
        (first occurrence wins) by K3, keys sentinel-padded and colors
        zero-padded to ``group.cap``, colors on the 8-bit grid.  Returns
        (SparseTensor, the keys copied to the host)."""
        keys, rgb = group.keys, group.rgb
        # the color table's device: self.device may lack the CUDA index
        if keys.device != self._color_levels.device:
            keys, rgb = _to_device(keys, rgb, self.device)
        keep = torch.ones_like(keys, dtype=torch.bool)
        keep[1:] = keys[1:] != keys[:-1]
        keys, rgb = compact(keys, keep, rgb, out_capacity=group.cap)
        colors8 = torch.clamp(torch.round(rgb * 255.0), 0, 255).to(
            torch.uint8)
        feats = self._color_levels[colors8.long()]
        keys_host = keys.cpu().numpy()
        profiling.count("enc.voxelize.d2h_bytes", keys_host.nbytes)
        profiling.count("enc.voxelize.voxels",
                        np.searchsorted(keys_host, C.SENTINEL))
        return SparseTensor(keys=keys, feats=feats), keys_host

    def _encode_shared(self, group, levels):
        """q-independent half of the encode: voxelize, host level counts and
        root maps, g_a and h_a on the device."""
        m = self.model
        g = len(group.origins)
        with self._stage("enc.voxelize"):
            x, keys_host = self._voxelize_group(group)

        # exact host downsample chain (s2..s32) sizes every device pyramid;
        # its s16 and s32 levels are g_a's and h_a's roots
        with self._stage("enc.host_levels"):
            lvl_keys = _host_downsample_levels(keys_host, 5)
            ga_caps4 = tuple(_bucket(len(k)) for k in lvl_keys[:4])
            _, ga_rn_idx, ga_rn_ok = F.host_self_map(lvl_keys[3],
                                                     ga_caps4[3])

        with self._stage("enc.analysis"):
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
            _, z_rn_idx, z_rn_ok = F.host_self_map(lvl_keys[4], z_caps[1])
            z_rn = (self._dev(z_rn_idx), self._dev(z_rn_ok))
            hyp = m.hyper_analyze_device(enc["y_keys"], enc["y_feats"], z_rn,
                                         z_caps)

        yv = y_keys_np != C.SENTINEL
        y_batches = (y_keys_np[yv] >> C.BATCH_SHIFT).astype(np.int32)
        ny_b = np.bincount(y_batches, minlength=g)[:g]
        n_z = len(lvl_keys[4])
        z_batches = (lvl_keys[4] >> C.BATCH_SHIFT).astype(np.int32)
        nz_b = np.bincount(z_batches, minlength=g)[:g]
        return {"levels": levels, "origins": group.origins, "enc": enc,
                "hyp": hyp, "z_rn": z_rn, "y_keys_np": y_keys_np, "yv": yv,
                "n_y": n_y, "ycap": ycap, "z_caps": z_caps,
                # exact level sets the coded-occupancy mode selects: the
                # targets at strides 4, 2, 1 (sorted, batch-major)
                "gt_levels": (lvl_keys[1], lvl_keys[0],
                              keys_host[keys_host != C.SENTINEL]),
                # q-independent per-block streams and counts, filled by
                # the first q pass and shared by the later ones
                "z_bytes": None, "coord_bytes": None, "k_all": None,
                "hs_caps": hs_caps, "n_z": n_z, "ny_b": ny_b,
                "y_ofs": np.concatenate([[0], np.cumsum(ny_b)]),
                "nz_b": nz_b, "z_ofs": np.concatenate([[0], np.cumsum(nz_b)])}

    def _encode_at_q(self, sh, qv, geom="topk"):
        """q-dependent half: the decoder's params graph, y symbols, and the
        per-block rANS and octree streams (coordinate and z streams are
        coded once and kept in ``sh`` across q passes).  geom="coded" also
        codes every candidate's occupancy, closed loop: the context logits
        read the dequantized latents, so these streams depend on q."""
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
            if sh["k_all"] is None:
                sh["k_all"] = enc["k"].cpu().numpy()

        occ_streams = None
        if geom == "coded":
            g = len(sh["origins"])
            occ_streams = [[] for _ in range(g)]

            def code_bits(lvl, parents, bins_np, slices):
                occ = refine.occupancy_np(refine.children_np(parents),
                                          sh["gt_levels"][lvl])
                for i, sl in enumerate(slices):
                    occ_streams[i].append(occ_coder.encode(occ[sl],
                                                           bins_np[sl]))
                return occ

            self._occ_stages("enc", enc["y_keys"], y_sym, dec, sh["ycap"],
                             y_keys_np[yv], g, code_bits)

        zch = hyp["z_sym"].shape[1]
        if self.debug:
            scales = dec["scales_hat"][:n_y].cpu().numpy()
            means = dec["means_hat"][:n_y].cpu().numpy()

        blocks = []
        with self._stage("enc.entropy_coding"):
            fill_shared = sh["z_bytes"] is None
            if fill_shared:
                sh["z_bytes"], sh["coord_bytes"] = [], []
            for i, origin in enumerate(sh["origins"]):
                blocks.append(self._code_block(sh, i, origin, qv, z_vals,
                                               y_vals, y_idx, zch,
                                               fill_shared))
                if occ_streams:
                    blocks[-1]["occ_bytes"] = tuple(occ_streams[i])
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

    def _code_block(self, sh, i, origin, qv, z_vals, y_vals, y_idx, zch,
                    fill_shared):
        """rANS (z, y) and octree (y coordinates) streams of block i."""
        zt, yt = self.tables["z"], self.tables["y"]
        y_ofs, z_ofs = sh["y_ofs"], sh["z_ofs"]
        if fill_shared:
            zi = z_vals[z_ofs[i]:z_ofs[i + 1]].reshape(-1)
            z_idx = np.tile(np.arange(zch, dtype=np.int32),
                            int(sh["nz_b"][i]))
            sh["z_bytes"].append(rans.encode_with_indexes(
                zi, z_idx, zt["cdf"], zt["cdf_length"], zt["offset"]))
            morton = sh["y_keys_np"][sh["yv"]][y_ofs[i]:y_ofs[i + 1]] \
                & C.KEY_MASK
            sh["coord_bytes"].append(octree.encode(morton, sh["levels"]))
        yi = y_vals[y_ofs[i]:y_ofs[i + 1]].reshape(-1)
        yidx_i = y_idx[y_ofs[i]:y_ofs[i + 1]].reshape(-1)
        y_bytes = rans.encode_with_indexes(yi, yidx_i, yt["cdf"],
                                           yt["cdf_length"], yt["offset"])
        return {"origin": origin, "levels": sh["levels"],
                "n_y": int(sh["ny_b"][i]), "n_z": int(sh["nz_b"][i]),
                "q": (float(qv[0, 0]), float(qv[0, 1])),
                "k": sh["k_all"][:, i].tolist(),
                "coord_bytes": sh["coord_bytes"][i],
                "y_bytes": y_bytes, "z_bytes": sh["z_bytes"][i]}

    # -- decode --------------------------------------------------------------

    @torch.no_grad()
    def decompress(self, data):
        """Returns numpy [N, 6] (xyz int, rgb in [0, 1] on the 8-bit grid,
        then the container's signaled color corrections, if any)."""
        if self.tables is None:
            raise RuntimeError("call update() first")
        with profiling.frame("codec.decompress"):
            return self._decompress(data)

    def _decompress(self, data):
        blocks, scaling_factor = bitstream.read_container(data)
        outs = self._map_groups(lambda c, blks: c._decompress_group(blks),
                                _chunk_decode_groups(blocks))
        # each group's cloud is a fresh array, so one group is the frame
        x = outs[0] if len(outs) == 1 else np.concatenate(outs, axis=0)
        if scaling_factor != 1.0:
            x[:, :3] = x[:, :3] * scaling_factor
        # frame-level signaled color corrections ride the first block: the
        # affine, then the residual layer, in the order the encoder fitted
        aff = blocks[0].get("color_affine") if blocks else None
        if aff is not None and len(x):
            x[:, 3:6] = color_affine.apply(x[:, 3:6], aff)
        resid = blocks[0].get("color_resid") if blocks else None
        if resid is not None and len(x):
            x[:, 3:6] = color_resid.apply(x, resid)
        return x

    def refit_colors(self, data, source_pc, rec=None, source_tree=None,
                     resid_lam=0.0, fit_affine=True, resid_floor=0.0):
        """Encoder-side color refit: fit the frame's signaled corrections
        against the source and return ``(new container bytes, corrected
        reconstruction)``; the reconstruction equals
        ``decompress(new container bytes)``.  ``rec`` skips the decode when
        the caller has already decoded ``data``.

        Two layers, both optional and both counted in the new container's
        length: the 48-byte affine (codec/color_affine.py) and, when
        ``resid_lam`` > 0, the RAHT-coded residual layer
        (codec/color_resid.py) fitted on the affine-corrected colors with
        Lagrangian weight ``resid_lam``.  Geometry and every entropy-coded
        payload stay byte-identical.  A container that already carries a
        color layer is refused: ``rec`` would include that layer, and the
        new fit would no longer describe what a decoder reconstructs."""
        data = bytes(data)
        blocks, scaling_factor = bitstream.read_container(data)
        for key in ("color_affine", "color_resid"):
            if blocks[0].get(key) is not None:
                raise ValueError(f"container already carries {key}")
        if rec is None:
            rec = self.decompress(data)
        src = np.asarray(source_pc)
        out = np.array(rec, copy=True)
        aff = payload = None
        if fit_affine:
            aff, _gain = color_affine.fit(out, src, source_tree=source_tree)
        if aff is not None:
            out[:, 3:6] = color_affine.apply(out[:, 3:6], aff)
        if resid_lam > 0.0:
            payload, corrected, _info = color_resid.fit(
                out, src, resid_lam, source_tree=source_tree,
                d_floor=resid_floor)
            if payload is not None:
                out[:, 3:6] = corrected
        if aff is None and payload is None:
            return data, out
        if aff is not None:
            blocks[0]["color_affine"] = aff
        if payload is not None:
            blocks[0]["color_resid"] = payload
        return bitstream.write_container(None, blocks, scaling_factor), out

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
            _, z_rn_idx, z_rn_ok = F.host_self_map(lvl[1], zcap)
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

        if blks[0].get("occ_bytes") is not None:
            # coded-occupancy container: each level's bits are decoded
            # against the device-computed logit bins and fed back as the
            # next stage's selection
            y_sym_dev = self._dev(y_sym)

            def decode_bits(lvl, parents, bins_np, slices):
                occ = np.empty(8 * len(parents), bool)
                for b, sl in zip(blks, slices):
                    occ[sl] = occ_coder.decode(b["occ_bytes"][lvl],
                                               bins_np[sl]).astype(bool)
                return occ

            keeps, ccaps = self._occ_stages(
                "dec", y_keys, y_sym_dev, dec, ycap,
                y_keys_np[y_keys_np != C.SENTINEL], g, decode_bits)
            with self._stage("dec.synthesis"):
                st = self._coded_final(y_keys, y_sym_dev, dec, keeps, ccaps)
            with self._stage("dec.fetch"):
                return self._fetch_points(blks, st)

        k = np.zeros((3, CODEC_MAX_BATCH), np.int32)
        for i, b in enumerate(blks):
            k[:, i] = b["k"]
        slack = m.g_s.prune_slack
        prune_caps = tuple(
            _bucket(int(np.ceil(k[lv].astype(np.float64)
                                * (slack[lv] if lv < len(slack) else 1.0))
                        .sum())) for lv in range(3))
        with self._stage("dec.synthesis"):
            if profiling.enabled():
                n_y_b = np.zeros(CODEC_MAX_BATCH, np.int64)
                n_y_b[:g] = [b["n_y"] for b in blks]
                for gen, kept in m.g_s.prune_counts(n_y_b, k):
                    profiling.count("gs.generated", gen)
                    profiling.count("gs.kept", kept)
            st = m.decode_reconstruct_device(y_keys, self._dev(y_sym), dec,
                                             self._dev(k), prune_caps)
        with self._stage("dec.fetch"):
            return self._fetch_points(blks, st)

    def _fetch_points(self, blks, st):
        """Assemble the [N, 6] cloud on the device from the decoded sparse
        tensor and copy it to the host once."""
        # the final compaction leaves the valid rows in a contiguous prefix
        n = int(st.valid.sum())
        keys = st.keys[:n]
        bu = torch.clamp_max(keys >> C.BATCH_SHIFT, len(blks) - 1)
        origins = self._dev(np.asarray([b["origin"] for b in blks], np.int32))
        colors8 = torch.clamp(torch.round(st.feats[:n].float() * 255.0),
                              0, 255).to(torch.uint8)
        out = torch.empty((n, 6), dtype=torch.float32, device=self.device)
        out[:, :3] = C.morton_decode(keys & C.KEY_MASK) + origins[bu]
        out[:, 3:] = self._color_levels[colors8.long()]
        profiling.count("dec.fetch.d2h_bytes", out.nbytes)
        return out.cpu().numpy()
