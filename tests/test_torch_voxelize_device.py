"""The encoder's voxel set is built on the device: ``Codec._partition_blocks``
uploads the cloud once and sorts it stably by (block, block-local Morton
code), ``Codec._voxelize_group`` drops duplicate voxels with K3 and puts
the colors on the 8-bit grid.  Both are held against the host path they
replaced (``host_groups`` below: ``shard_points_by_block``, then
``voxelize_host_np`` and the numpy color quantization), group by group,
and whole containers against a codec that still runs that host path."""

import collections

import numpy as np
import pytest
import torch

from upcc_tpu_torch.codec import codec as codec_mod
from upcc_tpu_torch.codec.codec import Codec, _bucket
from upcc_tpu_torch.data.synthetic import surface_cloud
from upcc_tpu_torch.models.unified import UnifiedModel
from upcc_tpu_torch.ops import coords as C
from upcc_tpu_torch.ops.sparse import SparseTensor, voxelize_host_np
from upcc_tpu_torch.parallel.block_parallel import shard_points_by_block
from upcc_tpu_torch.utils import profiling as P
from upcc_tpu_torch.weights import flagship_config

torch.set_num_threads(2)

Q = (0.5, 0.5)
QS = [(0.5, 0.5), (0.2, 0.8)]
HostGroup = collections.namedtuple("HostGroup", "blocks origins")


def host_partition(pointcloud, block_size, scaling_factor):
    """The block partition as it ran on the host: a lexsort by block, then
    groups of up to MAX_GROUP blocks and ENC_GROUP_PTS points."""
    pts = np.asarray(pointcloud)
    xyz = pts[:, :3].astype(np.float64)
    if scaling_factor != 1.0:
        xyz = np.round(xyz / scaling_factor)
    xyz = xyz.astype(np.int32)
    rgb = pts[:, 3:6].astype(np.float32)
    order, bounds, mins = shard_points_by_block(xyz, block_size)
    xyz, rgb = xyz[order], rgb[order]
    groups, group, origins, gpts = [], [], [], 0
    for s, e in zip(bounds[:-1], bounds[1:]):
        bxyz = xyz[s:e]
        if group and (len(group) == codec_mod.MAX_GROUP
                      or gpts + (e - s) > codec_mod.ENC_GROUP_PTS):
            groups.append(HostGroup(group, origins))
            group, origins, gpts = [], [], 0
        origin = mins + ((bxyz[0] - mins) // block_size) * block_size
        group.append((bxyz - origin, rgb[s:e]))
        origins.append(tuple(int(v) for v in origin))
        gpts += e - s
    if group:
        groups.append(HostGroup(group, origins))
    return groups


def host_voxelize(group):
    """(keys, 8-bit-grid colors, cap) of a host group, as the host made
    them: the native voxelizer, then the quantization in numpy."""
    batch = np.concatenate([np.full(len(x), i, np.int32)
                            for i, (x, _) in enumerate(group.blocks)])
    local = np.concatenate([x for x, _ in group.blocks])
    colors = np.concatenate([c for _, c in group.blocks])
    cap = _bucket(len(local))
    keys, feats = voxelize_host_np(batch, local, colors, cap)
    colors_u8 = np.clip(np.round(feats * 255.0), 0, 255).astype(np.uint8)
    return keys, colors_u8.astype(np.float32) / np.float32(255.0), cap


def host_groups(pointcloud, block_size, scaling_factor):
    return [(g.origins, *host_voxelize(g))
            for g in host_partition(pointcloud, block_size, scaling_factor)]


class HostPathCodec(Codec):
    """A codec whose partition and voxelization run on the host as before;
    everything after them is the codec's own."""

    def _partition_blocks(self, pointcloud, block_size, scaling_factor):
        levels = max(1, int(np.ceil(np.log2(max(block_size // 8, 2)))))
        return host_partition(pointcloud, block_size, scaling_factor), levels

    def _voxelize_group(self, group):
        keys, feats, _ = host_voxelize(group)
        return SparseTensor(keys=self._dev(keys), feats=self._dev(feats)), \
            keys


def make_model():
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(0)
        return UnifiedModel(flagship_config(16))


def make_codec(device, cls=Codec, model=None, **kw):
    c = cls(model if model is not None else make_model(), device=device,
            **kw)
    c.update()
    return c


def cloud(xyz, rgb):
    return np.concatenate([np.asarray(xyz, np.float32),
                           np.asarray(rgb, np.float32)], 1)


def case_duplicates(rng):
    """Every voxel several times, each copy in another color."""
    xyz = rng.integers(0, 40, (300, 3))
    xyz = np.concatenate([xyz, xyz[::-1], xyz[::3]])
    return cloud(xyz, rng.random((len(xyz), 3))), 16, 1.0


def case_groups(rng):
    """Many blocks of known sizes; the group limits are set so that one
    group fills ENC_GROUP_PTS exactly (``limits``)."""
    parts = []
    for i in range(11):
        n = 40 + 7 * i
        xyz = rng.integers(0, 16, (n, 3)) + np.array([16 * i, 32 * (i % 2),
                                                      0])
        parts.append(cloud(xyz, rng.random((n, 3))))
    return np.concatenate(parts), 16, 1.0


def case_negative(rng):
    xyz = rng.integers(-200, 60, (900, 3))
    return cloud(xyz, rng.random((900, 3))), 64, 1.0


def case_scaled(rng):
    """scaling_factor 2: odd coordinates halve to .5, which rounds to even."""
    xyz = rng.integers(-41, 160, (800, 3)).astype(np.float64)
    xyz[::4] += 0.5
    return cloud(xyz, rng.random((800, 3))), 32, 2.0


def case_half_colors(rng):
    """Colors on k + 0.5 over 255 and outside [0, 1]."""
    xyz = rng.integers(0, 64, (1000, 3))
    levels = np.concatenate([np.arange(256) + 0.5, np.arange(256) - 0.5,
                             [-3.0, 300.0]]) / 255.0
    return cloud(xyz, rng.choice(levels, (1000, 3))), 64, 1.0


def case_one_point(rng):
    return cloud([[5, -7, 300]], [[0.25, 0.5, 1.0]]), 64, 1.0


def case_wide(rng):
    """More than 2047 blocks along x: the blocks' dense rank keys them."""
    xyz = rng.integers(0, 8, (600, 3))
    xyz[:, 0] += rng.integers(0, 2100, 600) * 16
    return cloud(xyz, rng.random((600, 3))), 16, 1.0


CASES = {"duplicates": case_duplicates, "groups": case_groups,
         "negative": case_negative, "scaled": case_scaled,
         "half_colors": case_half_colors, "one_point": case_one_point,
         "wide": case_wide}


@pytest.fixture(scope="module")
def cpu_codec():
    return make_codec("cpu")


@pytest.fixture
def limits(monkeypatch):
    """Group limits small enough for several groups: 4 blocks, and the
    points of the first two blocks of ``case_groups`` (40 + 47)."""
    monkeypatch.setattr(codec_mod, "MAX_GROUP", 4)
    monkeypatch.setattr(codec_mod, "ENC_GROUP_PTS", 87)


@pytest.mark.parametrize("device", ["cpu", "cuda"])
@pytest.mark.parametrize("case", sorted(CASES))
def test_device_voxel_set_equals_the_host_path(case, device, cpu_codec,
                                               limits):
    if device == "cuda" and not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    codec = cpu_codec if device == "cpu" else make_codec(device)
    pc, block, sf = CASES[case](np.random.default_rng(len(case)))
    want = host_groups(pc, block, sf)
    groups, levels = codec._partition_blocks(pc, block, sf)
    assert levels == max(1, int(np.ceil(np.log2(max(block // 8, 2)))))
    assert len(groups) == len(want)
    for grp, (origins, keys, feats, cap) in zip(groups, want):
        assert grp.origins == origins and grp.cap == cap
        x, keys_host = codec._voxelize_group(grp)
        assert x.keys.device.type == x.feats.device.type == device
        np.testing.assert_array_equal(keys_host, keys)
        np.testing.assert_array_equal(x.keys.cpu().numpy(), keys)
        got = x.feats.cpu().numpy()
        assert got.dtype == np.float32 and got.shape == (cap, 3)
        np.testing.assert_array_equal(got.view(np.uint32),
                                      feats.view(np.uint32))
    if case == "groups":
        sizes = [g.keys.shape[0] for g in groups]
        assert len(groups) > 3 and sizes[0] == codec_mod.ENC_GROUP_PTS
    if case == "duplicates":
        assert len(keys_host[keys_host != C.SENTINEL]) < len(pc)
    if case == "wide":
        assert max(o[0] for o in groups[-1].origins) // block >= 2048


@pytest.fixture(scope="module")
def frame():
    """A small frame of several blocks at block 16, with repeated
    points."""
    rng = np.random.default_rng(21)
    parts = []
    for off in (0, 40, 96):
        xyz, rgb = surface_cloud(rng, extent=32, n_target=500)
        parts.append(cloud(xyz + np.array([[off, off // 2, 0]]), rgb))
    pc = np.concatenate(parts)
    return np.concatenate([pc, pc[::5]])


@pytest.mark.parametrize("devices", [None, ["cpu", "cpu:0"]],
                         ids=["one device", "two devices"])
def test_containers_equal_the_host_paths(frame, devices, monkeypatch):
    """compress and compress_multi write the containers of the host
    partition and voxelization, byte for byte, on one device and with
    groups moved to a second."""
    monkeypatch.setattr(codec_mod, "MAX_GROUP", 5)
    model = make_model()
    host = make_codec("cpu", HostPathCodec, model)
    dev = make_codec("cpu", model=model, devices=devices)
    assert len(dev._partition_blocks(frame, 16, 1.0)[0]) > 2
    for geom in ("topk", "coded"):
        assert dev.compress(frame, Q, block_size=16, geom=geom) == \
            host.compress(frame, Q, block_size=16, geom=geom)
    assert [bytes(b) for b in dev.compress_multi(frame, QS, block_size=16)] \
        == [bytes(b) for b in host.compress_multi(frame, QS, block_size=16)]


@pytest.mark.parametrize("case", ["duplicates", "one_point"])
def test_group_moves_to_another_device_in_one_copy(case, cpu_codec):
    pc, block, sf = CASES[case](np.random.default_rng(3))
    grp = cpu_codec._partition_blocks(pc, block, sf)[0][0]
    keys, rgb = codec_mod._to_device(grp.keys, grp.rgb,
                                     torch.device("cpu", 0))
    assert keys.dtype == torch.int64 and rgb.dtype == torch.float32
    assert keys.is_contiguous() and rgb.is_contiguous()
    assert torch.equal(keys, grp.keys)
    assert torch.equal(rgb.view(torch.int32), grp.rgb.view(torch.int32))


@pytest.mark.parametrize("entry", ["compress", "compress_multi"])
def test_counters_read_one_upload_and_one_key_copy(entry, cpu_codec, frame,
                                                   monkeypatch):
    """enc.partition.h2d_bytes is the one upload (N x 24 for a float32
    frame), enc.voxelize.d2h_bytes the keys of every group (cap x 8) and
    enc.voxelize.voxels the unique voxels; compress_multi's partition is
    its own stage."""
    monkeypatch.setattr(codec_mod, "MAX_GROUP", 5)
    want = host_groups(frame, 16, 1.0)
    with P.recording() as rec:
        if entry == "compress":
            cpu_codec.compress(frame, Q, block_size=16)
        else:
            cpu_codec.compress_multi(frame, QS, block_size=16)
    (counts,) = rec.counts.values()
    assert counts["enc.partition.h2d_bytes"] == frame.shape[0] * 24
    assert counts["enc.voxelize.d2h_bytes"] == \
        sum(cap * 8 for *_, cap in want)
    n_vox = len(np.unique(frame[:, :3].astype(np.int64), axis=0))
    assert counts["enc.voxelize.voxels"] == n_vox
    names = [s.name for s in rec.spans]
    assert names.count("enc.partition") == 1
    assert names.count("enc.voxelize") == len(want) > 1
