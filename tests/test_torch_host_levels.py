"""The port's host level chain and root maps (``ops/family.py``:
``host_levels``, ``host_self_map``, ``host_root_neighbors``) against the JAX
package's, array for array: the codec's two-batch group, training's
truncating caps, keys on every face of the coordinate range, empty and
one-key input, and unsorted input (sorted once, then the same dedup)."""

import numpy as np
import pytest

import upcc_tpu  # noqa: F401
from upcc_tpu.codec import codec as JC
from upcc_tpu.data.synthetic import surface_cloud
from upcc_tpu.models.unified import host_root_maps as j_roots
from upcc_tpu.ops import family as JF
from upcc_tpu.ops.sparse import voxelize_host_np
from upcc_tpu_torch.codec import codec as TC
from upcc_tpu_torch.models.unified import host_root_maps as t_roots
from upcc_tpu_torch.ops import coords as C
from upcc_tpu_torch.ops import family as TF

TOP = (1 << C.COORD_BITS) - 1
CFG = {"g_a": {}, "entropy_model": {}}


def _same(a, b):
    a, b = np.asarray(a), np.asarray(b)
    assert a.dtype == b.dtype and a.shape == b.shape
    assert np.array_equal(a, b)


def _group():
    """A 2-block voxelized group with the codec's host-side structure."""
    rng = np.random.default_rng(5)
    xyz1, rgb1 = surface_cloud(rng, extent=64, n_target=900)
    xyz2, rgb2 = surface_cloud(rng, extent=64, n_target=700)
    batch = np.concatenate([np.zeros(len(xyz1), np.int32),
                            np.ones(len(xyz2), np.int32)])
    keys, _ = voxelize_host_np(batch, np.concatenate([xyz1, xyz2]),
                               np.concatenate([rgb1, rgb2]),
                               JC._bucket(len(batch)))
    return keys


def _scattered():
    """Points scattered over a wide extent: every level nearly as large as
    the one below it, so training's fractional caps cut each level."""
    rng = np.random.default_rng(11)
    xyz = rng.integers(0, 4096, (16000, 3))
    keys, _ = voxelize_host_np(np.zeros(len(xyz), np.int32), xyz,
                               np.zeros((len(xyz), 3), np.float32), 16384)
    return keys


def _faces():
    """Keys at coordinate 0, 1, TOP - 1 and TOP on every axis, in batches 0
    and 1, so that batch 0's last key sits next to batch 1's first."""
    v = np.array([0, 1, TOP - 1, TOP])
    units = np.stack(np.meshgrid(v, v, v, indexing="ij"), -1).reshape(-1, 3)
    keys = np.concatenate([C.morton_encode_np(units) | (np.int64(b)
                                                       << C.BATCH_SHIFT)
                           for b in (0, 1)])
    out = np.full(256, C.SENTINEL, np.int64)
    out[:len(keys)] = np.sort(keys)
    return out


def _one():
    out = np.full(8, C.SENTINEL, np.int64)
    out[0] = C.morton_encode_np(np.array([3, TOP, 0])) | (np.int64(2)
                                                          << C.BATCH_SHIFT)
    return out


def _shuffled(keys):
    """The keys, SENTINEL padding included, in a random order."""
    return keys[np.random.default_rng(3).permutation(len(keys))]


# case: (keys, [(levels_down, cap, level_caps) of each root map])
CASES = {
    "group": lambda: (_group(), [(4, 128, [1024, 512, 256, 128]),
                                 (2, 64, None)]),
    "train_caps": lambda: (_scattered(), ["train", (3, 4096,
                                                    [8192, 6000, 4096])]),
    "faces": lambda: (_faces(), [(0, 256, None), (1, 256, None),
                                 (2, 16, [64, 16])]),
    "empty": lambda: (np.full(8, C.SENTINEL, np.int64),
                      [(0, 8, None), (3, 8, None)]),
    "empty_array": lambda: (np.zeros(0, np.int64), [(2, 4, None)]),
    "one_key": lambda: (_one(), [(0, 8, None), (4, 8, None)]),
    "unsorted": lambda: (_shuffled(_group()),
                         [(4, 128, [1024, 512, 256, 128]), (2, 64, None),
                          (0, 4096, None)]),
    "unsorted_train_caps": lambda: (_shuffled(_scattered()),
                                    ["train", (3, 4096, [8192, 6000, 4096])]),
    "faces_reversed": lambda: (_faces()[::-1].copy(),
                               [(0, 256, None), (2, 16, [64, 16])]),
}


@pytest.mark.parametrize("case", list(CASES))
def test_host_levels_and_root_maps_match_jax(case):
    keys, calls = CASES[case]()
    for a, b in zip(TC._host_downsample_levels(keys, 5),
                    JC._host_downsample_levels(keys, 5), strict=True):
        _same(a, b)
    for args in calls:
        if args == "train":
            t, j = t_roots(keys, CFG), j_roots(keys, CFG)
            for name in ("ga", "z"):
                for a, b in zip(t[name], j[name]):
                    _same(a.numpy(), b)
            continue
        for a, b in zip(TF.host_root_neighbors(keys, *args),
                        JF.host_root_neighbors(keys, *args), strict=True):
            _same(a, b)
    # the codec's roots come from the chain it already holds
    lvl = TC._host_downsample_levels(keys, 5)
    for down in (4, 5):
        caps = [JC._bucket(len(k)) for k in lvl[:down]]
        for a, b in zip(TF.host_self_map(lvl[down - 1], caps[-1]),
                        JF.host_root_neighbors(keys, down, caps[-1], caps),
                        strict=True):
            _same(a, b)

