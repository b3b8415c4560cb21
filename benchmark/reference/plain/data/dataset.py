"""Cube slicing, split caches and batching (numpy): a frozen copy of the
port's ``data/dataset.py`` without its raw-PLY loading.  Split caches are
written uncompressed (the port's reader loads either).

``StaticDataset`` reads a split cache (``<split>.npz``: concatenated
points, colors and offsets); the train split iterates cubes (with a
``min_points`` filter).  ``collate_cubes`` pads variable-size cubes into
one fixed-capacity flat batch with batch indices.
"""

import os

import numpy as np


def slice_into_cubes(xyz, rgb, cube_size):
    """Partition a frame into local-coordinate cubes, in lexicographic
    cube order.  Returns [(xyz_local int32, rgb f32)]."""
    xyz = np.asarray(xyz)
    idx = np.floor(xyz / cube_size).astype(np.int64)
    order = np.lexsort((idx[:, 2], idx[:, 1], idx[:, 0]))
    xyz, rgb, idx = xyz[order], rgb[order], idx[order]
    change = np.any(np.diff(idx, axis=0) != 0, axis=1)
    bounds = np.concatenate([[0], np.where(change)[0] + 1, [len(xyz)]])
    cubes = []
    for s, e in zip(bounds[:-1], bounds[1:]):
        local = xyz[s:e] - idx[s] * cube_size
        cubes.append((local.astype(np.int32), rgb[s:e].astype(np.float32)))
    return cubes


def write_split(path, pts_list, col_list):
    """One split cache: concatenated points and colors plus offsets."""
    offsets = np.zeros(len(pts_list) + 1, np.int64)
    offsets[1:] = np.cumsum([len(p) for p in pts_list])
    np.savez(
        path,
        points=np.concatenate(pts_list) if pts_list
        else np.zeros((0, 3), np.int32),
        colors=np.concatenate(col_list) if col_list
        else np.zeros((0, 3), np.float32),
        offsets=offsets)
    return offsets


class StaticDataset:
    """Cube (train) or frame (val/test) dataset over a dataset directory
    holding ``<split>.npz``."""

    def __init__(self, data_path, split, min_points=0, transforms=None):
        self.data_path = data_path
        self.split = split
        self.min_points = min_points
        self.transforms = transforms or []
        with np.load(os.path.join(data_path, f"{split}.npz")) as z:
            self.points = z["points"]
            self.colors = z["colors"]
            self.offsets = z["offsets"]
        counts = np.diff(self.offsets)
        if self.split == "train":
            self.indices = np.where(counts >= self.min_points)[0]
        else:
            self.indices = np.arange(len(counts))

    def __len__(self):
        return len(self.indices)

    def __getitem__(self, i):
        j = self.indices[i]
        s, e = self.offsets[j], self.offsets[j + 1]
        xyz = self.points[s:e].copy()
        rgb = self.colors[s:e].copy()
        for t in self.transforms:
            xyz, rgb = t(xyz, rgb)
        return xyz, rgb


def collate_cubes(items, capacity, rng=None):
    """Pad/stack variable-size cubes into one flat batch (batch int32
    [cap], xyz int32 [cap, 3], rgb f32 [cap, 3]); padding has batch -1.
    Overflowing points are dropped uniformly at random (``rng``, numpy)."""
    bs, xs, cs = [], [], []
    for b, (xyz, rgb) in enumerate(items):
        bs.append(np.full(len(xyz), b, np.int32))
        xs.append(xyz)
        cs.append(rgb)
    b = np.concatenate(bs) if bs else np.zeros(0, np.int32)
    x = np.concatenate(xs) if xs else np.zeros((0, 3), np.int32)
    c = np.concatenate(cs) if cs else np.zeros((0, 3), np.float32)
    n = len(b)
    if n > capacity:
        rng = rng or np.random.default_rng(0)
        sel = rng.choice(n, capacity, replace=False)
        b, x, c = b[sel], x[sel], c[sel]
        n = capacity
    pad = capacity - n
    if pad:
        b = np.concatenate([b, np.full(pad, -1, np.int32)])
        x = np.concatenate([x, np.zeros((pad, 3), np.int32)])
        c = np.concatenate([c, np.zeros((pad, 3), np.float32)])
    return b, x.astype(np.int32), c.astype(np.float32)
