"""Dataset: cube slicing, split caches, batching (numpy, as the JAX
package's ``data/dataset.py``).

``StaticDataset`` reads a split cache (``<split>.npz``: concatenated
points, colors and offsets) from a dataset directory; the train split
iterates cubes (with a ``min_points`` filter), val/test whole frames.
Where the cache is missing it is built from raw PLY frames through
``RawLoader``, which needs the directory's ``config.yaml`` (and the yaml
package for a YAML file; ``make_synth`` writes JSON, which is YAML too).
``collate_cubes`` pads variable-size cubes into one fixed-capacity flat
batch with batch indices.
"""

import json
import os

import numpy as np

from .ply import read_ply


def read_config(path):
    """A dataset or loading config: JSON where the file is JSON (what
    ``make_synth`` writes), else YAML through the yaml package."""
    with open(path) as f:
        text = f.read()
    try:
        return json.loads(text)
    except ValueError:
        import yaml
        return yaml.safe_load(text)


def parse_frame_spec(spec):
    """Frame-range DSL: int, "start:stop[:step]", or a list of those."""
    if isinstance(spec, int):
        return [spec]
    if isinstance(spec, (list, tuple)):
        out = []
        for s in spec:
            out.extend(parse_frame_spec(s))
        return out
    if isinstance(spec, str):
        parts = spec.split(":")
        if len(parts) == 1:
            return [int(parts[0])]
        start, stop = int(parts[0]), int(parts[1])
        step = int(parts[2]) if len(parts) > 2 else 1
        return list(range(start, stop + 1, step))
    raise ValueError(f"bad frame spec {spec!r}")


class RawLoader:
    """(sequence, frameIdx) -> (xyz float64 [N, 3], rgb f32 [N, 3])."""

    def __init__(self, loading_config):
        if isinstance(loading_config, str):
            loading_config = read_config(loading_config)
        self.cfg = loading_config
        self.base = self.cfg.get("base_path", ".")

    def path_for(self, sequence, frame_idx):
        for ds in self.cfg.get("datasets", {}).values():
            if sequence in ds.get("sequences", {}):
                seq = ds["sequences"][sequence]
                return os.path.join(self.base, ds["path_template"].format(
                    sequence=sequence, frame=frame_idx,
                    **{k: v for k, v in seq.items()
                       if not isinstance(v, dict)}))
        raise KeyError(f"sequence {sequence} not in loading config")

    def get_pointcloud(self, sequence, frame_idx):
        xyz, rgb = read_ply(self.path_for(sequence, frame_idx))
        if rgb is None:
            rgb = np.zeros((len(xyz), 3), np.float32)
        return xyz, rgb


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
    np.savez_compressed(
        path,
        points=np.concatenate(pts_list) if pts_list
        else np.zeros((0, 3), np.int32),
        colors=np.concatenate(col_list) if col_list
        else np.zeros((0, 3), np.float32),
        offsets=offsets)
    return offsets


class StaticDataset:
    """Cube (train) or frame (val/test) dataset over a dataset directory
    holding ``<split>.npz`` (and ``config.yaml`` when the cache must be
    built from raw frames)."""

    def __init__(self, data_path, split, loading_config=None, min_points=0,
                 transforms=None, cache_dir=None):
        self.data_path = data_path
        self.split = split
        self.min_points = min_points
        self.transforms = transforms or []
        self.cache_dir = cache_dir or data_path
        self.loader = RawLoader(loading_config) if loading_config else None
        self._load()

    def _cache_path(self):
        return os.path.join(self.cache_dir, f"{self.split}.npz")

    def _load(self):
        path = self._cache_path()
        if not os.path.exists(path):
            self._prepare_split(path)
        with np.load(path) as z:
            self.points = z["points"]
            self.colors = z["colors"]
            self.offsets = z["offsets"]
        counts = np.diff(self.offsets)
        if self.split == "train":
            self.indices = np.where(counts >= self.min_points)[0]
        else:
            self.indices = np.arange(len(counts))

    def _prepare_split(self, path):
        assert self.loader is not None, \
            f"no cache at {path} and no loading config given"
        cfg = read_config(os.path.join(self.data_path, "config.yaml"))
        cube_size = int(cfg.get("cube_size", 128))
        pts_list, col_list = [], []
        for sequence, frames in cfg.get(self.split, {}).items():
            for fidx in parse_frame_spec(frames):
                xyz, rgb = self.loader.get_pointcloud(sequence, fidx)
                if self.split == "train":
                    for cxyz, crgb in slice_into_cubes(xyz, rgb, cube_size):
                        pts_list.append(cxyz)
                        col_list.append(crgb)
                else:
                    pts_list.append(xyz.astype(np.int32))
                    col_list.append(rgb.astype(np.float32))
        write_split(path, pts_list, col_list)

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
