"""The benchmark's frozen copies give what the port's originals give: the
synthetic frames byte for byte at two seeds, the cube slicing, the
collation and the augmentations."""

import numpy as np
import pytest

from benchmark.reference.plain.data import dataset as fd
from benchmark.reference.plain.data import synthetic as fs
from benchmark.reference.plain.data import transform as ft
from upcc_tpu_torch.data import dataset as pd
from upcc_tpu_torch.data import synthetic as ps
from upcc_tpu_torch.data import transform as pt


def _same(a, b):
    assert len(a) == len(b)
    for x, y in zip(a, b):
        assert x.dtype == y.dtype and x.tobytes() == y.tobytes()


@pytest.mark.parametrize("seed", [3, 2 ** 31 + 11])
def test_surface_cloud(seed):
    _same(fs.surface_cloud(np.random.default_rng((seed, 0)), extent=256,
                           n_target=5000),
          ps.surface_cloud(np.random.default_rng((seed, 0)), extent=256,
                           n_target=5000))


@pytest.mark.parametrize("seed", [0, 2 ** 31 + 11])
def test_scan_like_cloud(seed):
    _same(fs.scan_like_cloud(np.random.default_rng(seed), extent=256,
                             n_target=8000),
          ps.scan_like_cloud(np.random.default_rng(seed), extent=256,
                             n_target=8000))


def test_cubes_collate_and_augment():
    xyz, rgb = ps.scan_like_cloud(np.random.default_rng(1), extent=256,
                                  n_target=8000)
    a, b = fd.slice_into_cubes(xyz, rgb, 64), pd.slice_into_cubes(xyz, rgb,
                                                                   64)
    assert len(a) == len(b)
    for x, y in zip(a, b):
        _same(x, y)
    cfg = {"1_ColorJitter": {"key": "ColorJitter"},
           "2_Rotate": {"key": "RandomRotate", "block_size": 64}}
    ta, tb = ft.build_transforms(cfg), pt.build_transforms(cfg)
    items_a, items_b = [], []
    for (x, c) in a[:6]:
        for t in ta:
            x, c = t(x, c)
        items_a.append((x, c))
    for (x, c) in b[:6]:
        for t in tb:
            x, c = t(x, c)
        items_b.append((x, c))
    for x, y in zip(items_a, items_b):
        _same(x, y)
    _same(fd.collate_cubes(items_a, 4096, np.random.default_rng(2)),
          pd.collate_cubes(items_b, 4096, np.random.default_rng(2)))
