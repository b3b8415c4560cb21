"""Build a cached synthetic dataset directory (config.yaml + split .npz).

Frames come from ``scan_like_cloud`` (human-scan-like shells with
textured colors), frame i from ``default_rng(seed0 + i)`` over train, val
and test in that order; the caches have the layout ``StaticDataset``
reads, and equal the JAX package's ``make_synth`` caches for the same
arguments.  The config is written as JSON (valid YAML), so building needs
no yaml package.

Usage:
  python -m upcc_tpu_torch.data.make_synth --out data/datasets/synth_128 \
      --train_frames 16 --val_frames 2 --test_frames 2
"""

import argparse
import json
import os

import numpy as np

from .dataset import slice_into_cubes, write_split
from .synthetic import scan_like_cloud


def build(out, train_frames=16, val_frames=2, test_frames=2, extent=1024,
          points=760_000, cube_size=128, seed0=0, verbose=True):
    os.makedirs(out, exist_ok=True)
    name = os.path.basename(os.path.normpath(out))
    spec = {
        "name": name, "cube_size": cube_size, "synthetic": True,
        "generator": {"extent": extent, "points": points, "seed0": seed0},
        "train": {"synth": f"0:{train_frames - 1}"},
        "val": {"synth": f"{train_frames}:{train_frames + val_frames - 1}"},
        "test": {"synth": f"{train_frames + val_frames}:"
                          f"{train_frames + val_frames + test_frames - 1}"},
    }
    with open(os.path.join(out, "config.yaml"), "w") as f:
        json.dump(spec, f, indent=1)

    seed = seed0
    for split, n_frames, sliced in [("train", train_frames, True),
                                    ("val", val_frames, False),
                                    ("test", test_frames, False)]:
        pts_list, col_list = [], []
        for _ in range(n_frames):
            rng = np.random.default_rng(seed)
            seed += 1
            xyz, rgb = scan_like_cloud(rng, extent=extent, n_target=points)
            if sliced:
                for cxyz, crgb in slice_into_cubes(xyz, rgb, cube_size):
                    pts_list.append(cxyz)
                    col_list.append(crgb)
            else:
                pts_list.append(xyz.astype(np.int32))
                col_list.append(rgb.astype(np.float32))
        offsets = write_split(os.path.join(out, f"{split}.npz"), pts_list,
                              col_list)
        if verbose and len(offsets) > 1:
            sizes = np.diff(offsets)
            print(f"{split}: {n_frames} frames -> {len(sizes)} items, "
                  f"median {int(np.median(sizes))} pts, max {sizes.max()}",
                  flush=True)


if __name__ == "__main__":
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", required=True)
    ap.add_argument("--train_frames", type=int, default=16)
    ap.add_argument("--val_frames", type=int, default=2)
    ap.add_argument("--test_frames", type=int, default=2)
    ap.add_argument("--extent", type=int, default=1024)
    ap.add_argument("--points", type=int, default=760_000)
    ap.add_argument("--cube_size", type=int, default=128)
    ap.add_argument("--seed0", type=int, default=0)
    a = ap.parse_args()
    build(a.out, a.train_frames, a.val_frames, a.test_frames, a.extent,
          a.points, a.cube_size, a.seed0)
