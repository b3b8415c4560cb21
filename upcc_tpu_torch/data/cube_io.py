"""PLY-per-cube slicing, writing and reading (the JAX package's
``data/cube_io.py``): a frame sliced into cubes stored as one PLY file
each plus a ``side_info.yaml`` manifest, for data-preparation tooling (the
training and evaluation paths read the split caches of ``dataset.py``).

The manifest is written and read here without the yaml package (a GPU
host may have none): the writer emits what ``yaml.safe_dump`` writes for
this one layout, byte for byte, and the reader parses that layout.
"""

import os

import numpy as np

from .dataset import slice_into_cubes
from .ply import read_ply, write_ply

SIDE_INFO = "side_info.yaml"


def dump_side_info(side_info):
    """``yaml.safe_dump`` of {"cube_size": int, "cubes": [{"file": str,
    "origin": [int] * 3, "num_points": int}]} (keys sorted, block
    style)."""
    lines = [f"cube_size: {int(side_info['cube_size'])}"]
    cubes = side_info["cubes"]
    if not cubes:
        lines.append("cubes: []")
    else:
        lines.append("cubes:")
        for c in cubes:
            lines.append(f"- file: {c['file']}")
            lines.append(f"  num_points: {int(c['num_points'])}")
            lines.append("  origin:")
            lines += [f"  - {int(v)}" for v in c["origin"]]
    return "\n".join(lines) + "\n"


def parse_side_info(text):
    """The manifest ``dump_side_info`` (or ``yaml.safe_dump``) writes."""
    out = {"cubes": []}
    cube = None
    for raw in text.splitlines():
        line = raw.rstrip()
        if not line:
            continue
        if line.startswith("cube_size:"):
            out["cube_size"] = int(line.split(":", 1)[1])
        elif line.startswith("cubes:"):
            if line.split(":", 1)[1].strip() not in ("", "[]"):
                raise ValueError(f"side_info: unexpected line {raw!r}")
        elif line.startswith("- file:"):
            cube = {"file": line.split(":", 1)[1].strip(), "origin": []}
            out["cubes"].append(cube)
        elif cube is not None and line.startswith("  num_points:"):
            cube["num_points"] = int(line.split(":", 1)[1])
        elif cube is not None and line == "  origin:":
            continue
        elif cube is not None and line.startswith("  - "):
            cube["origin"].append(int(line[4:]))
        else:
            raise ValueError(f"side_info: unexpected line {raw!r}")
    if "cube_size" not in out:
        raise ValueError("side_info: no cube_size")
    return out


class CubeHandler:
    def __init__(self, cube_size=128):
        self.cube_size = cube_size

    def slice(self, xyz, rgb):
        """Frame -> [{"origin": [x, y, z], "xyz": local int32, "rgb"}], in
        lexicographic cube order."""
        idx = np.floor(np.asarray(xyz) / self.cube_size).astype(np.int64)
        origins = sorted({tuple(i) for i in idx.tolist()})
        return [{"origin": [int(v) * self.cube_size for v in o],
                 "xyz": local, "rgb": colors}
                for (local, colors), o in zip(
                    slice_into_cubes(xyz, rgb, self.cube_size), origins)]

    def write(self, cubes, directory, min_points=0):
        """Write cube_{i:05d}.ply files (cubes of at least ``min_points``)
        and side_info.yaml; returns the number written."""
        os.makedirs(directory, exist_ok=True)
        side_info = {"cube_size": self.cube_size, "cubes": []}
        for c in cubes:
            if len(c["xyz"]) < min_points:
                continue
            name = f"cube_{len(side_info['cubes']):05d}.ply"
            write_ply(os.path.join(directory, name), c["xyz"], c["rgb"])
            side_info["cubes"].append({
                "file": name, "origin": [int(v) for v in c["origin"]],
                "num_points": int(len(c["xyz"]))})
        with open(os.path.join(directory, SIDE_INFO), "w") as f:
            f.write(dump_side_info(side_info))
        return len(side_info["cubes"])

    def read(self, directory):
        """side_info.yaml + cube PLYs -> the reassembled frame [N, 6]."""
        with open(os.path.join(directory, SIDE_INFO)) as f:
            side_info = parse_side_info(f.read())
        parts = []
        for c in side_info["cubes"]:
            xyz, rgb = read_ply(os.path.join(directory, c["file"]))
            if rgb is None:
                rgb = np.zeros((len(xyz), 3), np.float32)
            xyz = xyz + np.asarray(c["origin"], np.float64)
            parts.append(np.concatenate([xyz.astype(np.float32), rgb], 1))
        return np.concatenate(parts) if parts \
            else np.zeros((0, 6), np.float32)
