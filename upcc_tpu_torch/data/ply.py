"""Minimal PLY point-cloud I/O (ascii + binary_little_endian).

Always writes float xyz + uchar rgb headers that MPEG tools accept, so no
header rewriting is needed afterwards.
"""

import numpy as np

_DTYPES = {
    "char": "i1", "int8": "i1", "uchar": "u1", "uint8": "u1",
    "short": "i2", "int16": "i2", "ushort": "u2", "uint16": "u2",
    "int": "i4", "int32": "i4", "uint": "u4", "uint32": "u4",
    "float": "f4", "float32": "f4", "double": "f8", "float64": "f8",
}


def read_ply(path):
    """Returns (xyz float64 [N,3], rgb float32 [N,3] in [0,1] or None)."""
    with open(path, "rb") as f:
        line = f.readline().strip()
        assert line == b"ply", f"not a ply file: {path}"
        fmt = None
        n_vertex = 0
        props = []  # (name, dtype) for the vertex element
        in_vertex = False
        while True:
            line = f.readline()
            if not line:
                raise ValueError("unexpected EOF in header")
            parts = line.strip().decode("ascii", "replace").split()
            if not parts:
                continue
            if parts[0] == "format":
                fmt = parts[1]
            elif parts[0] == "element":
                in_vertex = parts[1] == "vertex"
                if in_vertex:
                    n_vertex = int(parts[2])
            elif parts[0] == "property" and in_vertex:
                if parts[1] == "list":
                    raise ValueError("list property in vertex element")
                props.append((parts[2], _DTYPES[parts[1]]))
            elif parts[0] == "end_header":
                break

        names = [p[0] for p in props]
        if fmt == "ascii":
            data = np.loadtxt(f, dtype=np.float64, max_rows=n_vertex, ndmin=2)
            cols = {n: data[:, i] for i, (n, _) in enumerate(props)}
        elif fmt == "binary_little_endian":
            dt = np.dtype([(n, "<" + d) for n, d in props])
            raw = np.frombuffer(f.read(dt.itemsize * n_vertex), dtype=dt,
                                count=n_vertex)
            cols = {n: raw[n].astype(np.float64) for n in names}
        else:
            raise ValueError(f"unsupported ply format {fmt}")

    xyz = np.stack([cols["x"], cols["y"], cols["z"]], axis=1)
    rgb = None
    if all(c in cols for c in ("red", "green", "blue")):
        rgb = np.stack([cols["red"], cols["green"], cols["blue"]], axis=1)
        rgb = (rgb / 255.0).astype(np.float32)
    return xyz, rgb


def write_ply(path, xyz, rgb=None, ascii=False):
    """xyz: [N,3] (float or int); rgb: [N,3] floats in [0,1] or uint8."""
    xyz = np.asarray(xyz, np.float32)
    n = xyz.shape[0]
    has_rgb = rgb is not None
    if has_rgb:
        rgb = np.asarray(rgb)
        if rgb.dtype != np.uint8:
            rgb = np.clip(np.round(rgb * 255.0), 0, 255).astype(np.uint8)
    header = ["ply",
              "format ascii 1.0" if ascii else "format binary_little_endian 1.0",
              f"element vertex {n}",
              "property float x", "property float y", "property float z"]
    if has_rgb:
        header += ["property uchar red", "property uchar green",
                   "property uchar blue"]
    header.append("end_header")
    with open(path, "wb") as f:
        f.write(("\n".join(header) + "\n").encode("ascii"))
        if ascii:
            for i in range(n):
                row = f"{xyz[i,0]:g} {xyz[i,1]:g} {xyz[i,2]:g}"
                if has_rgb:
                    row += f" {rgb[i,0]} {rgb[i,1]} {rgb[i,2]}"
                f.write((row + "\n").encode("ascii"))
        else:
            fields = [("x", "<f4"), ("y", "<f4"), ("z", "<f4")]
            if has_rgb:
                fields += [("red", "u1"), ("green", "u1"), ("blue", "u1")]
            rec = np.empty(n, dtype=np.dtype(fields))
            rec["x"], rec["y"], rec["z"] = xyz[:, 0], xyz[:, 1], xyz[:, 2]
            if has_rgb:
                rec["red"], rec["green"], rec["blue"] = rgb[:, 0], rgb[:, 1], rgb[:, 2]
            f.write(rec.tobytes())
