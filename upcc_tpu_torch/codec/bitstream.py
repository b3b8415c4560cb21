"""Multi-block bitstream container, version 6 — the same byte layout the
JAX package writes and reads.

Per block: origin, octree levels, n_y, n_z, q, a flags byte, the stream
lengths and the per-level point counts k, then the coordinate, y and z
payloads.  Flag bits mark optional side information (coded occupancy and
its tables, the color affine, the color residual layer); unknown flag bits
are rejected, so a stream from a newer build fails loudly instead of
misparsing.
"""

import struct

import numpy as np

MAGIC = b"UPCC"
VERSION = 6
FLAG_CODED_OCC = 1
FLAG_OCC_TABLES = 2
FLAG_COLOR_AFFINE = 4
FLAG_COLOR_RESID = 8
KNOWN_FLAGS = (FLAG_CODED_OCC | FLAG_OCC_TABLES | FLAG_COLOR_AFFINE
               | FLAG_COLOR_RESID)
_HDR = "<iiiBIIffB"


def write_container(path_or_none, blocks, scaling_factor=1.0):
    """blocks: dicts with origin (3 ints), levels, n_y, n_z, q (2 floats),
    k (3 ints), coord_bytes, y_bytes, z_bytes and optionally occ_bytes
    (three streams), occ_tables (uint16 [3, n_bins]), color_affine
    ([3, 4] f32) and color_resid (bytes).  Returns bytes if path is None."""
    out = bytearray()
    out += MAGIC
    out += struct.pack("<BfI", VERSION, scaling_factor, len(blocks))
    for b in blocks:
        occ = b.get("occ_bytes")
        tab = b.get("occ_tables") if occ else None
        aff = b.get("color_affine")
        resid = b.get("color_resid")
        flags = (FLAG_CODED_OCC if occ else 0) \
            | (FLAG_OCC_TABLES if tab is not None else 0) \
            | (FLAG_COLOR_AFFINE if aff is not None else 0) \
            | (FLAG_COLOR_RESID if resid is not None else 0)
        out += struct.pack(_HDR, *b["origin"], b["levels"], b["n_y"],
                           b["n_z"], float(b["q"][0]), float(b["q"][1]),
                           flags)
        out += struct.pack("<III", len(b["coord_bytes"]), len(b["y_bytes"]),
                           len(b["z_bytes"]))
        out += struct.pack("<iii", *[int(v) for v in b["k"]])
        if occ:
            assert len(occ) == 3
            out += struct.pack("<III", *[len(s) for s in occ])
            if tab is not None:
                tab = np.ascontiguousarray(tab, np.uint16)
                assert tab.shape[0] == 3
                out += struct.pack("<B", tab.shape[1])
                out += tab.tobytes()
        if aff is not None:
            aff = np.ascontiguousarray(aff, np.float32)
            assert aff.shape == (3, 4), aff.shape
            out += aff.tobytes()
        if resid is not None:
            out += struct.pack("<I", len(resid))
            out += bytes(resid)
        out += b["coord_bytes"]
        out += b["y_bytes"]
        out += b["z_bytes"]
        if occ:
            for s in occ:
                out += s
    data = bytes(out)
    if path_or_none:
        with open(path_or_none, "wb") as f:
            f.write(data)
        return None
    return data


def read_container(path_or_bytes):
    """Returns (blocks, scaling_factor)."""
    if isinstance(path_or_bytes, (bytes, bytearray)):
        data = bytes(path_or_bytes)
    else:
        with open(path_or_bytes, "rb") as f:
            data = f.read()
    if len(data) < 4 + struct.calcsize("<BfI"):
        raise ValueError("truncated bitstream: container header incomplete")
    if data[:4] != MAGIC:
        raise ValueError("bad magic: not a UPCC bitstream")
    ver, scaling_factor, n_blocks = struct.unpack_from("<BfI", data, 4)
    if ver != VERSION:
        raise ValueError(f"unsupported bitstream version {ver} "
                         f"(expected {VERSION})")
    pos = 4 + struct.calcsize("<BfI")
    blocks = []
    hdr_size = struct.calcsize(_HDR) + struct.calcsize("<III") \
        + struct.calcsize("<iii")
    for _ in range(n_blocks):
        if pos + hdr_size > len(data):
            raise ValueError("truncated bitstream: block header incomplete")
        ox, oy, oz, levels, n_y, n_z, qg, qa, flags = struct.unpack_from(
            _HDR, data, pos)
        pos += struct.calcsize(_HDR)
        if flags & ~KNOWN_FLAGS:
            raise ValueError(
                f"unknown container flag bits 0x{flags & ~KNOWN_FLAGS:02x}: "
                "this stream carries side information a newer build wrote")
        lc, ly, lz = struct.unpack_from("<III", data, pos)
        pos += struct.calcsize("<III")
        k = struct.unpack_from("<iii", data, pos)
        pos += struct.calcsize("<iii")
        occ_lens, occ_tables = None, None
        if flags & FLAG_CODED_OCC:
            if pos + struct.calcsize("<III") > len(data):
                raise ValueError("truncated bitstream: occ header incomplete")
            occ_lens = struct.unpack_from("<III", data, pos)
            pos += struct.calcsize("<III")
            if flags & FLAG_OCC_TABLES:
                if pos + 1 > len(data):
                    raise ValueError(
                        "truncated bitstream: occ table header incomplete")
                (nb,) = struct.unpack_from("<B", data, pos)
                pos += 1
                end = pos + 3 * nb * 2
                if end > len(data):
                    raise ValueError(
                        "truncated bitstream: occ tables incomplete")
                occ_tables = np.frombuffer(
                    data[pos:end], np.uint16).reshape(3, nb).copy()
                pos = end
        color_affine = None
        if flags & FLAG_COLOR_AFFINE:
            end = pos + 12 * 4
            if end > len(data):
                raise ValueError(
                    "truncated bitstream: color affine incomplete")
            color_affine = np.frombuffer(
                data[pos:end], np.float32).reshape(3, 4).copy()
            pos = end
        color_resid = None
        if flags & FLAG_COLOR_RESID:
            if pos + 4 > len(data):
                raise ValueError(
                    "truncated bitstream: color residual header incomplete")
            (lr,) = struct.unpack_from("<I", data, pos)
            pos += 4
            if pos + lr > len(data):
                raise ValueError(
                    "truncated bitstream: color residual incomplete")
            color_resid = data[pos:pos + lr]
            pos += lr
        if pos + lc + ly + lz + sum(occ_lens or ()) > len(data):
            raise ValueError("truncated bitstream: payload exceeds container")
        coord_bytes = data[pos:pos + lc]
        pos += lc
        y_bytes = data[pos:pos + ly]
        pos += ly
        z_bytes = data[pos:pos + lz]
        pos += lz
        occ_bytes = None
        if occ_lens is not None:
            occ_bytes = []
            for L in occ_lens:
                occ_bytes.append(data[pos:pos + L])
                pos += L
            occ_bytes = tuple(occ_bytes)
        blocks.append({"origin": (ox, oy, oz), "levels": levels, "n_y": n_y,
                       "n_z": n_z, "q": (qg, qa), "k": list(k),
                       "coord_bytes": coord_bytes, "y_bytes": y_bytes,
                       "z_bytes": z_bytes, "occ_bytes": occ_bytes,
                       "occ_tables": occ_tables,
                       "color_affine": color_affine,
                       "color_resid": color_resid})
    return blocks, scaling_factor
