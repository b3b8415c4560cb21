"""The rate side of the codec's reference: the bytes a block's y and z
streams take, worked out from the reference's own symbols, scale indexes
and CDF tables, and the block headers of a container as the port wrote it.

The estimate follows the rANS coder's rule (16-bit frequencies, every bin
at least 1, a tail bin whose symbol is followed by the overflow in 3-bit
chunks at 1/16 each, a 4-byte flush): a stream of ``b`` bits of ideal code
length under those frequencies takes ``b / 8 + 3`` to ``b / 8 + 4`` bytes
and at least 4, so the estimate is ``b / 8 + 3.5``, at least 4, and a gap
within a byte a stream is no gap (the coder's state rounding stays far
inside it: 1.6 bytes over 400,000 symbols).  A port that codes other
symbols, or under other scale indexes than the reference's, writes another
length, even where its coders stay lossless and its decode stays right.
"""

import struct

import numpy as np
import torch
from scipy.stats import norm

from .plain.models.entropy import gaussian

PRECISION = 16
ESCAPE_CHUNK_BITS = 4
FLUSH_BYTES = 3.5
STREAM_SLACK = 1.0  # bytes a stream the estimate may miss by


def quantized_cdf(pmf, tail_mass, precision=PRECISION):
    """A pmf plus its tail bin as an integer CDF summing to 2^precision,
    every bin at least 1, the excess or deficit balanced against the
    largest bins (the coder's rule)."""
    p = np.concatenate([np.asarray(pmf, np.float64),
                        [max(float(tail_mass), 1e-12)]])
    p = np.maximum(p, 1e-12)
    total = 1 << precision
    freq = np.maximum(np.round(p / p.sum() * total).astype(np.int64), 1)
    diff = total - freq.sum()
    while diff != 0:
        if diff > 0:
            freq[int(np.argmax(p / freq))] += diff
            diff = 0
        else:
            for i in np.argsort(-(freq.astype(np.float64))):
                take = min(freq[i] - 1, -diff)
                freq[i] -= take
                diff += take
                if diff == 0:
                    break
            else:
                raise ValueError("cannot normalize pmf")
    cdf = np.zeros(len(freq) + 1, np.int64)
    cdf[1:] = np.cumsum(freq)
    return cdf


def _stack(cdfs, offsets):
    width = max(len(c) for c in cdfs)
    table = np.zeros((len(cdfs), width), np.int64)
    for i, c in enumerate(cdfs):
        table[i, :len(c)] = c
    return {"cdf": table, "length": np.array([len(c) for c in cdfs]),
            "offset": np.asarray(offsets, np.int64)}


def gaussian_tables():
    """One CDF a scale of the Gaussian conditional's table, over a
    symmetric support cut at the tail mass."""
    table = gaussian.default_scale_table()
    tails = np.ceil(table * -norm.ppf(gaussian.TAIL_MASS / 2)
                    ).astype(np.int64)
    cdfs = []
    for s, t in zip(table, tails):
        x = np.arange(-t, t + 1, dtype=np.float64)
        upper, lower = norm.cdf((x + 0.5) / s), norm.cdf((x - 0.5) / s)
        cdfs.append(quantized_cdf(upper - lower,
                                  lower[0] + (1.0 - upper[-1])))
    return _stack(cdfs, -tails)


def bottleneck_tables(bottleneck):
    """One CDF a channel of the factorized bottleneck's learned density,
    over the support its quantiles give, in float32 as the density's
    parameters are."""
    p = {n: t.detach().float().cpu().numpy()
         for n, t in bottleneck.named_parameters()}
    n_layers = len(bottleneck.filters) + 1
    q = p["quantiles"]
    med = q[:, 0, 1]
    lo = np.maximum(np.ceil(med - q[:, 0, 0]).astype(np.int64), 0)
    hi = np.maximum(np.ceil(q[:, 0, 2] - med).astype(np.int64), 0)
    span = int((lo + hi + 1).max())
    samples = np.arange(span, dtype=np.float32)[None, :] - lo[:, None] \
        + med[:, None]

    def logits(x):
        x = x[:, None, :]
        for i in range(n_layers):
            m = np.logaddexp(0, p[f"matrix_{i}"])
            x = np.einsum("coi,cim->com", m, x) + p[f"bias_{i}"]
            if i < n_layers - 1:
                x = x + np.tanh(p[f"factor_{i}"]) * np.tanh(x)
        return x[:, 0, :]

    def sigmoid(v):
        return 1.0 / (1.0 + np.exp(-v))

    upper, lower = logits(samples + 0.5), logits(samples - 0.5)
    sign = -np.sign(upper + lower)
    pmf = np.abs(sigmoid(sign * upper) - sigmoid(sign * lower))
    tail = sigmoid(logits((med - lo - 0.5)[:, None])[:, 0]) \
        + 1.0 - sigmoid(logits((med + hi + 0.5)[:, None])[:, 0])
    cdfs = [quantized_cdf(pmf[c, :lo[c] + hi[c] + 1], tail[c])
            for c in range(len(med))]
    return _stack(cdfs, -lo)


def tables(model, device):
    """The y and z tables of ``model``, on ``device``."""
    out = {"y": gaussian_tables(),
           "z": bottleneck_tables(model.entropy_model.bottleneck)}
    return {k: {n: torch.as_tensor(a, device=device) for n, a in t.items()}
            for k, t in out.items()}


def row_bits(values, indexes, t):
    """[rows] bits of ideal code length of each row of ``values`` (int
    [rows, C]) under the tables ``t`` at ``indexes`` (int [rows, C])."""
    idx = indexes.long()
    length = t["length"][idx]
    max_sym = length - 2
    s = values.long() - t["offset"][idx]
    escape = (s < 0) | (s >= max_sym)
    sc = torch.where(escape, max_sym, s)
    flat = t["cdf"].reshape(-1)
    base = idx * t["cdf"].shape[1] + sc
    freq = (flat[base + 1] - flat[base]).double()
    bits = PRECISION - torch.log2(freq)
    ov = torch.where(s < 0, -2 * s - 1, 2 * (s - max_sym)).clamp(min=1)
    chunks = torch.ceil((torch.floor(torch.log2(ov.double())) + 1) / 3)
    bits = bits + torch.where(escape, ESCAPE_CHUNK_BITS * chunks.clamp(min=1),
                              torch.zeros_like(bits))
    return bits.sum(1)


def stream_bytes(rows, offsets):
    """Bytes of each block's stream: ``rows`` [N] bits a row, block i's
    rows ``offsets[i]:offsets[i + 1]``; a stream of under a byte of code
    is its flush alone."""
    csum = np.concatenate([[0.0], np.cumsum(rows.cpu().numpy())])
    ofs = np.asarray(offsets, np.int64)
    return np.maximum((csum[ofs[1:]] - csum[ofs[:-1]]) / 8.0 + FLUSH_BYTES,
                      4.0)


# -- the container as the port wrote it --------------------------------------

_HEAD = "<4sBfI"
_BLOCK = "<iiiBIIffB"
_FLAG_CODED_OCC, _FLAG_OCC_TABLES = 1, 2
_FLAG_COLOR_AFFINE, _FLAG_COLOR_RESID = 4, 8


def container_blocks(data):
    """Each block's header of a version-6 container: origin, n_y, n_z, k
    and the byte lengths of its y and z streams."""
    magic, version, _scale, n = struct.unpack_from(_HEAD, data, 0)
    if magic != b"UPCC" or version != 6:
        raise ValueError(f"not a version-6 container: {magic!r} {version}")
    pos = struct.calcsize(_HEAD)
    out = []
    for _ in range(n):
        ox, oy, oz, _lv, n_y, n_z, _qg, _qa, flags = struct.unpack_from(
            _BLOCK, data, pos)
        pos += struct.calcsize(_BLOCK)
        lc, ly, lz = struct.unpack_from("<III", data, pos)
        k = struct.unpack_from("<iii", data, pos + 12)
        pos += 24
        occ = 0
        if flags & _FLAG_CODED_OCC:
            occ = sum(struct.unpack_from("<III", data, pos))
            pos += 12
            if flags & _FLAG_OCC_TABLES:
                pos += 1 + 6 * data[pos]
        if flags & _FLAG_COLOR_AFFINE:
            pos += 48
        if flags & _FLAG_COLOR_RESID:
            pos += 4 + struct.unpack_from("<I", data, pos)[0]
        pos += lc + ly + lz + occ
        out.append({"origin": (ox, oy, oz), "n_y": n_y, "n_z": n_z,
                    "k": tuple(k), "y_bytes": float(ly),
                    "z_bytes": float(lz)})
    if pos != len(data):
        raise ValueError(f"container holds {len(data) - pos} bytes more "
                         "than its blocks")
    return out


def block_gaps(side, ref):
    """(fields_differ, rate_gap) of one frame's blocks against the
    reference's: the blocks whose origin, n_y, n_z or k differ (a block of
    one side only counts), and the gap of the y and z bytes summed over the
    frame, beyond the estimate's byte a stream, over the reference's."""
    key = ("origin", "n_y", "n_z", "k")
    differ = abs(len(side) - len(ref)) + sum(
        any(tuple(np.ravel(a[f])) != tuple(np.ravel(b[f])) for f in key)
        for a, b in zip(side, ref))

    def size(blocks):
        return sum(b["y_bytes"] + b["z_bytes"] for b in blocks)

    total = size(ref)
    gap = max(0.0, abs(size(side) - total) - STREAM_SLACK * 2 * len(ref))
    return differ, gap / max(total, 1.0)
