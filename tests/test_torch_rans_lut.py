"""The table decoder (``coding/csrc/rans_lut.cpp``) against ``rans.cpp``'s
decoder and the Python twin on the same arrays: the flagship y table (64
Gaussian rows, 5 to 3,133 entries) with every row indexed, a factorized z
table, escapes on both sides, random and truncated bytes and a stream whose
escape runs past any int32 (code -2); and its count of the symbols one
table entry resolved."""

import numpy as np
import pytest
import torch

from upcc_tpu_torch.coding import rans
from upcc_tpu_torch.models.entropy import gaussian as G
from upcc_tpu_torch.models.entropy.bottleneck import (FactorizedBottleneck,
                                                      build_cdf_tables)
from upcc_tpu_torch.utils import profiling

torch.set_num_threads(2)

Z_CHANNELS = 192  # the flagship's hyper channels: 32 buckets a row


def _y_table():
    t = G.build_cdf_tables()
    assert len(t["cdf_length"]) == 64
    assert t["cdf_length"].min() == 5 and t["cdf_length"].max() == 3133
    return t


def _z_table():
    """A factorized table of Z_CHANNELS learned-looking rows: the fresh
    density with each channel's quantiles stretched by its own factor, so
    the rows run from a few entries to a few hundred."""
    torch.manual_seed(0)
    bn = FactorizedBottleneck(Z_CHANNELS)
    params = bn.numpy_params()
    stretch = np.geomspace(0.05, 25, Z_CHANNELS, dtype=np.float32)
    params["quantiles"] = params["quantiles"] * stretch[:, None, None]
    return build_cdf_tables(params, Z_CHANNELS)


TABLES = {"y": _y_table, "z": _z_table}


@pytest.fixture(scope="module", params=sorted(TABLES))
def table(request):
    t = TABLES[request.param]()
    assert rans._load() and rans._load_lut(), "a native rANS coder did not build"
    return t


def _args(t):
    return t["cdf"], t["cdf_length"], t["offset"]


def _symbols(seed, n, t):
    """Values over every row (the first rows in order), clustered near
    each row's centre, 5% escapes on both sides, some far out."""
    rng = np.random.default_rng(seed)
    ncdf = len(t["cdf_length"])
    idx = rng.integers(0, ncdf, n).astype(np.int32)
    idx[:min(n, ncdf)] = np.arange(min(n, ncdf))
    half = t["cdf_length"][idx] // 2
    centre = t["offset"][idx] + (t["cdf_length"][idx] - 2) // 2
    vals = np.round(centre + rng.normal(0, half / 3 + 1)).astype(np.int32)
    esc = rng.random(n) < 0.05
    vals[esc] = rng.integers(-5000, 5000, esc.sum())
    return vals, idx


def _encode_puts(puts):
    """rANS-encode (start, freq) pairs that a decoder reads in order, as
    ``rans._py_encode`` puts them."""
    out = bytearray()
    x = rans._RANS_L
    for start, freq in reversed(puts):
        x_max = ((rans._RANS_L >> rans._PROB_BITS) << 8) * freq
        while x >= x_max:
            out.append(x & 0xFF)
            x >>= 8
        x = ((x // freq) << rans._PROB_BITS) + (x % freq) + start
    for i in range(3, -1, -1):
        out.append((x >> (8 * i)) & 0xFF)
    return bytes(reversed(out))


def _both(data, idx, t):
    """Both native decoders on the same arrays, held equal. -> (code,
    values, direct)."""
    rc, vals = rans.search_decode(data, idx, *_args(t))
    trc, tvals, direct = rans.table_decode(data, idx, *_args(t))
    assert trc == rc
    np.testing.assert_array_equal(tvals, vals)
    assert 0 <= direct <= len(idx)
    return rc, vals, direct


@pytest.mark.parametrize("n", [0, 1, 2000])
def test_table_decoder_matches_search_and_twin(table, n):
    vals, idx = _symbols(n + 1, n, table)
    data = rans.encode_with_indexes(vals, idx, *_args(table))
    rc, got, direct = _both(data, idx, table)
    assert rc == 0
    np.testing.assert_array_equal(got, vals)
    buf = np.frombuffer(data, np.uint8)
    np.testing.assert_array_equal(rans._py_decode(buf, idx, *_args(table)),
                                  vals)
    np.testing.assert_array_equal(
        rans.decode_with_indexes(data, idx, *_args(table)), vals)
    if n == 2000:
        assert 0 < direct < n
        assert set(idx.tolist()) == set(range(len(table["cdf_length"])))


@pytest.mark.parametrize("seed", range(6))
def test_random_bytes_give_the_same_values_and_code(table, seed):
    rng = np.random.default_rng(100 + seed)
    _, idx = _symbols(seed, 3000, table)
    data = rng.integers(0, 256, 64 + 200 * seed).astype(np.uint8).tobytes()
    _both(data, idx, table)


@pytest.mark.parametrize("keep", [0, 1, 3, 4, 5, 0.5])
def test_truncated_streams_give_the_same_values_and_code(table, keep):
    vals, idx = _symbols(7, 2000, table)
    data = rans.encode_with_indexes(vals, idx, *_args(table))
    cut = data[:int(len(data) * keep) if isinstance(keep, float) else keep]
    rc, got, _ = _both(cut, idx, table)
    assert rc in (0, -2)


def test_an_escape_past_any_int32_returns_minus_2_in_both(table):
    """Three symbols, then an escape whose 11 chunks all carry the
    continuation bit: both decoders stop with -2 at the fourth symbol."""
    row = len(table["cdf_length"]) - 1
    cdf = table["cdf"][row]
    esc = int(table["cdf_length"][row]) - 2
    mid = esc // 2
    sym = (int(cdf[mid]), int(cdf[mid + 1] - cdf[mid]))
    puts = [sym] * 3 + [(int(cdf[esc]), int(cdf[esc + 1] - cdf[esc]))]
    puts += [((0x8 | k % 8) << 12, 1 << 12) for k in range(11)]
    data = _encode_puts(puts)
    idx = np.full(10, row, np.int32)
    rc, got, _ = _both(data, idx, table)
    assert rc == -2
    np.testing.assert_array_equal(got[:3], mid + table["offset"][row])
    np.testing.assert_array_equal(got[3:], 0)
    with pytest.raises(RuntimeError, match="rANS decode failed: -2"):
        rans.decode_with_indexes(data, idx, *_args(table))


def test_single_symbol_buckets_resolve_every_symbol_directly():
    """One row of 15 bins of 4096 and the escape bin: every bucket boundary
    of the table is a bin boundary, so each lookup is one entry, escapes
    included."""
    cdf = np.arange(0, (1 << 16) + 1, 4096, dtype=np.int32)[None]
    t = {"cdf": cdf, "cdf_length": np.array([17], np.int32),
         "offset": np.array([-7], np.int32)}
    rng = np.random.default_rng(5)
    vals = rng.integers(-7, 8, 3000).astype(np.int32)
    vals[::97] = rng.integers(-3000, 3000, len(vals[::97]))
    idx = np.zeros(len(vals), np.int32)
    data = rans.encode_with_indexes(vals, idx, *_args(t))
    rc, got, direct = _both(data, idx, t)
    assert rc == 0 and direct == len(vals)
    np.testing.assert_array_equal(got, vals)


def test_direct_is_counted_only_while_recording():
    t = _y_table()
    vals, idx = _symbols(9, 2000, t)
    data = rans.encode_with_indexes(vals, idx, *_args(t))
    _, _, direct = rans.table_decode(data, idx, *_args(t))
    with profiling.recording() as rec:
        rans.decode_with_indexes(data, idx, *_args(t))
    assert rec.total("coder.rans.dec.direct") == direct
    assert rec.total("coder.rans.dec.symbols") == len(idx)
    rans.decode_with_indexes(data, idx, *_args(t))
    assert rec.total("coder.rans.dec.direct") == direct
