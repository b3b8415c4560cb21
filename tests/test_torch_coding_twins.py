"""The port's pure-Python (and numpy) twins of its native host coders:
each twin's bytes against the port's native coder and against the JAX
package's twin on the same seeded inputs, each decode back to the input,
the fallback taken when the build fails (one warning carrying the build's
error), and a CPU codec at N=16 writing the native containers with all
four twins forced, in ``geom="topk"`` and ``geom="coded"``."""

import numpy as np
import pytest
import torch

import upcc_tpu  # noqa: F401
import jax
import jax.numpy as jnp

from upcc_tpu.coding import occ as JOCC
from upcc_tpu.coding import octree as JOCT
from upcc_tpu.coding import rans as JRANS
from upcc_tpu.data.synthetic import surface_cloud
from upcc_tpu.models.unified import UnifiedModel as JModel
from upcc_tpu.ops import sparse as JS
from upcc_tpu.ops.sparse import from_points
from upcc_tpu_torch.codec.codec import Codec as TCodec
from upcc_tpu_torch.coding import build
from upcc_tpu_torch.coding import occ as TOCC
from upcc_tpu_torch.coding import octree as TOCT
from upcc_tpu_torch.coding import rans as TRANS
from upcc_tpu_torch.models.entropy import gaussian as TG
from upcc_tpu_torch.models.unified import UnifiedModel as TModel
from upcc_tpu_torch.ops import sparse as TS
from upcc_tpu_torch.ops.coords import morton_encode_np
from upcc_tpu_torch.weights import params_from_jax

torch.set_num_threads(2)

CFG = {
    "max_batch": 8,
    "g_a": {"C_in": 4, "N1": 16, "N2": 16, "N3": 16, "N4": 16},
    "g_s": {"C_out": 3, "N1": 16, "N2": 16, "N3": 16, "N4": 16,
            "min_one_child": True},
    "entropy_model": {
        "C_bottleneck": 16, "C_hyper_bottleneck": 24,
        "quantization_mode": "ste", "inverse_rescaling": True,
        "quantization_offset": True,
    },
}
# (module, its library global): the four native host libraries
NATIVE = [(TRANS, "_lib"), (TOCT, "_lib"), (TOCC, "_lib"), (TS, "_vox_lib")]


def force_twins(monkeypatch):
    for mod, name in NATIVE:
        monkeypatch.setattr(mod, name, False)


# -- octree -----------------------------------------------------------------

def _codes(seed, levels, n):
    rng = np.random.default_rng(seed)
    if n == 1:
        return np.array([rng.integers(0, 8 ** levels)], np.int64)
    # a surface-like cloud: clustered voxels, so contexts see neighbours
    side = 1 << levels
    centre = rng.integers(0, side, 3)
    xyz = np.clip(centre + rng.normal(0, max(side / 8, 1), (n, 3)), 0,
                  side - 1).astype(np.int64)
    return np.unique(morton_encode_np(xyz))


@pytest.mark.parametrize("levels", list(range(1, 12)))
@pytest.mark.parametrize("n", [1, 300])
def test_octree_twin_matches_native_and_jax(levels, n):
    codes = _codes(levels * 7 + n, levels, n)
    native = TOCT.encode(codes, levels)
    assert TOCT._load(), "the native octree coder did not build"
    twin = TOCT._py_encode(codes, levels)
    assert twin == native == JOCT._py_encode(codes, levels)
    np.testing.assert_array_equal(
        TOCT._py_decode(native, levels, len(codes)), codes)
    np.testing.assert_array_equal(TOCT.decode(native, levels, len(codes)),
                                  codes)


def test_octree_twin_edges(monkeypatch):
    codes = _codes(3, 4, 60)
    data = TOCT.encode(codes, 4)
    monkeypatch.setattr(TOCT, "_lib", False)
    assert TOCT.encode(np.zeros(0, np.int64), 4) == b""
    assert TOCT.decode(b"", 4, 10).size == 0
    assert TOCT.encode(codes, 4) == data
    with pytest.raises(RuntimeError, match="octree decode failed: -1"):
        TOCT.decode(data, 4, len(codes) - 1)
    with pytest.raises(RuntimeError, match="-3"):
        TOCT.encode(codes, 22)
    # past the end of its buffer the decoder reads zeros, as the C++ one
    cut = data[:len(data) // 2]
    got = TOCT.decode(cut, 4, 8 ** 4)
    monkeypatch.setattr(TOCT, "_lib", None)
    np.testing.assert_array_equal(got, TOCT.decode(cut, 4, 8 ** 4))


# -- occupancy ----------------------------------------------------------------

def _occ_frame(seed, n_parents):
    rng = np.random.default_rng(seed)
    dens = rng.beta(0.6, 0.6, n_parents)
    bits = (rng.random((n_parents, 8)) < dens[:, None]).reshape(-1)
    return bits.astype(np.uint8), rng.integers(0, 34, 8 * n_parents
                                               ).astype(np.uint8)


@pytest.mark.parametrize("n_parents", [1, 37, 2000])
def test_occ_twin_matches_native_and_jax(n_parents):
    bits, bins = _occ_frame(n_parents, n_parents)
    native = TOCC.encode(bits, bins)
    assert TOCC._load(), "the native occupancy coder did not build"
    assert TOCC._py_encode(bits, bins) == native \
        == JOCC._py_encode(bits, bins)
    np.testing.assert_array_equal(TOCC._py_decode(native, bins), bits)


def test_occ_twin_carries_through_0xff_bytes(monkeypatch):
    """Seed 99's 200 parents make a carry run back through two 0xFF
    bytes into the byte before them; the twin writes the native bytes."""
    runs = []
    carry = TOCT._Encoder._carry

    def watch(enc):
        tail = len(enc.out) - len(bytes(enc.out).rstrip(b"\xff"))
        runs.append(tail)
        carry(enc)
    monkeypatch.setattr(TOCT._Encoder, "_carry", watch)
    rng = np.random.default_rng(99)
    dens = rng.beta(0.6, 0.6, 200)
    bits = (rng.random((200, 8)) < dens[:, None]).reshape(-1).astype(np.uint8)
    bins = rng.integers(0, 32, 1600).astype(np.uint8)
    twin = TOCC._py_encode(bits, bins)
    assert max(runs) >= 2
    assert twin == TOCC.encode(bits, bins) == JOCC._py_encode(bits, bins)
    np.testing.assert_array_equal(TOCC._py_decode(twin, bins), bits)


def test_occ_twin_drops_a_carry_through_an_all_0xff_prefix():
    """The reference coder loses a carry that runs through every byte
    written so far (``occ.cpp`` ``carry()``: the loop ends without an
    increment); the twin keeps that.  The encoder cannot reach it from its
    initial state: its interval never leaves the initial [0, 2^32 - 1)
    (scaled by each byte written), so whenever every byte written is 0xFF,
    low + range is below 2^32 and no carry arises.  So the twin's
    ``_carry`` is driven directly, beside the JAX twin's."""
    for mod in (TOCT, JOCT):
        enc = mod._Encoder()
        enc.out = bytearray(b"\xff\xff\xff")
        enc._carry()
        assert enc.out == bytearray(3)
        enc.out = bytearray(b"\x12\xff\xff")
        enc._carry()
        assert enc.out == bytearray(b"\x13\x00\x00")


# -- rANS ---------------------------------------------------------------------

@pytest.fixture(scope="module")
def tables():
    return TG.build_cdf_tables()


def _symbols(seed, n, tables):
    rng = np.random.default_rng(seed)
    ncdf = len(tables["cdf_length"])
    idx = rng.integers(0, ncdf, n).astype(np.int32)
    half = tables["cdf_length"][idx] // 2
    vals = np.round(rng.normal(0, half / 3 + 1)).astype(np.int32)
    # escapes on both sides, some far out
    esc = rng.random(n) < 0.05
    vals[esc] = rng.integers(-5000, 5000, esc.sum())
    return vals, idx


@pytest.mark.parametrize("n", [0, 1, 2000])
def test_rans_twin_matches_native_and_jax(tables, n):
    vals, idx = _symbols(n, n, tables)
    args = (tables["cdf"], tables["cdf_length"], tables["offset"])
    native = TRANS.encode_with_indexes(vals, idx, *args)
    assert TRANS._load(), "the native rANS coder did not build"
    twin = TRANS._py_encode(vals, idx, *args)
    assert twin == native == JRANS._py_encode(vals, idx, *args)
    buf = np.frombuffer(native, np.uint8)
    np.testing.assert_array_equal(TRANS._py_decode(buf, idx, *args), vals)
    np.testing.assert_array_equal(JRANS._py_decode(buf, idx, *args), vals)


# -- voxelize -----------------------------------------------------------------

def _points(seed, n=3000):
    rng = np.random.default_rng(seed)
    batch = rng.integers(-1, 3, n).astype(np.int32)  # -1: padding rows
    xyz = rng.integers(0, 40, (n, 3)).astype(np.int32)  # many repeats
    feats = rng.random((n, 3)).astype(np.float32)
    return batch, xyz, feats


@pytest.mark.parametrize("stride,capacity", [(1, 4096), (2, 4096),
                                             (1, 500)])
def test_voxelize_numpy_path_matches_native_and_jax(monkeypatch, stride,
                                                    capacity):
    b, x, f = _points(stride * capacity)
    nk, nf = TS.voxelize_host_np(b, x, f, capacity, stride)
    assert TS._load_voxelize(), "the native voxelizer did not build"
    jk, jf = JS.voxelize_host_np(b, x, f, capacity, stride)
    monkeypatch.setattr(TS, "_vox_lib", False)
    tk, tf = TS.voxelize_host_np(b, x, f, capacity, stride)
    for keys, feats in ((nk, nf), (jk, jf)):
        np.testing.assert_array_equal(tk, keys)
        np.testing.assert_array_equal(tf, feats)


def test_voxelize_without_dedup_keeps_every_row():
    b, x, f = _points(4)
    tk, tf = TS.voxelize_host_np(b, x, f, 4096, dedup=False)
    jk, jf = JS.voxelize_host_np(b, x, f, 4096, dedup=False)
    np.testing.assert_array_equal(tk, jk)
    np.testing.assert_array_equal(tf, jf)
    assert (tk != np.iinfo(np.int64).max).sum() == (b >= 0).sum()


# -- the fallback -------------------------------------------------------------

@pytest.mark.parametrize("mod,name", NATIVE,
                         ids=["rans", "octree", "occ", "voxelize"])
def test_failed_build_warns_and_falls_back(monkeypatch, mod, name):
    def fail(src, lib_name):
        raise RuntimeError(f"g++ failed for {src}:\nfatal: no {lib_name}")
    monkeypatch.setattr(build, "load_native", fail)
    monkeypatch.setattr(mod, name, None)
    load = TS._load_voxelize if mod is TS else mod._load
    with pytest.warns(RuntimeWarning, match="g\\+\\+ failed") as rec:
        assert load() is False
    assert "fatal: no" in str(rec[0].message)
    assert load() is False  # one warning: the outcome is kept


def test_fallback_outputs_equal_native(monkeypatch, tables):
    codes = _codes(1, 8, 400)
    bits, bins = _occ_frame(5, 100)
    vals, idx = _symbols(6, 500, tables)
    args = (tables["cdf"], tables["cdf_length"], tables["offset"])
    b, x, f = _points(7)

    def run():
        o = TOCT.encode(codes, 8)
        c = TOCC.encode(bits, bins)
        r = TRANS.encode_with_indexes(vals, idx, *args)
        return (o, TOCT.decode(o, 8, 10 ** 5), c, TOCC.decode(c, bins), r,
                TRANS.decode_with_indexes(r, idx, *args),
                *TS.voxelize_host_np(b, x, f, 4096))
    native = run()
    force_twins(monkeypatch)
    for a, t in zip(native, run()):
        if isinstance(a, bytes):
            assert a == t
        else:
            np.testing.assert_array_equal(a, t)


# -- a codec with every twin --------------------------------------------------

@pytest.fixture(scope="module")
def codec():
    model = JModel(CFG)
    rng = np.random.default_rng(0)
    xyz, rgb = surface_cloud(rng, extent=32, n_target=600)
    st = from_points(jnp.zeros(len(xyz), jnp.int32), jnp.asarray(xyz),
                     jnp.asarray(rgb), capacity=1024)
    params = jax.jit(model.init)({"params": jax.random.PRNGKey(0),
                                  "noise": jax.random.PRNGKey(1)}, st,
                                 jnp.full((1, 2), 0.5, jnp.float32),
                                 jnp.ones((1, 2), jnp.float32))["params"]
    tm = TModel(CFG)
    tm.load_state_dict(params_from_jax(
        jax.tree_util.tree_map(np.asarray, params), tm))
    tc = TCodec(tm, device="cpu")
    tc.update()
    return tc


@pytest.mark.parametrize("geom", ["topk", "coded"])
def test_codec_with_all_twins_writes_the_native_bytes(codec, monkeypatch,
                                                      geom):
    rng = np.random.default_rng(11)
    xyz, rgb = surface_cloud(rng, extent=64, n_target=1500)
    frame = np.concatenate([xyz.astype(np.float32), rgb], 1)
    q = (0.5, 0.5)
    data = codec.compress(frame, q, block_size=64, geom=geom)
    rec = codec.decompress(data)
    assert all(mod.__dict__[name] for mod, name in NATIVE)
    force_twins(monkeypatch)
    assert codec.compress(frame, q, block_size=64, geom=geom) == data
    np.testing.assert_array_equal(codec.decompress(data), rec)
