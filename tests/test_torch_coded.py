"""The port's lossless-geometry (coded-occupancy) mode against the JAX
package's, on the CPU at N=16: the occupancy coder's bytes, the refine
helpers, the staged synthesis pass per stage, and the whole
compress(geom="coded") -> decompress slice."""

import numpy as np
import pytest
import torch

import upcc_tpu  # noqa: F401
import jax
import jax.numpy as jnp

from upcc_tpu.codec import bitstream as JB
from upcc_tpu.codec import refine as JRF
from upcc_tpu.codec.codec import (Codec as JCodec, _bucket,
                                  _chunk_decode_groups as j_chunk,
                                  _host_downsample_levels, _z_hs_caps)
from upcc_tpu.coding import occ as JOCC
from upcc_tpu.data.synthetic import surface_cloud
from upcc_tpu.models.unified import UnifiedModel as JModel
from upcc_tpu.ops import family as JF
from upcc_tpu.ops.sparse import SparseTensor as JST, from_points, \
    voxelize_host_np
from upcc_tpu_torch.codec import refine as TRF
from upcc_tpu_torch.codec.codec import (Codec as TCodec,
                                        _chunk_decode_groups as t_chunk)
from upcc_tpu_torch.coding import occ as TOCC
from upcc_tpu_torch.models.unified import UnifiedModel as TModel
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


def T(x):
    return torch.from_numpy(np.array(x))


def N(x):
    return x.detach().numpy() if isinstance(x, torch.Tensor) \
        else np.asarray(x)


def _occ_frame(rng, n_parents):
    dens = rng.beta(0.6, 0.6, n_parents)
    bits = rng.random((n_parents, 8)) < dens[:, None]
    logit = np.where(bits, 2.0, -2.0) + rng.normal(0, 2.5, bits.shape)
    bins = N(TRF.bin_logits(T(logit.astype(np.float32))))
    return bits.reshape(-1).astype(np.uint8), bins.reshape(-1)


@pytest.mark.parametrize("n_parents", [1, 500, 4000])
def test_occ_streams_match_jax(n_parents):
    bits, bins = _occ_frame(np.random.default_rng(n_parents), n_parents)
    data = TOCC.encode(bits, bins)
    assert data == JOCC.encode(bits, bins)
    np.testing.assert_array_equal(TOCC.decode(data, bins), bits)
    np.testing.assert_array_equal(JOCC.decode(data, bins), bits)


def test_occ_empty_and_alignment():
    assert TOCC.encode(np.zeros(0, np.uint8), np.zeros(0, np.uint8)) == b""
    assert TOCC.decode(b"", np.zeros(0, np.uint8)).size == 0
    with pytest.raises(ValueError):
        TOCC.encode(np.zeros(7, np.uint8), np.zeros(7, np.uint8))
    with pytest.raises(ValueError):
        TOCC.decode(b"x", np.zeros(9, np.uint8))


def test_bin_logits_match_jax():
    rng = np.random.default_rng(0)
    edges = TRF.LOGIT_LO + np.arange(TRF.N_BINS + 1) * 0.5
    x = np.concatenate([
        rng.standard_normal(20000) * 5, edges, np.nextafter(edges, -np.inf),
        np.nextafter(edges, np.inf), [0.0, -0.0, 100.0, -100.0, 7.9999995]
    ]).astype(np.float32)
    got = N(TRF.bin_logits(T(x)))
    np.testing.assert_array_equal(got, np.asarray(JRF.bin_logits(x)))
    assert got.dtype == np.uint8 and got.max() == 31 and got.min() == 0
    assert got[len(x) - 5] == got[len(x) - 4] == 16  # a logit of 0 bins to 16


def test_refine_helpers_match_jax():
    rng = np.random.default_rng(1)
    parents = np.unique(rng.integers(0, 1 << 30, 500).astype(np.int64)
                        | (rng.integers(0, 5, 500).astype(np.int64)
                           << TRF.BATCH_SHIFT))
    kids = TRF.children_np(parents)
    np.testing.assert_array_equal(kids, JRF.children_np(parents))
    gt = np.sort(kids[rng.random(len(kids)) < 0.3])
    np.testing.assert_array_equal(TRF.occupancy_np(kids, gt),
                                  JRF.occupancy_np(kids, gt))
    assert not TRF.occupancy_np(kids, np.zeros(0, np.int64)).any()
    np.testing.assert_array_equal(TRF.bin_probabilities(),
                                  JRF.bin_probabilities())
    bins = rng.integers(0, 32, len(kids))
    pq = TRF.quantize_tables(TRF.occupancy_np(kids, gt), bins)
    np.testing.assert_array_equal(
        pq, JRF.quantize_tables(JRF.occupancy_np(kids, gt), bins))
    for a, b in ((TRF.build_occ_cdf_tables(), JRF.build_occ_cdf_tables()),
                 (TRF.tables_from_quantized(pq),
                  JRF.tables_from_quantized(pq))):
        for key in a:
            np.testing.assert_array_equal(a[key], b[key])
    assert TRF.BATCH_SHIFT == JRF.BATCH_SHIFT


def _blk(q=(0.5, 0.5), k=(10, 20, 40), occ=None):
    return {"q": q, "k": list(k), "occ_bytes": occ}


def test_chunk_decode_groups_split_on_occ_bytes():
    """Coded and top-k blocks never share a decode group, and the group
    rule is the JAX package's."""
    o = (b"a", b"b", b"c")
    blocks = [_blk(), _blk(occ=o), _blk(occ=o), _blk(), _blk(q=(0.1, 0.5)),
              _blk(q=(0.1, 0.5), occ=o)] + [_blk(occ=o)] * 70 \
        + [_blk(k=(10, 20, 700_000)), _blk(k=(10, 20, 200_000))]
    got, ref = t_chunk(blocks), j_chunk(blocks)
    assert [len(g) for g in got] == [len(g) for g in ref]
    assert [len(g) for g in got][:6] == [1, 2, 1, 1, 1, 63]
    for g in got:
        assert len({b["occ_bytes"] is None for b in g}) == 1
        assert len({b["q"] for b in g}) == 1


@pytest.fixture(scope="module")
def pair():
    model = JModel(CFG)
    rng = np.random.default_rng(0)
    xyz, rgb = surface_cloud(rng, extent=32, n_target=600)
    st = from_points(jnp.zeros(len(xyz), jnp.int32), jnp.asarray(xyz),
                     jnp.asarray(rgb), capacity=1024)
    params = jax.jit(model.init)({"params": jax.random.PRNGKey(0),
                                  "noise": jax.random.PRNGKey(1)}, st,
                                 jnp.full((1, 2), 0.5, jnp.float32),
                                 jnp.ones((1, 2), jnp.float32))["params"]
    cfg64 = dict(CFG, max_batch=64)
    tm = TModel(cfg64)
    tm.load_state_dict(params_from_jax(
        jax.tree_util.tree_map(np.asarray, params), tm))
    return model, JModel(cfg64), params, tm.eval()


def _torch_tree(tree):
    return {k: _torch_tree(v) if isinstance(v, dict) else T(v)
            for k, v in tree.items()}


def test_decode_refine_device_matches_jax(pair):
    """The staged synthesis on a 2-block input, fed the same y symbols,
    params and true-occupancy keep masks on both sides: each stage's logits
    within 1e-4 (f32 sums in another order through a 5^3 conv, IGDNs, a
    transpose and two head convs per level), its context bins equal, and
    the final pass's voxel set exact with colors at atol 1e-3 (the finest
    features ride bf16 in both packages)."""
    _, jm, params, tm = pair
    rng = np.random.default_rng(5)
    xyz1, rgb1 = surface_cloud(rng, extent=64, n_target=900)
    xyz2, rgb2 = surface_cloud(rng, extent=64, n_target=700)
    batch = np.concatenate([np.zeros(len(xyz1), np.int32),
                            np.ones(len(xyz2), np.int32)])
    keys, feats = voxelize_host_np(batch, np.concatenate([xyz1, xyz2]),
                                   np.concatenate([rgb1, rgb2]),
                                   _bucket(len(batch)))
    lvl = _host_downsample_levels(keys, 5)
    caps4 = tuple(_bucket(len(k)) for k in lvl[:4])
    _, ri, ro = JF.host_root_neighbors(keys, 4, caps4[3], list(caps4))
    ga = jax.jit(lambda p, x, r: jm.apply({"params": p}, x, r, caps4,
                                          method=jm.ga_device))(
        params, JST(keys=jnp.asarray(keys), feats=jnp.asarray(feats)),
        (ri, ro))
    y_keys = np.asarray(ga["y_keys"])
    z_caps, hs_caps = _z_hs_caps(len(lvl[3]), len(lvl[4]))
    _, zi, zo = JF.host_root_neighbors(y_keys, 2, z_caps[1], list(z_caps))
    hyp = jax.jit(lambda p, k, f, r: jm.apply(
        {"params": p}, k, f, r, z_caps, method=jm.hyper_analyze_device))(
        params, y_keys, ga["y_feats"], (zi, zo))
    q = np.asarray([[0.4, 0.7]], np.float32)
    jdec = jax.jit(lambda p, k, z, q, r: jm.apply(
        {"params": p}, k, z, q, r, z_caps, hs_caps,
        method=jm.decode_params_device))(params, y_keys, hyp["z_sym"], q,
                                         (zi, zo))
    y_sym = np.asarray(jax.jit(lambda p, f, d: jm.apply(
        {"params": p}, f, d, method=jm.encode_symbols_device))(
        params, ga["y_feats"], jdec))
    tdec = _torch_tree(jax.device_get(jdec))

    ycap = y_keys.shape[0]
    gt = (lvl[1], lvl[0], keys[keys != np.iinfo(np.int64).max])
    parents = y_keys[y_keys != np.iinfo(np.int64).max]
    keeps, caps = [], ()
    for stage in range(3):
        full = caps + (8,) * (3 - len(caps))
        jl = np.asarray(jax.jit(lambda p, k, s, d, *e: jm.apply(
            {"params": p}, k, s, d, ext_keep=e, num_levels=stage + 1,
            prune_caps=full, method=jm.decode_refine_device))(
            params, y_keys, y_sym, jdec, *keeps))
        with torch.no_grad():
            tl = tm.decode_refine_device(
                T(y_keys), T(y_sym), tdec, ext_keep=tuple(T(k) for k in keeps),
                num_levels=stage + 1, prune_caps=full)
        assert tl.shape == jl.shape
        np.testing.assert_allclose(N(tl), jl, 0, 1e-4)
        np.testing.assert_array_equal(N(TRF.bin_logits(tl)),
                                      np.asarray(JRF.bin_logits(jl)))
        cand = TRF.children_np(parents)
        occ = TRF.occupancy_np(cand, gt[stage])
        cap_in = ycap if stage == 0 else caps[-1]
        keep = np.zeros(8 * cap_in, bool)
        keep[:len(occ)] = occ
        keeps.append(keep)
        parents = cand[occ]
        caps = caps + (_bucket(len(parents)),)
    np.testing.assert_array_equal(parents, gt[2])

    jx = jax.jit(lambda p, k, s, d, *e: jm.apply(
        {"params": p}, k, s, d, ext_keep=e, num_levels=3, prune_caps=caps,
        emit_last_logits=False, method=jm.decode_refine_device))(
        params, y_keys, y_sym, jdec, *keeps)
    with torch.no_grad():
        tx = tm.decode_refine_device(
            T(y_keys), T(y_sym), tdec, ext_keep=tuple(T(k) for k in keeps),
            num_levels=3, prune_caps=caps, emit_last_logits=False)
    np.testing.assert_array_equal(N(tx.keys), np.asarray(jx.keys))
    np.testing.assert_array_equal(N(tx.keys)[:len(gt[2])], gt[2])
    np.testing.assert_allclose(N(tx.feats.float()),
                               np.asarray(jx.feats, np.float32), 0, 1e-3)


@pytest.fixture(scope="module")
def codecs(pair):
    model, _, params, _ = pair
    jc = JCodec(model, params)
    jc.update()
    tm = TModel(CFG)
    tm.load_state_dict(params_from_jax(
        jax.tree_util.tree_map(np.asarray, params), tm))
    tc = TCodec(tm, device="cpu")
    tc.update()
    return jc, tc


@pytest.fixture(scope="module")
def frame():
    rng = np.random.default_rng(7)
    parts = []
    for off in (0, 128):
        xyz, rgb = surface_cloud(rng, extent=64, n_target=1200)
        parts.append(np.concatenate(
            [(xyz + np.array([[off, 0, 0]])).astype(np.float32), rgb], 1))
    return np.concatenate(parts)


def _voxels(xyz):
    return np.unique(np.asarray(xyz).astype(np.int64), axis=0)


@pytest.mark.parametrize("block_size", [1024, 128, 32])
def test_coded_roundtrip_is_lossless(codecs, frame, block_size):
    """One block, two blocks and many blocks (several per group): every
    stage's context bins equal on both sides, the decoded voxel set equal
    to the input's, no duplicates, colors finite on the 8-bit grid."""
    _, tc = codecs
    tc.debug, tc.debug_info, tc.debug_bins = True, [], []
    try:
        data = tc.compress(frame, (0.4, 0.7), block_size=block_size,
                           geom="coded")
        rec = tc.decompress(data)
    finally:
        tc.debug = False
    enc = [d for d in tc.debug_bins if d["side"] == "enc"]
    dec = [d for d in tc.debug_bins if d["side"] == "dec"]
    assert len(enc) == len(dec) == 3
    for e, d in zip(enc, dec):
        assert e["stage"] == d["stage"]
        np.testing.assert_array_equal(e["bins"], d["bins"])
    src = _voxels(frame[:, :3])
    assert len(rec) == len(src)
    np.testing.assert_array_equal(_voxels(rec[:, :3]), src)
    assert np.isfinite(rec).all()
    np.testing.assert_array_equal(np.round(rec[:, 3:] * 255) / 255,
                                  rec[:, 3:].astype(np.float64))
    blocks, _ = JB.read_container(data)
    assert all(len(b["occ_bytes"]) == 3 for b in blocks)
    # the threaded group map (debug off) writes the same bytes
    assert tc.compress(frame, (0.4, 0.7), block_size=block_size,
                       geom="coded") == data
    np.testing.assert_array_equal(tc.decompress(data), rec)


def test_coded_container_against_jax(codecs, frame):
    """The port's coded container on the 2-block frame beside the JAX
    package's: both decode their own stream losslessly; the containers
    are byte-identical, or the first differing payload is named and both
    cross-decodes are reported."""
    jc, tc = codecs
    q = (0.4, 0.7)
    tdata = tc.compress(frame, q, block_size=128, geom="coded")
    jdata = jc.compress(frame, q, block_size=128, geom="coded")
    src = _voxels(frame[:, :3])
    trec, jrec = tc.decompress(tdata), jc.decompress(jdata)
    np.testing.assert_array_equal(_voxels(trec[:, :3]), src)
    np.testing.assert_array_equal(_voxels(jrec[:, :3]), src)
    assert len(tdata) == pytest.approx(len(jdata), rel=0.02)
    tb, jb = JB.read_container(tdata)[0], JB.read_container(jdata)[0]
    assert len(tb) == len(jb) == 2
    for a, b in zip(tb, jb):
        # coordinates, counts and headers never depend on float arithmetic
        for key in ("origin", "levels", "n_y", "n_z", "q", "k",
                    "coord_bytes"):
            assert a[key] == b[key], key
    if tdata == jdata:
        np.testing.assert_array_equal(trec, jrec)
        print("\ncoded containers byte-identical "
              f"({len(tdata)} B); decodes equal")
        return
    first = None
    for i, (a, b) in enumerate(zip(tb, jb)):
        for key in ("z_bytes", "y_bytes"):
            if first is None and a[key] != b[key]:
                first = f"block {i} {key}"
        for lv in range(3):
            if first is None and a["occ_bytes"][lv] != b["occ_bytes"][lv]:
                first = f"block {i} occupancy stage {lv}"
    report = []
    for name, codec, data in (("JAX stream under the port", tc, jdata),
                              ("port stream under JAX", jc, tdata)):
        try:
            out = codec.decompress(data)
            ok = np.array_equal(_voxels(out[:, :3]), src)
            report.append(f"{name}: decoded {len(out)} points, "
                          f"geometry lossless: {ok}")
        except Exception as exc:  # reported, not asserted
            report.append(f"{name}: failed ({exc!r})")
    print(f"\ncoded containers differ (port {len(tdata)} B, JAX "
          f"{len(jdata)} B); first differing payload: {first}; "
          + "; ".join(report))
    assert first is not None


@pytest.mark.slow
def test_flagship_width_coded_matches_jax():
    """The committed epoch-193 weights at full width, one 6000-point frame,
    geom="coded" on the CPU in f32: each package decodes its own stream
    losslessly, sizes within 1%; whether the streams are byte-identical
    and the JAX stream's decode under the port are printed."""
    import os
    from upcc_tpu_torch.weights import (FLAGSHIP_CONFIG, load_flax_msgpack,
                                        load_weights)
    weights = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "results", "CVPR_inverse_scaling",
        "weights_bf16.msgpack")
    jparams = jax.tree_util.tree_map(jnp.asarray, load_flax_msgpack(weights))
    jc = JCodec(JModel(FLAGSHIP_CONFIG), jparams)
    jc.update()
    tc = TCodec(load_weights(TModel(FLAGSHIP_CONFIG), weights), device="cpu")
    tc.update()
    xyz, rgb = surface_cloud(np.random.default_rng(10), extent=128,
                             n_target=6000)
    frame = np.concatenate([xyz.astype(np.float32), rgb], 1)
    src = _voxels(frame[:, :3])
    q = (0.5, 0.5)
    tdata = tc.compress(frame, q, block_size=1024, geom="coded")
    jdata = jc.compress(frame, q, block_size=1024, geom="coded")
    np.testing.assert_array_equal(_voxels(tc.decompress(tdata)[:, :3]), src)
    np.testing.assert_array_equal(_voxels(jc.decompress(jdata)[:, :3]), src)
    n = len(frame)
    print(f"\nflagship coded, {n} points: port {len(tdata) * 8 / n:.4f} bpp, "
          f"JAX {len(jdata) * 8 / n:.4f} bpp; identical streams: "
          f"{tdata == jdata}")
    try:
        cross = tc.decompress(jdata)
        print(f"JAX coded stream under the port: {cross.shape[0]} points, "
              f"geometry lossless: "
              f"{np.array_equal(_voxels(cross[:, :3]), src)}")
    except Exception as exc:  # reported, not asserted
        print(f"JAX coded stream under the port: failed ({exc!r})")
    assert len(tdata) == pytest.approx(len(jdata), rel=0.01)
