"""Parity of the PyTorch port's model modules with the JAX package, on the
CPU at N=16 (the config of tests/test_codec_roundtrip.py), with the JAX
init's parameters carried across by ``weights.params_from_jax``."""

import numpy as np
import pytest
import torch

import upcc_tpu  # noqa: F401
import jax
import jax.numpy as jnp

from upcc_tpu.codec.codec import _bucket, _host_downsample_levels, _z_hs_caps
from upcc_tpu.data.synthetic import surface_cloud
from upcc_tpu.models.entropy import gaussian as JG
from upcc_tpu.models.entropy.bottleneck import build_cdf_tables as j_cdf
from upcc_tpu.models.gdn import GDN as JGDN
from upcc_tpu.models.transforms import SparseSynthesisTransform as JGS
from upcc_tpu.models.unified import UnifiedModel as JModel
from upcc_tpu.ops import family as JF
from upcc_tpu.ops.sparse import SparseTensor as JST, from_points, \
    voxelize_host_np
from upcc_tpu_torch.models.entropy import gaussian as TG
from upcc_tpu_torch.models.entropy.bottleneck import build_cdf_tables as t_cdf
from upcc_tpu_torch.models.unified import UnifiedModel as TModel
from upcc_tpu_torch.ops.sparse import SparseTensor as TST
from upcc_tpu_torch.weights import params_from_jax

torch.set_num_threads(2)

CFG = {
    "max_batch": 8,
    "g_a": {"C_in": 4, "N1": 16, "N2": 16, "N3": 16, "N4": 16},
    "g_s": {"C_out": 3, "N1": 16, "N2": 16, "N3": 16, "N4": 16},
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


def _numpy_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


@pytest.fixture(scope="module")
def pair():
    """(jax model with max_batch 64, params, port model) — the codec's
    batched twin."""
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
    tm.load_state_dict(params_from_jax(_numpy_tree(params), tm))
    return JModel(cfg64), params, tm.eval()


@pytest.fixture(scope="module")
def frame():
    """A 2-block voxelized input with the codec's host-side structure."""
    rng = np.random.default_rng(5)
    xyz1, rgb1 = surface_cloud(rng, extent=64, n_target=900)
    xyz2, rgb2 = surface_cloud(rng, extent=64, n_target=700)
    batch = np.concatenate([np.zeros(len(xyz1), np.int32),
                            np.ones(len(xyz2), np.int32)])
    xyz = np.concatenate([xyz1, xyz2])
    rgb = np.concatenate([rgb1, rgb2])
    cap = _bucket(len(xyz))
    keys, feats = voxelize_host_np(batch, xyz, rgb, cap)
    feats = np.clip(np.round(feats * 255), 0, 255).astype(np.uint8) \
        .astype(np.float32) / np.float32(255.0)
    lvl = _host_downsample_levels(keys, 5)
    caps4 = tuple(_bucket(len(k)) for k in lvl[:4])
    _, ri, ro = JF.host_root_neighbors(keys, 4, caps4[3], list(caps4))
    return {"keys": keys, "feats": feats, "lvl": lvl, "caps4": caps4,
            "root": (ri, ro)}


def _ga_both(pair, frame):
    jm, params, tm = pair
    caps4 = frame["caps4"]
    x = JST(keys=jnp.asarray(frame["keys"]), feats=jnp.asarray(frame["feats"]))
    ref = jax.jit(lambda p, x, r: jm.apply({"params": p}, x, r, caps4,
                                           method=jm.ga_device))(
        params, x, frame["root"])
    with torch.no_grad():
        got = tm.ga_device(TST(T(frame["keys"]), T(frame["feats"])),
                           (T(frame["root"][0]), T(frame["root"][1])), caps4,
                           max_batch=64)
    return ref, got


def test_params_from_jax_consumes_every_leaf(pair):
    _, params, tm = pair
    tree = _numpy_tree(params)
    sd = params_from_jax(tree, tm)
    assert set(sd) == set(tm.state_dict())
    extra = jax.tree_util.tree_map(lambda a: a, tree)
    extra["g_a"]["conv1"]["extra"] = np.zeros(3, np.float32)
    with pytest.raises(ValueError, match="leftover"):
        params_from_jax(extra, tm)
    missing = jax.tree_util.tree_map(lambda a: a, tree)
    del missing["g_s"]["color_conv"]["b"]
    with pytest.raises(ValueError, match="missing"):
        params_from_jax(missing, tm)
    bad = jax.tree_util.tree_map(lambda a: a, tree)
    bad["g_a"]["conv1"]["b"] = np.zeros(5, np.float32)
    with pytest.raises(ValueError, match="shape"):
        params_from_jax(bad, tm)


@pytest.mark.parametrize("inverse", [False, True])
def test_gdn_matches_jax(pair, inverse):
    _, params, tm = pair
    name = "igdn2" if inverse else "gdn2"
    part = "g_s" if inverse else "g_a"
    p = params[part][name]
    x = np.random.default_rng(1).standard_normal((50, 16)).astype(np.float32)
    ref = JGDN(16, inverse=inverse).apply({"params": p}, x)
    with torch.no_grad():
        got = getattr(getattr(tm, part), name)(T(x))
    np.testing.assert_allclose(N(got), np.asarray(ref), 1e-4, 1e-5)


def test_entropy_tables_match_jax(pair):
    _, params, tm = pair
    bn = tm.entropy_model.bottleneck
    ref = j_cdf(jax.device_get(params["entropy_model"]["bottleneck"]), 24)
    got = t_cdf(bn.numpy_params(), 24)
    for key in ref:
        np.testing.assert_array_equal(got[key], ref[key])
    ref_y, got_y = JG.build_cdf_tables(), TG.build_cdf_tables()
    for key in ref_y:
        np.testing.assert_array_equal(got_y[key], ref_y[key])
    scales = np.exp(np.random.default_rng(2).uniform(-4, 6, 5000)
                    ).astype(np.float32)
    np.testing.assert_array_equal(N(TG.build_indexes(T(scales))),
                                  np.asarray(JG.build_indexes(scales)))


def test_analysis_matches_jax(pair, frame):
    """g_a: keys and per-level counts exact; features through 4 convs and
    3 GDNs, f32 sums in another order: rtol 1e-3, atol 1e-4."""
    ref, got = _ga_both(pair, frame)
    np.testing.assert_array_equal(N(got["y_keys"]), np.asarray(ref["y_keys"]))
    np.testing.assert_array_equal(N(got["k"]), np.asarray(ref["k"]))
    np.testing.assert_allclose(N(got["y_feats"]), np.asarray(ref["y_feats"]),
                               1e-3, 1e-4)


def test_hyper_and_params_match_jax(pair, frame):
    """h_a symbols and the decoder's params graph.  Symbols and scale
    indexes are roundings of floats that differ by f32 sum order, so a
    value on a rounding edge may land one step apart (allowed for 1 in
    1000, by at most 1); scales and means at rtol 1e-3, atol 1e-4."""
    jm, params, tm = pair
    ref_ga, _ = _ga_both(pair, frame)
    lvl = frame["lvl"]
    ycap = frame["caps4"][2]
    y_keys = np.asarray(ref_ga["y_keys"])
    y_feats = np.asarray(ref_ga["y_feats"])
    z_caps, hs_caps = _z_hs_caps(len(lvl[3]), len(lvl[4]))
    _, zi, zo = JF.host_root_neighbors(y_keys, 2, z_caps[1], list(z_caps))
    ref = jax.jit(lambda p, k, f, r: jm.apply(
        {"params": p}, k, f, r, z_caps, method=jm.hyper_analyze_device))(
        params, y_keys, y_feats, (zi, zo))
    with torch.no_grad():
        got = tm.hyper_analyze_device(T(y_keys), T(y_feats), (T(zi), T(zo)),
                                      z_caps)
    np.testing.assert_array_equal(N(got["z_keys"]), np.asarray(ref["z_keys"]))
    dz = np.abs(N(got["z_sym"]).astype(int) - np.asarray(ref["z_sym"]))
    assert dz.max() <= 1 and (dz > 0).mean() <= 1e-3

    z_sym = np.asarray(ref["z_sym"])
    q = np.asarray([[0.3, 0.8]], np.float32)
    jdec = jax.jit(lambda p, k, z, q, r: jm.apply(
        {"params": p}, k, z, q, r, z_caps, hs_caps,
        method=jm.decode_params_device))(params, y_keys, z_sym, q, (zi, zo))
    with torch.no_grad():
        tdec = tm.decode_params_device(T(y_keys), T(z_sym), T(q),
                                       (T(zi), T(zo)), z_caps, hs_caps)
    for key in ("scales_hat", "means_hat", "scale", "rescale"):
        np.testing.assert_allclose(N(tdec[key]), np.asarray(jdec[key]),
                                   1e-3, 1e-4)
    di = np.abs(N(tdec["indexes"]).astype(int)
                - np.asarray(jdec["indexes"]).astype(int))
    assert di.max() <= 1 and (di > 0).mean() <= 1e-3
    for key in ("parent_keys", "pp", "sl", "nbr_idx", "nbr_ok"):
        np.testing.assert_array_equal(N(tdec["y_struct"][key]),
                                      np.asarray(jdec["y_struct"][key]))
    assert ycap == y_keys.shape[0]

    # y symbols from the same params (the op order is part of the format)
    ysym_ref = jax.jit(lambda p, f, d: jm.apply(
        {"params": p}, f, d, method=jm.encode_symbols_device))(
        params, y_feats, jdec)
    tdec_j = {k: T(v) if not isinstance(v, dict) else v
              for k, v in jax.device_get(jdec).items()}
    with torch.no_grad():
        ysym = tm.encode_symbols_device(T(y_feats), tdec_j)
        yhat = tm.dequantize_y_device(ysym, tdec_j)
    np.testing.assert_array_equal(N(ysym), np.asarray(ysym_ref))
    yhat_ref = jax.jit(lambda p, s, d: jm.apply(
        {"params": p}, s, d, method=jm.dequantize_y_device))(
        params, ysym_ref, jdec)
    np.testing.assert_allclose(N(yhat), np.asarray(yhat_ref), 1e-5, 1e-6)


@pytest.mark.parametrize("min_one_child", [False, True])
def test_synthesis_matches_jax(pair, frame, min_one_child):
    """g_s on the same latents and k: level-0 logits at rtol 1e-3, atol
    1e-4 (a 5^3 conv, IGDN, a transpose and two head convs); the selected
    voxel set exact (this seed has no rank flip at any threshold); colors
    at atol 1e-3 (the finest features ride bf16 in both packages, one bf16
    step of a feature moves a color by far less)."""
    jm, params, tm = pair
    tm.g_s.min_one_child = min_one_child
    ref_ga, _ = _ga_both(pair, frame)
    y_keys = np.asarray(ref_ga["y_keys"])
    y_feats = np.round(np.asarray(ref_ga["y_feats"]) * 4) / 4
    k = np.asarray(ref_ga["k"])
    caps = tuple(_bucket(int(k[l].sum())) for l in range(3))
    jgs = JGS(max_batch=64, min_one_child=min_one_child, **CFG["g_s"])
    jx, jc, jl = jax.jit(lambda p, y, k: jgs.apply(
        {"params": p}, y, k, caps))(params["g_s"],
                                   JST(keys=jnp.asarray(y_keys),
                                       feats=jnp.asarray(y_feats), stride=8),
                                   k)
    with torch.no_grad():
        tx, tc, tl = tm.g_s(TST(T(y_keys), T(y_feats), 8), T(k), caps)
    tm.g_s.min_one_child = False
    np.testing.assert_allclose(N(tl[0]), np.asarray(jl[0]), 1e-3, 1e-4)
    for a, b in zip(tc, jc):
        np.testing.assert_array_equal(N(a.keys), np.asarray(b.keys))
    np.testing.assert_array_equal(N(tx.keys), np.asarray(jx.keys))
    np.testing.assert_allclose(N(tx.feats), np.asarray(jx.feats), 0, 1e-3)
