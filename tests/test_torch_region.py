"""Region-candidate g_s of the PyTorch port against the JAX package's, on
the CPU at N=16: the key operations it adds, its synthesis transform on
parameters carried across from a JAX init, and the codec running it."""

import os

import numpy as np
import pytest
import torch

import upcc_tpu  # noqa: F401
import jax
import jax.numpy as jnp

from upcc_tpu.codec.codec import Codec as JCodec
from upcc_tpu.codec.codec import _bucket
from upcc_tpu.data.synthetic import surface_cloud
from upcc_tpu.eval.metrics import pc_metrics
from upcc_tpu.models.transforms import SparseSynthesisTransform as JGS
from upcc_tpu.models.unified import UnifiedModel as JModel
from upcc_tpu.ops import coords as JC
from upcc_tpu.ops import family as JF
from upcc_tpu.ops import sparse as JS
from upcc_tpu.ops.sparse import from_points
from upcc_tpu_torch.codec.codec import Codec as TCodec
from upcc_tpu_torch.models.layers import _TapConv
from upcc_tpu_torch.models.transforms import SparseSynthesisTransform as TGS
from upcc_tpu_torch.models.unified import UnifiedModel as TModel
from upcc_tpu_torch.ops import coords as TC
from upcc_tpu_torch.ops import family as TF
from upcc_tpu_torch.ops import sparse as TS
from upcc_tpu_torch.ops.sparse import SparseTensor as TST
from upcc_tpu_torch.utils import profiling
from upcc_tpu_torch.weights import ABL_REGION5_CONFIG, params_from_jax

torch.set_num_threads(2)
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

GS = {"C_out": 3, "N1": 16, "N2": 16, "N3": 16, "N4": 16,
      "region_candidates": True}
CFG = {
    "max_batch": 8,
    "g_a": {"C_in": 4, "N1": 16, "N2": 16, "N3": 16, "N4": 16},
    "g_s": GS,
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


def _keys(rng, n, batches=2, span=40, pad=37):
    """Sorted unique keys of ``batches`` batches, units in [0, span) (the
    border at 0 included), SENTINEL padded."""
    out = []
    for b in range(batches):
        u = rng.integers(0, span, (n, 3))
        k = np.unique(JC.morton_encode_np(u)) | (np.int64(b) << JC.BATCH_SHIFT)
        out.append(k)
    keys = np.concatenate(out + [np.full(pad, JC.SENTINEL, np.int64)])
    return keys


@pytest.mark.parametrize("n,cap_factor", [(300, 27), (300, 3), (40, 1),
                                          (1, 30)])
def test_dilate_keys_matches_jax(n, cap_factor):
    """Dedup'd 27-dilation, sorted, padded and clipped at the capacity
    (3x is region mode's own factor; 1x truncates)."""
    keys = _keys(np.random.default_rng(n), n)
    cap = cap_factor * len(keys)
    ref = np.asarray(JS.dilate_keys(jnp.asarray(keys), cap))
    got = N(TS.dilate_keys(T(keys), cap))
    np.testing.assert_array_equal(got, ref)


@pytest.mark.parametrize("kernel", [5, 2])
def test_expand_region_keys_matches_jax(kernel):
    keys = _keys(np.random.default_rng(kernel), 200)
    offs = JC.kernel_offsets(kernel)
    np.testing.assert_array_equal(TC.kernel_offsets(kernel), offs)
    for cap in (len(offs) * len(keys), 4 * len(keys)):
        ref = np.asarray(JS.expand_region_keys(jnp.asarray(keys), offs, cap))
        got = N(TS.expand_region_keys(T(keys), offs, cap))
        np.testing.assert_array_equal(got, ref)


def test_shift_units_matches_jax():
    keys = _keys(np.random.default_rng(1), 100, span=1 << 19)
    for delta, scale in (((-1, 0, 1), 1), ((2, -2, 0), 2), ((0, 0, 0), 1)):
        rk, rok = JC.shift_units(jnp.asarray(keys), delta, scale=scale)
        gk, gok = TC.shift_units(T(keys), delta, scale=scale)
        np.testing.assert_array_equal(N(gk), np.asarray(rk))
        np.testing.assert_array_equal(N(gok), np.asarray(rok))


def test_transpose_cover_table_matches_jax():
    np.testing.assert_array_equal(TF.transpose_cover_table(),
                                  JF.transpose_cover_table())


def test_cross_neighbors_matches_jax():
    keys = _keys(np.random.default_rng(2), 150, span=12)
    d_keys = np.asarray(JS.dilate_keys(jnp.asarray(keys), 3 * len(keys)))
    ri, rf = JF.cross_neighbors(jnp.asarray(d_keys), jnp.asarray(keys))
    gi, gf = TF.cross_neighbors(T(d_keys), T(keys))
    np.testing.assert_array_equal(N(gi), np.asarray(ri))
    np.testing.assert_array_equal(N(gf), np.asarray(rf))
    assert N(gf).any() and not N(gf).all()


def test_min_one_child_with_region_raises():
    """The per-parent floor needs the 8-child parent-major layout: both
    packages refuse the combination (the port when the transform is
    built, the JAX package when it runs)."""
    with pytest.raises(ValueError, match="min_one_child"):
        TGS(**dict(GS, min_one_child=True))
    keys = jnp.asarray(_keys(np.random.default_rng(3), 20, batches=1,
                             pad=0))
    y = JS.SparseTensor(keys=keys, feats=jnp.zeros((len(keys), 16)),
                        stride=8)
    with pytest.raises(ValueError, match="min_one_child"):
        JGS(max_batch=8, **dict(GS, min_one_child=True)).init(
            jax.random.PRNGKey(0), y, jnp.ones((3, 8), jnp.int32))


@pytest.mark.parametrize("entry", ["compress", "compress_multi"])
def test_coded_geometry_with_region_raises(entry):
    """geom="coded" on a region-candidate model raises a clear ValueError
    before any work (the coded bits cover 8 children a parent, the region
    candidates the 27-dilated set; the JAX codec fails later, at its prune
    site, with a shape error)."""
    torch.manual_seed(0)
    codec = TCodec(TModel(CFG), device="cpu")
    codec.update()

    def no_work(*a, **kw):
        raise AssertionError("the codec started encoding")
    codec._partition_blocks = no_work
    frame = np.zeros((8, 6), np.float32)
    qs = (0.5, 0.5) if entry == "compress" else [(0.5, 0.5)]
    with pytest.raises(ValueError, match="region_candidates"):
        getattr(codec, entry)(frame, qs, geom="coded")


def test_region_config_matches_yaml():
    import yaml
    with open(os.path.join(ROOT, "configs", "ablation",
                           "abl_region5.yaml")) as f:
        assert yaml.safe_load(f)["model"] == ABL_REGION5_CONFIG


def test_region_layers_never_grand():
    """Region mode runs every level outside grandparent layout, so the
    finest transpose and head are prepared for the plain call shapes."""
    tm = TModel(CFG)
    gs = tm.g_s
    assert not gs.grand_finest
    assert not any(m.grand for m in gs.modules() if isinstance(m, _TapConv))
    flag = TModel(dict(CFG, g_s=dict(GS, region_candidates=False)))
    assert flag.g_s.up3_t.grand and flag.g_s.pred3.c2.grand


@pytest.fixture(scope="module")
def jax_pair():
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
    return model, params, tm.eval()


def test_region_synthesis_matches_jax(jax_pair):
    """Region g_s on the same latents and k: every level's candidate keys
    (SENTINEL where not covered) and the decoded keys exactly equal;
    level-0 logits at rtol 1e-3, atol 1e-4."""
    _, params, tm = jax_pair
    rng = np.random.default_rng(4)
    parts = []
    for b, n in enumerate((60, 45)):
        u = np.unique(rng.integers(0, 6, (n, 3)), axis=0)
        parts.append(JC.morton_encode_np(u) | (np.int64(b) << JC.BATCH_SHIFT))
    y_keys = np.sort(np.concatenate(parts))
    ny = len(y_keys)
    ycap = _bucket(ny, lo=128)
    y_keys = np.concatenate([y_keys, np.full(ycap - ny, JC.SENTINEL)])
    y_feats = np.zeros((ycap, 16), np.float32)
    y_feats[:ny] = np.round(rng.standard_normal((ny, 16)) * 4) / 4
    k = np.zeros((3, 8), np.int32)
    k[:, 0] = (2 * 55, 4 * 55, 9 * 55)
    k[:, 1] = (2 * 40, 5 * 40, 8 * 40)
    caps = tuple(_bucket(int(k[lv].sum())) for lv in range(3))
    jgs = JGS(max_batch=8, **GS)
    jx, jc, jl = jax.jit(lambda p, y, k: jgs.apply(
        {"params": p}, y, k, caps))(
        params["g_s"], JS.SparseTensor(keys=jnp.asarray(y_keys),
                                       feats=jnp.asarray(y_feats), stride=8),
        k)
    with torch.no_grad():
        tx, tc, tl = tm.g_s(TST(T(y_keys), T(y_feats), 8), T(k), caps)
    assert len(tc) == len(jc) == 3
    for a, b in zip(tc, jc):
        np.testing.assert_array_equal(N(a.keys), np.asarray(b.keys))
    np.testing.assert_allclose(N(tl[0]), np.asarray(jl[0]), 1e-3, 1e-4)
    np.testing.assert_array_equal(N(tx.keys), np.asarray(jx.keys))
    # region candidates: 8 per dilated parent, more than 8 per real parent
    assert tc[0].keys.shape[0] == 8 * int(3.0 * ycap)
    assert int(TC.key_is_valid(tc[0].keys).sum()) > 8 * ny


@pytest.fixture(scope="module")
def codecs(jax_pair):
    model, params, tm = jax_pair
    jc = JCodec(model, params)
    jc.update()
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


def test_region_codec_matches_jax(codecs, frame):
    """The codec on a region-mode model (nothing in the codec is region
    specific): the port's encode -> decode bit-exact, no conv preparing
    weights during the frame, the decoded count equal to the transmitted
    k and to JAX's, bpp within 1%, D1 and Y-PSNR within 0.1 dB."""
    jc, tc = codecs
    q = (0.5, 0.5)
    tc.debug, tc.debug_info = True, []
    with profiling.recording() as rec:
        tdata = tc.compress(frame, q, block_size=128)
        tout = tc.decompress(tdata)
    tc.debug = False
    assert rec.total("taps.prepared") == 0
    enc = [d for d in tc.debug_info if d["side"] == "enc"]
    dec = [d for d in tc.debug_info if d["side"] == "dec"]
    assert len(enc) == len(dec) == 2
    for e, d in zip(enc, dec):
        for key in ("y_keys", "z_sym", "y_idx", "y_sym", "scales", "means"):
            np.testing.assert_array_equal(e[key], d[key])
    tc.debug_info = []
    jdata = jc.compress(frame, q, block_size=128)
    jout = np.asarray(jc.decompress(jdata))
    assert tout.shape[0] == jout.shape[0]
    assert len(tdata) == pytest.approx(len(jdata), rel=0.01)
    tm_, jm_ = pc_metrics(frame, tout, 191), pc_metrics(frame, jout, 191)
    assert abs(tm_["sym_psnr_mse"] - jm_["sym_psnr_mse"]) <= 0.1
    assert abs(tm_["sym_y_psnr"] - jm_["sym_y_psnr"]) <= 0.1
