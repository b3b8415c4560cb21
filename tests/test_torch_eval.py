"""The PyTorch port's evaluation path against the JAX package's, on the
CPU: synthetic test frames, D1/D2/YUV metrics, PCQM, Bjøntegaard deltas,
renders, the external anchor hooks (with ``subprocess.run`` faked, since
no MPEG binary is installed) and the evaluation driver on a tiny model.
The metric code is the same numpy in both packages, so its results are
compared for equality; the driver's RD row, which runs two codecs, within
1% bpp and 0.1 dB."""

import csv
import os
import sys
import types

import numpy as np
import pytest
import torch
import yaml

import upcc_tpu  # noqa: F401
import jax
import jax.numpy as jnp
from flax import serialization as ser

from upcc_tpu.data import synthetic as JSYN
from upcc_tpu.data.ply import write_ply as j_write_ply
from upcc_tpu.eval import anchors as JA
from upcc_tpu.eval import bjontegaard as JBD
from upcc_tpu.eval import metrics as JM
from upcc_tpu.eval import pcqm as JP
from upcc_tpu.eval import render as JR
from upcc_tpu.models.unified import UnifiedModel as JModel
from upcc_tpu.ops.sparse import from_points
from upcc_tpu_torch import evaluate as TE
from upcc_tpu_torch import eval as TEVAL
from upcc_tpu_torch.data import synthetic as TSYN
from upcc_tpu_torch.eval import anchors as TA
from upcc_tpu_torch.eval import bjontegaard as TBD
from upcc_tpu_torch.eval import metrics as TM
from upcc_tpu_torch.eval import pcqm as TP
from upcc_tpu_torch.eval import render as TR

torch.set_num_threads(2)
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import evaluate as JE  # noqa: E402  (the root driver, the JAX reference)


def _equal_dicts(a, b):
    assert list(a) == list(b)
    for k in a:
        assert a[k] == b[k] or (np.isnan(a[k]) and np.isnan(b[k])), k


# -- synthetic frames --------------------------------------------------------

@pytest.mark.parametrize("seed,extent,n_target", [(0, 128, 3000),
                                                  (5, 64, None),
                                                  (9, 256, 20_000)])
def test_scan_like_cloud_byte_identical(seed, extent, n_target):
    got = TSYN.scan_like_cloud(np.random.default_rng(seed), extent=extent,
                               n_target=n_target)
    ref = JSYN.scan_like_cloud(np.random.default_rng(seed), extent=extent,
                               n_target=n_target)
    for a, b in zip(got, ref):
        assert a.dtype == b.dtype and a.tobytes() == b.tobytes()


@pytest.mark.parametrize("capacity", [None, 5000, 1500])
def test_batch_of_cubes_byte_identical(capacity):
    got = TSYN.batch_of_cubes(np.random.default_rng(3), 3, extent=32,
                              n_per=700, capacity=capacity)
    ref = JSYN.batch_of_cubes(np.random.default_rng(3), 3, extent=32,
                              n_per=700, capacity=capacity)
    for a, b in zip(got, ref):
        assert a.dtype == b.dtype and a.tobytes() == b.tobytes()


# -- metrics -----------------------------------------------------------------

@pytest.fixture(scope="module")
def clouds():
    """A source frame and distorted reconstructions: on the voxel grid
    with most voxels kept (the exact-voxel path runs), off the grid, and
    on the grid with few voxels shared (the full KD query runs)."""
    rng = np.random.default_rng(11)
    xyz, rgb = JSYN.scan_like_cloud(rng, extent=128, n_target=3000)
    src = np.concatenate([xyz, rgb], axis=1).astype(np.float64)
    r = np.random.default_rng(1)
    grid = src[r.random(len(src)) > 0.1].copy()
    grid[:40, :3] += 1
    grid[:, 3:] = np.round(np.clip(grid[:, 3:] + r.normal(0, 0.03, (len(grid),
                                                                 3)), 0, 1)
                           * 255) / 255
    off = grid.copy()
    off[:, :3] += r.normal(0, 0.4, (len(off), 3))
    sparse = src[r.random(len(src)) < 0.03].copy()
    sparse = np.concatenate([sparse, src[:400] + [2, 0, 0, 0, 0, 0]])
    return src, {"grid": grid, "off grid": off, "few hits": sparse}


@pytest.mark.parametrize("with_d2", [True, False])
@pytest.mark.parametrize("kind", ["grid", "off grid", "few hits"])
def test_pc_metrics_match_jax(clouds, kind, with_d2):
    src, recs = clouds
    rec = recs[kind]
    got = TM.pc_metrics(src, rec, 127, with_d2=with_d2)
    _equal_dicts(got, JM.pc_metrics(src, rec, 127, with_d2=with_d2))
    assert ("sym_d2_psnr" in got) == with_d2


def test_exact_voxel_path_matches_jax(clouds, monkeypatch):
    """The exact-voxel fast path is taken on integer grids and refused
    off the grid and with duplicate voxels, in both packages."""
    src, recs = clouds
    for pts in (src[:, :3], recs["off grid"][:, :3], recs["grid"][:, :3],
                np.concatenate([src[:5, :3], src[:5, :3]]), -src[:, :3]):
        a, b = TM._exact_index(pts), JM._exact_index(pts)
        assert (a is None) == (b is None)
        if a is not None:
            np.testing.assert_array_equal(a[0], b[0])
            np.testing.assert_array_equal(a[1], b[1])
    assert TM._exact_index(src[:, :3]) is not None
    assert TM._exact_index(recs["off grid"][:, :3]) is None
    # the fast path and the full query agree (and equal JAX's)
    tree = TM._LazyTree(src[:, :3])
    rec = recs["grid"]
    fast = TM._directional(rec[:, :3], rec[:, 3:], src[:, :3], src[:, 3:],
                           tree, 127)
    ref = JM._directional(rec[:, :3], rec[:, 3:], src[:, :3], src[:, 3:],
                          JM._LazyTree(src[:, :3]), 127)
    _equal_dicts(fast, ref)
    monkeypatch.setattr(TM, "_exact_index", lambda pts: None)
    full = TM._directional(rec[:, :3], rec[:, 3:], src[:, :3], src[:, 3:],
                           tree, 127)
    for k in fast:
        assert fast[k] == pytest.approx(full[k], rel=1e-12, abs=1e-15), k


def test_prepared_source_and_class_wrapper_match_jax(clouds):
    src, recs = clouds
    prep = TM.PreparedSource(src)
    jprep = JM.PreparedSource(src)
    np.testing.assert_array_equal(prep.normals, jprep.normals)
    for rec in recs.values():
        _equal_dicts(TM.pc_metrics(prep, rec, 127),
                     JM.pc_metrics(jprep, rec, 127))
    lazy = TM.PreparedSource(src, with_d2=False)
    assert lazy.normals is None
    np.testing.assert_array_equal(lazy.ensure_normals(), prep.normals)
    rep, _ = TM.PointCloudMetric(src, recs["grid"], 127) \
        .compute_pointcloud_metrics()
    jrep, _ = JM.PointCloudMetric(src, recs["grid"], 127) \
        .compute_pointcloud_metrics()
    _equal_dicts(rep, jrep)


@pytest.mark.parametrize("k", [16, 5])
def test_estimate_normals_match_jax(clouds, k):
    pts = clouds[0][:, :3]
    np.testing.assert_array_equal(TM.estimate_normals(pts, k=k),
                                  JM.estimate_normals(pts, k=k))


def test_eval_package_exports_match_jax():
    import upcc_tpu.eval as JEVAL
    names = ("pc_metrics", "PointCloudMetric", "estimate_normals", "bd_rate",
             "bd_psnr", "BjontegaardModel")
    for name in names:
        assert hasattr(TEVAL, name) and hasattr(JEVAL, name)
        assert getattr(TEVAL, name).__module__.startswith("upcc_tpu_torch.")


# -- PCQM --------------------------------------------------------------------

def test_pcqm_parts_match_jax(clouds):
    src, recs = clouds
    np.testing.assert_array_equal(TP.srgb_to_lab(src[:, 3:]),
                                  JP.srgb_to_lab(src[:, 3:]))
    np.testing.assert_array_equal(TP.mean_curvature(src[:, :3], k=12),
                                  JP.mean_curvature(src[:, :3], k=12))
    assert TP.DEFAULT_WEIGHTS == JP.DEFAULT_WEIGHTS
    assert TP.FEATURE_NAMES == JP.FEATURE_NAMES
    _equal_dicts(TP.pcqm_features(src, recs["grid"]),
                 JP.pcqm_features(src, recs["grid"]))


@pytest.mark.parametrize("max_points", [None, 1500])
@pytest.mark.parametrize("prepared", [False, True])
def test_pcqm_matches_jax(clouds, max_points, prepared):
    src, recs = clouds
    tref = TP.PreparedRef(src, max_points=max_points) if prepared else src
    jref = JP.PreparedRef(src, max_points=max_points) if prepared else src
    for rec in (recs["grid"], recs["off grid"], src):
        got = TP.pcqm(tref, rec, max_points=max_points)
        assert got == JP.pcqm(jref, rec, max_points=max_points)
    assert TP.pcqm(tref, src, max_points=max_points) < 1e-9
    if prepared:
        with pytest.raises(ValueError, match="PreparedRef"):
            TP.pcqm(tref, src, knn=10, max_points=max_points)


# -- Bjøntegaard deltas --------------------------------------------------------

CURVES = [
    ([0.1, 0.2, 0.4, 0.8], [30.0, 33.0, 35.5, 37.0],
     [0.12, 0.25, 0.5, 0.9], [30.5, 33.8, 36.1, 37.9]),
    # a saturating curve with repeated qualities and rates
    ([0.1, 0.2, 0.2, 0.4, 0.8], [30.0, 34.0, 34.0, 34.0, 34.0],
     [0.1, 0.3, 0.6], [29.0, 33.0, 35.0]),
    # no overlap in rate
    ([0.1, 0.2], [30.0, 31.0], [1.0, 2.0], [35.0, 36.0]),
]


@pytest.mark.parametrize("curve", range(len(CURVES)))
def test_bjontegaard_matches_jax(curve):
    ra, qa, rb, qb = CURVES[curve]
    for fn in ("bd_rate", "bd_psnr"):
        for mo in (0.0, 0.5):
            got = getattr(TBD, fn)(ra, qa, rb, qb, min_overlap=mo)
            ref = getattr(JBD, fn)(ra, qa, rb, qb, min_overlap=mo)
            assert got == ref or (np.isnan(got) and np.isnan(ref))
    assert TBD.rate_overlap(ra, rb) == JBD.rate_overlap(ra, rb)
    assert TBD.quality_overlap(qa, qb) == JBD.quality_overlap(qa, qb)
    tm, jm = TBD.BjontegaardModel(ra, qa), JBD.BjontegaardModel(ra, qa)
    rates = np.linspace(min(ra), max(ra), 7)
    np.testing.assert_array_equal(tm.quality_at(rates), jm.quality_at(rates))
    quals = np.linspace(min(qa), max(qa), 7)
    np.testing.assert_array_equal(tm.rate_at(quals), jm.rate_at(quals))


def test_bjontegaard_degenerate_curve_matches_jax():
    tm = TBD.BjontegaardModel([0.5, 0.5, 0.5], [30.0, 31.0, 32.0])
    jm = JBD.BjontegaardModel([0.5, 0.5, 0.5], [30.0, 31.0, 32.0])
    np.testing.assert_array_equal(tm.quality_at([0.3, 0.7]),
                                  jm.quality_at([0.3, 0.7]))


# -- renders -----------------------------------------------------------------

def test_render_stack_matches_jax(clouds, tmp_path):
    src = clouds[0]
    got = TR.render_pointcloud(src, size=64)
    np.testing.assert_array_equal(got, JR.render_pointcloud(src, size=64))
    assert got.shape == (6, 64, 64, 3)
    np.testing.assert_array_equal(
        TR.render_view(src[:, :3], src[:, 3:], 1, -1, size=48, splat=2),
        JR.render_view(src[:, :3], src[:, 3:], 1, -1, size=48, splat=2))
    prefix = str(tmp_path / "r" / "frame")
    TR.render_pointcloud(src, path_prefix=prefix, size=32)
    paths = [f"{prefix}_view{i}.png" for i in range(6)]
    assert all(os.path.exists(p) for p in paths)
    out = TR.crop_zoom_compose(paths[:2], [(0, 0, 8, 8), (4, 4, 8, 8)],
                               str(tmp_path / "sheet.png"))
    assert os.path.exists(out)


# -- anchors -----------------------------------------------------------------

@pytest.fixture
def cloud():
    xyz, rgb = TSYN.surface_cloud(np.random.default_rng(0), extent=64,
                                  n_target=800)
    return np.concatenate([xyz.astype(np.float64), rgb], axis=1)


def test_anchor_binaries_match_jax_defaults():
    for name in ("GPCC_BIN", "VPCC_BIN", "PCQM_BIN", "ITDLPCC_DIR"):
        assert getattr(TA, name) == getattr(JA, name)
    assert bool(TA.has_gpcc()) == bool(JA.has_gpcc())


def test_gpcc_missing_binary_raises(monkeypatch, cloud):
    monkeypatch.setattr(TA, "GPCC_BIN", "/nonexistent/tmc3")
    assert not TA.has_gpcc()
    with pytest.raises(FileNotFoundError):
        TA.compress_gpcc(cloud)
    monkeypatch.setattr(TA, "ITDLPCC_DIR", "/nonexistent/itdlpcc")
    with pytest.raises(FileNotFoundError):
        TA.compress_itdlpcc(cloud)


def _fake_gpcc(calls, cloud):
    def fake_run(cmd, check=False, capture_output=False, **kw):
        calls.append(cmd)
        opts = {c.split("=", 1)[0]: c.split("=", 1)[1]
                for c in cmd if "=" in c}
        if opts.get("--mode") == "0":
            with open(opts["--compressedStreamPath"], "wb") as f:
                f.write(b"\x00" * 100)
        else:
            j_write_ply(opts["--reconstructedDataPath"], cloud[:, :3],
                        cloud[:, 3:6])
        return types.SimpleNamespace(returncode=0, stdout="", stderr="")
    return fake_run


def test_gpcc_command_and_parse_match_jax(monkeypatch, tmp_path, cloud):
    got, ref = [], []
    for mod, calls, sub in ((TA, got, "t"), (JA, ref, "j")):
        monkeypatch.setattr(mod, "has_gpcc", lambda: True)
        monkeypatch.setattr(mod.subprocess, "run", _fake_gpcc(calls, cloud))
        d = tmp_path / sub
        d.mkdir()
        out, bpp, t_enc, t_dec = mod.compress_gpcc(cloud, q_a=34, q_g=0.75,
                                                   tmp_dir=str(d))
        assert out.shape == (len(cloud), 6)
        assert abs(bpp - 100 * 8 / len(cloud)) < 1e-9
        assert t_enc >= 0 and t_dec >= 0
    strip = [[c.replace(str(tmp_path / "t"), "").replace(
        str(tmp_path / "j"), "") for c in cmd] for cmd in got + ref]
    assert strip[:2] == strip[2:]
    assert "--qp=34" in got[0] and "--positionQuantizationScale=0.75" in got[0]


def test_pcqm_binary_parse(monkeypatch, tmp_path, cloud):
    captured = {}

    def fake_run(cmd, capture_output=False, text=False, **kw):
        captured["cmd"] = cmd
        return types.SimpleNamespace(returncode=0,
                                     stdout="...\nPCQM : 0.004625\n",
                                     stderr="")

    monkeypatch.setattr(TA.os.path, "exists",
                        lambda p: True if p == TA.PCQM_BIN
                        else os.path.lexists(p))
    monkeypatch.setattr(TA.subprocess, "run", fake_run)
    val, src = TA.pcqm(cloud, cloud, tmp_dir=str(tmp_path))
    assert src == "binary" and abs(val - 0.004625) < 1e-12
    cmd = captured["cmd"]
    assert cmd[0] == TA.PCQM_BIN and cmd[3:] == ["-fq", "-r 0.004", "-knn 20",
                                                 "-rx 2.0"]


def test_pcqm_falls_back_to_native_like_jax(monkeypatch, cloud):
    monkeypatch.setattr(TA, "PCQM_BIN", "/nonexistent/PCQM")
    monkeypatch.setattr(JA, "PCQM_BIN", "/nonexistent/PCQM")
    noisy = cloud.copy()
    noisy[:, 3:] = np.clip(noisy[:, 3:] + 0.05, 0, 1)
    got = TA.pcqm(cloud, noisy, max_points=500)
    assert got[1] == "native" and got == JA.pcqm(cloud, noisy, max_points=500)


def test_vpcc_and_itdlpcc_commands(monkeypatch, tmp_path, cloud):
    calls = []

    def fake_run(cmd, check=False, capture_output=False, **kw):
        calls.append(cmd)
        if "--rateIndex=3" in cmd:
            opts = {c.split("=", 1)[0]: c.split("=", 1)[1]
                    for c in cmd if "=" in c}
            with open(opts["--compressedStreamPath"], "wb") as f:
                f.write(b"\x00" * 50)
        else:
            with open(os.path.join(cmd[3], "stream.gz"), "wb") as f:
                f.write(b"\x00" * 25)
        return types.SimpleNamespace(returncode=0, stdout="", stderr="")

    monkeypatch.setattr(TA.shutil, "which", lambda p: p)
    monkeypatch.setattr(TA.subprocess, "run", fake_run)
    binf, bpp, _ = TA.compress_vpcc(cloud, rate_preset=3,
                                    tmp_dir=str(tmp_path))
    assert calls[0][0] == TA.VPCC_BIN and os.path.exists(binf)
    assert abs(bpp - 50 * 8 / len(cloud)) < 1e-9
    repo = tmp_path / "itdlpcc"
    (repo / "src").mkdir(parents=True)
    (repo / "src" / "compress.py").write_text("")
    monkeypatch.setattr(TA, "ITDLPCC_DIR", str(repo))
    work = tmp_path / "work"
    work.mkdir()
    outs, bpp, _ = TA.compress_itdlpcc(cloud, rate=2, tmp_dir=str(work))
    assert calls[1][1].endswith("compress.py")
    assert calls[1][-1].endswith(os.path.join("models", "joint", "R2"))
    assert len(outs) == 1 and abs(bpp - 25 * 8 / len(cloud)) < 1e-9


# -- the driver --------------------------------------------------------------

MODEL = {
    "entropy_model": {"C_bottleneck": 16, "C_hyper_bottleneck": 24,
                      "quantization_mode": "ste", "inverse_rescaling": True,
                      "quantization_offset": True},
    "g_a": {"C_in": 4, "N1": 16, "N2": 16, "N3": 16, "N4": 16},
    "g_s": {"C_out": 3, "N1": 16, "N2": 16, "N3": 16, "N4": 16,
            "min_one_child": True},
}
MINI = {"mini": {"resolution": 63, "block_size": 64, "frame": 0}}


def _tiny_frame(sequence, spec, data_root="./data/raw", allow_synthetic=True):
    xyz, rgb = JSYN.surface_cloud(np.random.default_rng(0), extent=64,
                                  n_target=800)
    return np.concatenate([xyz.astype(np.float32), rgb], 1), True


@pytest.fixture(scope="module")
def weights_bytes():
    """A JAX init of the tiny model, as a flax msgpack weight file: both
    drivers load the same parameters."""
    model = JModel(dict(MODEL, max_batch=8))
    xyz, rgb = JSYN.surface_cloud(np.random.default_rng(0), extent=32,
                                  n_target=600)
    st = from_points(jnp.zeros(len(xyz), jnp.int32), jnp.asarray(xyz),
                     jnp.asarray(rgb), capacity=1024)
    params = jax.jit(model.init)({"params": jax.random.PRNGKey(0),
                                  "noise": jax.random.PRNGKey(1)}, st,
                                 jnp.full((1, 2), 0.5, jnp.float32),
                                 jnp.ones((1, 2), jnp.float32))["params"]
    return ser.to_bytes(params)


def _experiment(results, name, weights_bytes):
    d = results / name
    d.mkdir(parents=True)
    (d / "config.yaml").write_text(yaml.safe_dump(
        {"batch_size": 1, "model": MODEL,
         "q_map": {"lambda_A_min": 0, "lambda_A_max": 12800,
                   "mode": "quadratic"}}))
    (d / "weights.msgpack").write_bytes(weights_bytes)
    return d


def _read(path):
    with open(path, newline="") as f:
        rows = list(csv.reader(f))
    return rows[0], rows[1:]


@pytest.fixture(scope="module")
def driver_rows(tmp_path_factory, weights_bytes):
    """The JAX driver and the port's, the same tiny sweep (2 x 2 q's,
    color refit, metrics and native PCQM) on the same frame and weights."""
    mp = pytest.MonkeyPatch()
    out = {}
    try:
        for name, mod in (("jax", JE), ("port", TE)):
            mp.setattr(mod, "TEST_SET", dict(MINI))
            mp.setattr(mod, "load_frame", _tiny_frame)
            results = tmp_path_factory.mktemp(name) / "results"
            _experiment(results, "tiny", weights_bytes)
            kw = {"device": "cpu"} if mod is TE else {}
            mod.run_testset(["tiny"], q_steps=2, results_path=str(results),
                            with_renders=False, pcqm_max_points=500, **kw)
            out[name] = _read(results / "tiny" / "test.csv")
    finally:
        mp.undo()
    return out


def test_driver_columns_match_jax_and_committed_csv(driver_rows):
    header, rows = driver_rows["port"]
    assert header == driver_rows["jax"][0]
    committed, _ = _read(os.path.join(ROOT, "results", "CVPR_inverse_scaling",
                                      "test.csv"))
    assert header == committed and len(header) == 23
    assert len(rows) == 4


def test_driver_rd_rows_match_jax(driver_rows):
    """Per q: the same operating point and flags, bpp within 1%, D1 and
    Y-PSNR within 0.1 dB of the JAX driver's row."""
    header, rows = driver_rows["port"]
    _, jrows = driver_rows["jax"]
    col = {c: i for i, c in enumerate(header)}
    for r, j in zip(rows, jrows):
        for key in ("sequence", "frameIdx", "q_g", "q_a", "num_points",
                    "synthetic"):
            assert r[col[key]] == j[col[key]], key
        assert float(r[col["bpp"]]) == pytest.approx(float(j[col["bpp"]]),
                                                     rel=0.01)
        for key in ("sym_psnr_mse", "sym_y_psnr"):
            assert abs(float(r[col[key]]) - float(j[col[key]])) <= 0.1, key
        assert np.isfinite(float(r[col["pcqm"]]))
        assert r[col["synthetic"]] == "1"


@pytest.fixture
def tiny_exp(tmp_path, weights_bytes, monkeypatch):
    monkeypatch.setattr(TE, "TEST_SET", dict(MINI))
    monkeypatch.setattr(TE, "load_frame", _tiny_frame)
    results = tmp_path / "results"
    for name in ("a", "b"):
        _experiment(results, name, weights_bytes)
    return results


@pytest.mark.parametrize("append", [False, True])
def test_driver_append_is_per_experiment(tiny_exp, append):
    """Two experiments in one call: with append=False each rewrites its
    own test.csv (the root driver's flag, once set by the first
    experiment's flush, would merge the second); with append=True each
    keeps its other sequences' rows."""
    for name in ("a", "b"):
        TE.write_testset_csv(str(tiny_exp / name / "test.csv"),
                             [{"sequence": "old", "q_g": 0.0, "bpp": 1.0}])
    TE.run_testset(["a", "b"], q_steps=1, results_path=str(tiny_exp),
                   with_metrics=False, with_renders=False, append=append,
                   device="cpu")
    for name in ("a", "b"):
        _, rows = _read(tiny_exp / name / "test.csv")
        seqs = sorted(r[0] for r in rows)
        assert seqs == (["mini", "old"] if append else ["mini"]), name


def test_driver_worker_error_reaches_the_caller(tiny_exp, monkeypatch):
    def boom(*a, **k):
        raise RuntimeError("metric backend exploded")
    monkeypatch.setattr(TM, "pc_metrics", boom)
    with pytest.raises(RuntimeError, match="metric backend exploded"):
        TE.run_testset(["a"], q_steps=2, results_path=str(tiny_exp),
                       with_renders=False, device="cpu")


def test_driver_renders_corners_and_coded_sibling(tiny_exp):
    """geom="coded" writes the sibling experiment <exp>_coded; renders are
    made at the corner qualities only."""
    TE.run_testset(["a"], q_steps=2, results_path=str(tiny_exp),
                   geom="coded", with_metrics=False, device="cpu",
                   color_resid=False)
    _, rows = _read(tiny_exp / "a_coded" / "test.csv")
    assert len(rows) == 4
    renders = sorted(os.listdir(tiny_exp / "a_coded" / "renders"))
    assert renders == sorted(f"mini_q{q}_{q}_view{i}.png"
                             for q in ("0.00", "1.00") for i in range(6))


def test_driver_command_line(tiny_exp, monkeypatch):
    monkeypatch.chdir(tiny_exp.parent)
    TE.main(["--experiments", "b", "--q_steps", "1", "--device", "cpu",
             "--no_pcqm", "--no_renders", "--sequences", "mini"])
    header, rows = _read(tiny_exp / "b" / "test.csv")
    assert len(rows) == 1 and "sym_d2_psnr" in header
    assert "pcqm" not in header


def test_anchor_sweep_matches_jax(tmp_path, monkeypatch):
    """gpcc_native on the port's codec/raht.py: the same bytes and metrics
    as the JAX driver's sweep."""
    def frame(sequence, spec, data_root="./data/raw", allow_synthetic=True):
        xyz, rgb = JSYN.scan_like_cloud(np.random.default_rng(0), extent=64,
                                        n_target=3000)
        return np.concatenate([xyz.astype(np.float32), rgb], 1), True
    out = {}
    for name, mod in (("jax", JE), ("port", TE)):
        monkeypatch.setattr(mod, "TEST_SET", {
            "loot": {"resolution": 63, "block_size": 64, "frame": 0}})
        monkeypatch.setitem(mod.ANCHOR_GRIDS, "gpcc_native",
                            {"q_as": [22, 40], "q_gs": [1.0, 0.5]})
        monkeypatch.setattr(mod, "load_frame", frame)
        mod.run_testset(["gpcc_native"], results_path=str(tmp_path / name),
                        pcqm_max_points=2000)
        out[name] = _read(tmp_path / name / "gpcc_native" / "test.csv")
    (h, rows), (jh, jrows) = out["port"], out["jax"]
    assert h == jh and len(rows) == 4
    timing = {h.index("t_compress"), h.index("t_decompress")}
    for r, j in zip(rows, jrows):
        assert [v for i, v in enumerate(r) if i not in timing] == \
            [v for i, v in enumerate(j) if i not in timing]


def test_test_set_and_frame_names_match_jax(tmp_path):
    assert TE.TEST_SET == JE.TEST_SET and TE.ANCHOR_GRIDS == JE.ANCHOR_GRIDS
    for seq, spec in TE.TEST_SET.items():
        assert TE.frame_filename(seq, spec) == JE.frame_filename(seq, spec)
        assert TE.find_frame_path(seq, spec, str(tmp_path)) is None
    spec = TE.TEST_SET["longdress"]
    path = tmp_path / "8iVFB" / TE.frame_filename("longdress", spec)
    path.parent.mkdir()
    xyz, rgb = JSYN.surface_cloud(np.random.default_rng(2), extent=64,
                                  n_target=500)
    j_write_ply(str(path), xyz, rgb)
    assert TE.find_frame_path("longdress", spec, str(tmp_path)) == str(path)
    got, syn = TE.load_frame("longdress", spec, str(tmp_path))
    ref, jsyn = JE.load_frame("longdress", spec, str(tmp_path))
    assert not syn and not jsyn
    np.testing.assert_array_equal(got, ref)


def test_synthetic_fallback_matches_jax(tmp_path, monkeypatch):
    """Without a PLY both drivers build the same scan-like frame from the
    sequence's name (at a reduced point count here) and flag it."""
    for mod in (TSYN, JSYN):
        real = mod.scan_like_cloud
        monkeypatch.setattr(mod, "scan_like_cloud",
                            lambda rng, extent, n_target, real=real:
                            real(rng, extent=extent, n_target=2000))
    for seq in ("longdress", "dancer"):
        spec = TE.TEST_SET[seq]
        got, syn = TE.load_frame(seq, spec, str(tmp_path))
        ref, jsyn = JE.load_frame(seq, spec, str(tmp_path))
        assert syn and jsyn and got.dtype == ref.dtype
        assert got.tobytes() == ref.tobytes()
        with pytest.raises(FileNotFoundError):
            TE.load_frame(seq, spec, str(tmp_path), allow_synthetic=False)


def test_write_testset_csv_matches_jax(tmp_path):
    first = [{"sequence": "loot", "q_g": 1.0, "bpp": 0.5},
             {"sequence": "dancer", "q_g": 1.0, "bpp": 0.7}]
    second = [{"sequence": "dancer", "q_g": 0.5, "bpp": 0.9, "pcqm": 0.1}]
    for mod, name in ((TE, "t.csv"), (JE, "j.csv")):
        path = str(tmp_path / name)
        assert mod.write_testset_csv(path, first) == 0
        assert mod.write_testset_csv(path, second, append=True) == 1
    assert (tmp_path / "t.csv").read_bytes() == \
        (tmp_path / "j.csv").read_bytes()


@pytest.mark.parametrize("mode", ["native", "external"])
def test_make_pcqm_matches_jax(monkeypatch, cloud, mode):
    monkeypatch.setattr(TA, "PCQM_BIN", "/nonexistent/PCQM")
    monkeypatch.setattr(JA, "PCQM_BIN", "/nonexistent/PCQM")
    noisy = cloud.copy()
    noisy[:, 3:] = np.clip(noisy[:, 3:] - 0.04, 0, 1)
    tf, jf = TE.make_pcqm(mode, 500), JE.make_pcqm(mode, 500)
    assert tf(tf.prepare(cloud), noisy) == jf(jf.prepare(cloud), noisy)


@pytest.mark.parametrize("mode", ["quadratic", "exponential"])
def test_lambda_a_schedule(mode):
    """The residual layer's weight per q_a, as the root driver computes
    it from the experiment's q_map."""
    fn = TE.lambda_a_schedule({"q_map": {"lambda_A_min": 0,
                                         "lambda_A_max": 12800,
                                         "mode": mode}})
    assert fn(0.0) == 0.0
    # quadratic: qa^2 (max - min) + min; exponential: 2^(qa log2(max +
    # min)) + min - 1
    top = {"quadratic": 12800.0, "exponential": 12799.0}[mode]
    assert fn(1.0) == pytest.approx(top)
    assert 0.0 < fn(0.5) < 12800.0
    assert TE.lambda_a_schedule(None)(0.5) == 0.25 * 12800.0
