"""The port's serving surface against the JAX package's, on the CPU at
N=16: simulcast, streaming and the threaded group map against the
sequential path; the signaled color layers' payloads; the experiment
loader and the file CLI."""

import os
import sys
import threading

import numpy as np
import pytest
import torch
import yaml

import upcc_tpu  # noqa: F401
import jax
import jax.numpy as jnp
from flax import serialization as ser

from upcc_tpu.codec import bitstream as JB
from upcc_tpu.codec import color_affine as JCA
from upcc_tpu.codec import color_resid as JCR
from upcc_tpu.codec import raht as JRAHT
from upcc_tpu.codec.codec import Codec as JCodec
from upcc_tpu.data import ply as JPLY
from upcc_tpu.data.synthetic import surface_cloud
from upcc_tpu.models.unified import UnifiedModel as JModel
from upcc_tpu.ops.sparse import from_points
from upcc_tpu_torch import compress as cli
from upcc_tpu_torch.codec import color_affine as TCA
from upcc_tpu_torch.codec import color_resid as TCR
from upcc_tpu_torch.codec import io as TIO
from upcc_tpu_torch.codec import raht as TRAHT
from upcc_tpu_torch.codec.codec import Codec as TCodec
from upcc_tpu_torch.data import ply as TPLY
from upcc_tpu_torch.models.unified import UnifiedModel as TModel
from upcc_tpu_torch.weights import FLAGSHIP_CONFIG, params_from_jax

torch.set_num_threads(2)

MODEL = {
    "g_a": {"C_in": 4, "N1": 16, "N2": 16, "N3": 16, "N4": 16},
    "g_s": {"C_out": 3, "N1": 16, "N2": 16, "N3": 16, "N4": 16,
            "min_one_child": True},
    "entropy_model": {
        "C_bottleneck": 16, "C_hyper_bottleneck": 24,
        "quantization_mode": "ste", "inverse_rescaling": True,
        "quantization_offset": True,
    },
}
CFG = dict(MODEL, max_batch=8)


@pytest.fixture(scope="module")
def jax_params():
    model = JModel(CFG)
    rng = np.random.default_rng(0)
    xyz, rgb = surface_cloud(rng, extent=32, n_target=600)
    st = from_points(jnp.zeros(len(xyz), jnp.int32), jnp.asarray(xyz),
                     jnp.asarray(rgb), capacity=1024)
    params = jax.jit(model.init)({"params": jax.random.PRNGKey(0),
                                  "noise": jax.random.PRNGKey(1)}, st,
                                 jnp.full((1, 2), 0.5, jnp.float32),
                                 jnp.ones((1, 2), jnp.float32))["params"]
    return model, params


@pytest.fixture(scope="module")
def tc(jax_params):
    _, params = jax_params
    tm = TModel(CFG)
    tm.load_state_dict(params_from_jax(
        jax.tree_util.tree_map(np.asarray, params), tm))
    codec = TCodec(tm, device="cpu")
    codec.update()
    return codec


@pytest.fixture(scope="module")
def frame():
    rng = np.random.default_rng(7)
    parts = []
    for off in (0, 128):
        xyz, rgb = surface_cloud(rng, extent=64, n_target=1200)
        parts.append(np.concatenate(
            [(xyz + np.array([[off, 0, 0]])).astype(np.float32), rgb], 1))
    return np.concatenate(parts)


# -- simulcast, streaming, threads ---------------------------------------------

@pytest.mark.parametrize("geom", ["topk", "coded"])
def test_compress_multi_matches_separate_calls(tc, frame, geom):
    qs = [(0.2, 0.2), (0.5, 0.5), (1.0, 0.3)]
    multi = tc.compress_multi(frame, qs, block_size=64, geom=geom)
    assert multi == [tc.compress(frame, q, block_size=64, geom=geom)
                     for q in qs]
    assert len(set(multi)) == len(qs)  # q rides every block's header
    with pytest.raises(ValueError):
        tc.compress_multi(frame, qs, block_size=2048)
    with pytest.raises(ValueError):
        tc.compress(frame, qs[0], geom="octree")


def test_streams_match_sequential_calls(tc, frame):
    frames = [frame, frame[:1500], frame[700:], frame[::2]]
    q = (0.5, 0.5)
    seq = [tc.compress(f, q, block_size=64) for f in frames]
    assert list(tc.compress_stream(iter(frames), q, block_size=64,
                                   depth=2)) == seq
    assert list(tc.compress_stream(frames, q, block_size=64, depth=3,
                                   geom="coded")) == [
        tc.compress(f, q, block_size=64, geom="coded") for f in frames]
    recs = [tc.decompress(d) for d in seq]
    for a, b in zip(tc.decompress_stream(iter(seq), depth=2), recs):
        np.testing.assert_array_equal(a, b)
    assert list(tc.compress_stream([], q)) == []


def test_threaded_group_map_matches_sequential(tc, frame):
    """A frame of more than 63 blocks makes several encode and decode
    groups; they run on two worker threads, each under its own no_grad,
    and give the bytes and the points of the sequential path (which debug
    mode forces)."""
    rng = np.random.default_rng(11)
    parts = []
    for off in range(0, 5 * 64, 64):
        xyz, rgb = surface_cloud(rng, extent=64, n_target=700)
        parts.append(np.concatenate(
            [(xyz + np.array([[0, off, 0]])).astype(np.float32), rgb], 1))
    frame = np.concatenate(parts)
    groups, _ = tc._partition_blocks(frame, 16, 1.0)
    assert len(groups) > 1
    seen = []
    real = tc.model.ga_device

    def spy(*args, **kwargs):
        seen.append((threading.current_thread() is threading.main_thread(),
                     torch.is_grad_enabled()))
        return real(*args, **kwargs)

    tc.model.ga_device = spy
    try:
        threaded = tc.compress(frame, (0.5, 0.5), block_size=16)
    finally:
        del tc.model.ga_device
    assert len(seen) == len(groups)
    assert not any(main for main, _ in seen)
    assert not any(grad for _, grad in seen)
    tc.debug, tc.debug_info = True, []
    try:
        sequential = tc.compress(frame, (0.5, 0.5), block_size=16)
        rec_seq = tc.decompress(sequential)
    finally:
        tc.debug, tc.debug_info = False, []
    assert threaded == sequential
    np.testing.assert_array_equal(tc.decompress(threaded), rec_seq)
    assert not rec_seq.dtype.hasobject and np.isfinite(rec_seq).all()


def test_worker_exception_reaches_the_caller(tc, frame):
    def boom(*_):
        raise KeyError("worker failed")
    with pytest.raises(KeyError):
        tc._map_groups(boom, [1, 2, 3])
    with pytest.raises(KeyError):
        list(tc._stream([1, 2, 3], boom, depth=2))


# -- color layers ----------------------------------------------------------------

def _rec_and_source(seed):
    rng = np.random.default_rng(seed)
    xyz, rgb = surface_cloud(rng, extent=64, n_target=3000)
    src = np.concatenate([xyz.astype(np.float64), rgb], 1)
    rec = src[rng.random(len(src)) < 0.9].copy()
    bias = np.array([0.04, -0.03, 0.02])
    rec[:, 3:] = np.round(np.clip(
        rec[:, 3:] * 0.9 + bias + rng.normal(0, 0.03, (len(rec), 3)), 0, 1)
        * 255) / 255
    return rec.astype(np.float32), src


def test_color_affine_matches_jax():
    rec, src = _rec_and_source(1)
    tw, tgain = TCA.fit(rec, src)
    jw, jgain = JCA.fit(rec, src)
    assert tw is not None and tw.dtype == np.float32
    np.testing.assert_array_equal(tw, jw)
    assert tgain == jgain > 0
    np.testing.assert_array_equal(TCA.apply(rec[:, 3:6], tw),
                                  JCA.apply(rec[:, 3:6], jw))
    assert TCA.fit(rec[:0], src) == (None, 0.0)


def test_raht_payload_matches_jax():
    _, src = _rec_and_source(2)
    for qp in (22, 40):
        data = TRAHT.compress(src, qp=qp)
        assert data == JRAHT.compress(src, qp=qp)
        np.testing.assert_array_equal(TRAHT.decompress(data),
                                      JRAHT.decompress(data))
    with pytest.raises((ValueError, AssertionError)):
        TRAHT.decompress(b"XXXX" + data[4:])


@pytest.mark.parametrize("lam", [12800.0, 800.0])
def test_color_resid_payload_matches_jax(lam):
    rec, src = _rec_and_source(3)
    tp, tcorr, _ = TCR.fit(rec, src, lam)
    jp, jcorr, _ = JCR.fit(rec, src, lam)
    assert tp is not None and tp == jp
    np.testing.assert_array_equal(tcorr, jcorr)
    np.testing.assert_array_equal(TCR.apply(rec, tp), tcorr)
    np.testing.assert_array_equal(JCR.apply(rec, tp), tcorr)


def test_refit_colors_decode_equivalence(tc, frame):
    """The untrained model's colors are far off, so both layers engage:
    decompress(new) equals the returned reconstruction, geometry and the
    entropy-coded payloads are untouched, and a second refit is refused."""
    data = tc.compress(frame, (0.5, 0.5), block_size=64)
    base = tc.decompress(data)
    new, rec = tc.refit_colors(data, frame, resid_lam=12800.0)
    np.testing.assert_array_equal(tc.decompress(new), rec)
    np.testing.assert_array_equal(rec[:, :3], base[:, :3])
    old_b, new_b = JB.read_container(data)[0], JB.read_container(new)[0]
    assert new_b[0]["color_affine"] is not None
    assert new_b[0]["color_resid"] is not None
    for a, b in zip(old_b, new_b):
        for key in ("coord_bytes", "y_bytes", "z_bytes", "k", "q"):
            assert a[key] == b[key]
    # affine only, with the decode handed in
    aff_only, rec2 = tc.refit_colors(data, frame, rec=base)
    assert len(aff_only) == len(data) + 48
    np.testing.assert_array_equal(tc.decompress(aff_only), rec2)
    # nothing to signal: the container comes back unchanged
    same, rec3 = tc.refit_colors(data, frame, fit_affine=False)
    assert same == data
    np.testing.assert_array_equal(rec3, base)
    for layered in (new, aff_only):
        with pytest.raises(ValueError, match="already carries"):
            tc.refit_colors(layered, frame, resid_lam=12800.0)


def test_jax_container_with_color_layers_decodes_under_the_port(
        jax_params, tc, frame):
    """A container the JAX package wrote, with the affine and the residual
    layer attached by its refit_colors, decodes to the same array under the
    port (every kind of v6 side information is accepted)."""
    model, params = jax_params
    jc = JCodec(model, params)
    jc.update()
    jdata = jc.compress(frame, (0.5, 0.5), block_size=64)
    jnew, jrec = jc.refit_colors(jdata, frame, resid_lam=12800.0)
    blocks, _ = JB.read_container(jnew)
    assert blocks[0]["color_affine"] is not None
    assert blocks[0]["color_resid"] is not None
    np.testing.assert_array_equal(tc.decompress(jnew), np.asarray(jrec))
    # and the port's own refit of the same stream writes the same bytes
    tnew, trec = tc.refit_colors(jdata, frame, resid_lam=12800.0)
    assert tnew == jnew
    np.testing.assert_array_equal(trec, np.asarray(jrec))


# -- loader, PLY, CLI ------------------------------------------------------------

def test_ply_roundtrip_matches_jax(tmp_path):
    rng = np.random.default_rng(4)
    xyz, rgb = surface_cloud(rng, extent=64, n_target=500)
    rgb = np.round(rgb * 255) / 255
    for ascii_ in (False, True):
        tp, jp = tmp_path / f"t{ascii_}.ply", tmp_path / f"j{ascii_}.ply"
        TPLY.write_ply(str(tp), xyz, rgb, ascii=ascii_)
        JPLY.write_ply(str(jp), xyz, rgb, ascii=ascii_)
        assert tp.read_bytes() == jp.read_bytes()
        for reader in (TPLY.read_ply, JPLY.read_ply):
            rx, rc = reader(str(tp))
            np.testing.assert_array_equal(rx, xyz)
            np.testing.assert_allclose(rc, rgb, atol=1e-6)
    TPLY.write_ply(str(tmp_path / "geo.ply"), xyz)
    assert TPLY.read_ply(str(tmp_path / "geo.ply"))[1] is None


@pytest.fixture(scope="module")
def exp_dir(tmp_path_factory, jax_params):
    _, params = jax_params
    d = tmp_path_factory.mktemp("exp")
    (d / "config.yaml").write_text(yaml.safe_dump(
        {"model": MODEL, "batch_size": 2}))
    (d / "weights.msgpack").write_bytes(ser.to_bytes(params))
    return str(d)


def test_load_codec_reads_experiment(exp_dir, tc, frame, tmp_path):
    codec, cfg = TIO.load_codec(exp_dir, device="cpu")
    assert cfg["model"] == MODEL and codec.tables is not None
    assert codec.compress(frame, (0.5, 0.5), block_size=64) == \
        tc.compress(frame, (0.5, 0.5), block_size=64)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="cuda"):
            TIO.load_codec(exp_dir)
    empty = tmp_path / "none"
    empty.mkdir()
    (empty / "config.yaml").write_text(yaml.safe_dump({"model": MODEL}))
    with pytest.raises(FileNotFoundError):
        TIO.load_codec(str(empty), device="cpu")


def test_load_codec_without_yaml(monkeypatch, tmp_path):
    """Where the yaml package does not import, only the flagship
    experiment has a config (the built-in one); any other raises."""
    monkeypatch.setitem(sys.modules, "yaml", None)
    flagship = tmp_path / TIO.FLAGSHIP_EXPERIMENT
    other = tmp_path / "my_experiment"
    flagship.mkdir()
    other.mkdir()
    assert TIO._read_config(str(flagship) + os.sep)["model"] == FLAGSHIP_CONFIG
    with pytest.raises(RuntimeError, match="yaml"):
        TIO._read_config(str(other))


def test_weight_file_choice(tmp_path):
    """Full precision is preferred unless the bf16 snapshot is newer: by
    the recorded step when both sidecars exist, else by mtime with a
    one-minute window."""
    w, c = tmp_path / "weights.msgpack", tmp_path / "weights_bf16.msgpack"
    with pytest.raises(FileNotFoundError):
        TIO.pick_weights(str(tmp_path))
    c.write_bytes(b"c")
    assert TIO.pick_weights(str(tmp_path)) == str(c)
    w.write_bytes(b"w")
    assert TIO.pick_weights(str(tmp_path)) == str(w)
    os.utime(w, (1000, 1000))
    os.utime(c, (2000, 2000))
    assert TIO.pick_weights(str(tmp_path)) == str(c)
    os.utime(c, (1030, 1030))  # inside the same-save window
    assert TIO.pick_weights(str(tmp_path)) == str(w)
    (tmp_path / "weights.msgpack.meta.json").write_text('{"step": 5}')
    (tmp_path / "weights_bf16.msgpack.meta.json").write_text('{"step": 9}')
    assert TIO.pick_weights(str(tmp_path)) == str(c)
    (tmp_path / "weights.msgpack.meta.json").write_text('{"step": 9}')
    assert TIO.pick_weights(str(tmp_path)) == str(w)
    c.unlink()
    assert TIO.pick_weights(str(tmp_path)) == str(w)


def _write_cloud(path, seed, n=1200):
    xyz, rgb = surface_cloud(np.random.default_rng(seed), extent=64,
                             n_target=n)
    TPLY.write_ply(str(path), xyz, rgb)
    return xyz, rgb


def _run(*argv):
    cli.main([*argv, "--device", "cpu"])


def test_cli_roundtrip(exp_dir, tmp_path):
    xyz, _ = _write_cloud(tmp_path / "in.ply", 7, 1500)
    bit, rec = str(tmp_path / "out.upcc"), str(tmp_path / "rec.ply")
    _run("encode", str(tmp_path / "in.ply"), bit, "--experiment", exp_dir,
         "--q", "0.5", "0.5", "--block_size", "64")
    assert os.path.getsize(bit) > 0
    _run("decode", bit, rec, "--experiment", exp_dir)
    rx, rc = TPLY.read_ply(rec)
    assert len(rx) > 0 and rx.min() >= 0 and rx.max() < 64
    assert rc is not None and rc.shape == rx.shape


def test_cli_geom_coded_is_lossless(exp_dir, tmp_path):
    xyz, _ = _write_cloud(tmp_path / "in.ply", 8)
    bit, rec = str(tmp_path / "out.upcc"), str(tmp_path / "rec.ply")
    _run("encode", str(tmp_path / "in.ply"), bit, "--experiment", exp_dir,
         "--block_size", "64", "--geom", "coded", "--color_affine")
    _run("decode", bit, rec, "--experiment", exp_dir)
    rx, _ = TPLY.read_ply(rec)
    np.testing.assert_array_equal(
        np.unique(np.asarray(rx).astype(np.int64), axis=0),
        np.unique(np.asarray(xyz).astype(np.int64), axis=0))


def test_cli_ladder_and_many_inputs(exp_dir, tmp_path):
    """--ladder writes one .rN.upcc per rung, byte-identical to the single
    --q encode; several inputs stream into an output directory."""
    a, b = tmp_path / "a.ply", tmp_path / "b.ply"
    _write_cloud(a, 9)
    _write_cloud(b, 10)
    out = str(tmp_path / "lad.upcc")
    _run("encode", str(a), out, "--experiment", exp_dir, "--block_size",
         "64", "--ladder", "0.2", "0.2", "0.8", "0.8")
    for i, q in enumerate([(0.2, 0.2), (0.8, 0.8)]):
        p = str(tmp_path / f"s{i}.upcc")
        _run("encode", str(a), p, "--experiment", exp_dir, "--block_size",
             "64", "--q", str(q[0]), str(q[1]))
        with open(p, "rb") as f, open(str(tmp_path / f"lad.r{i}.upcc"),
                                      "rb") as g:
            assert f.read() == g.read()
    outdir = tmp_path / "many"
    _run("encode", str(a), str(b), str(outdir), "--experiment", exp_dir,
         "--block_size", "64", "--q", "0.8", "0.8")
    with open(str(tmp_path / "s1.upcc"), "rb") as f:
        assert (outdir / "a.upcc").read_bytes() == f.read()
    recdir = tmp_path / "recs"
    _run("decode", str(outdir / "a.upcc"), str(outdir / "b.upcc"),
         str(recdir), "--experiment", exp_dir)
    assert len(TPLY.read_ply(str(recdir / "b.ply"))[0]) > 0


@pytest.mark.parametrize("argv", [
    ["encode", "x/frame.ply", "y/frame.ply", "out"],          # duplicate stems
    ["encode", "a.ply", "o.upcc", "--ladder", "0.2", "0.2", "0.8"],
    ["decode", "a.upcc", "o.ply", "--ladder", "0.5", "0.5"],
    ["encode", "a.ply", "o.upcc", "--ladder", "0.5", "0.5", "--color_affine"],
    ["encode", "a.ply", "o.upcc", "--geom", "octree"],
])
def test_cli_rejects_bad_arguments(tmp_path, monkeypatch, argv):
    monkeypatch.chdir(tmp_path)
    with pytest.raises(SystemExit):
        cli.main(argv)
    assert not os.path.exists("out")
