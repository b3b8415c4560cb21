"""The port's training-data modules against the JAX package's, on the CPU:
the QFunc lambda map and its corner rate, the frame-range DSL, cube
slicing, collation, the numpy augmentations, the synthetic dataset builder,
StaticDataset and the trainer's batch packer (byte-identical where the
logic is numpy)."""

import types

import numpy as np
import pytest
import torch

import upcc_tpu  # noqa: F401
import jax
import jax.numpy as jnp

from upcc_tpu.data import dataset as JD
from upcc_tpu.data import make_synth as JMS
from upcc_tpu.data import transform as JT
from upcc_tpu.data.q_func import QFunc as JQ
from upcc_tpu.training.trainer import Training as JTraining

from upcc_tpu_torch.data import dataset as TD
from upcc_tpu_torch.data import make_synth as TMS
from upcc_tpu_torch.data import transform as TT
from upcc_tpu_torch.data.q_func import QFunc as TQ
from upcc_tpu_torch.training.trainer import Training as TTraining

torch.set_num_threads(2)

QCFG = {"lambda_A_min": 0, "lambda_A_max": 12800, "lambda_G_min": 0,
        "lambda_G_max": 200, "corner_p": 0.15}


def _frame(seed=0, n=3000, extent=200):
    rng = np.random.default_rng(seed)
    xyz = rng.integers(0, extent, (n, 3)).astype(np.float64)
    rgb = rng.random((n, 3)).astype(np.float32)
    return xyz, rgb


@pytest.mark.parametrize("mode", ["quadratic", "exponential"])
def test_qfunc_scale_matches_jax(mode):
    cfg = dict(QCFG, mode=mode, lambda_A_min=2, lambda_G_min=1)
    q = np.random.default_rng(0).random((50, 2)).astype(np.float32)
    ref = np.asarray(JQ(cfg).scale_q_vals(jnp.asarray(q)))
    got = TQ(cfg).scale_q_vals(torch.from_numpy(q)).numpy()
    np.testing.assert_allclose(got, ref, rtol=1e-6)


def test_qfunc_sample_corner_rate():
    """One q pair a step, broadcast to the batch; each component snaps to
    exactly 0 or 1 with probability corner_p, each corner equally often,
    as the JAX sampler does (same rate within 4 sigma of n draws)."""
    cfg = dict(QCFG, mode="quadratic")
    tq, jq = TQ(cfg), JQ(cfg)
    gen = torch.Generator().manual_seed(0)
    n = 3000
    got = torch.cat([tq.sample(gen, 1)[0] for _ in range(n)]).numpy()
    q, lam = tq.sample(gen, 4)
    assert q.shape == (4, 2) and bool((q == q[0]).all())
    np.testing.assert_allclose(lam.numpy(),
                               np.asarray(jq.scale_q_vals(jnp.asarray(
                                   q.numpy()))), rtol=1e-6)
    keys = jax.random.split(jax.random.PRNGKey(0), 600)
    ref = np.concatenate([np.asarray(jq.sample(k, 1)[0]) for k in keys])
    p = cfg["corner_p"]
    for arr in (got, ref):
        rate = np.isin(arr, (0.0, 1.0)).mean()
        assert abs(rate - p) <= 4 * (p * (1 - p) / arr.size) ** 0.5, rate
    ones = (got == 1.0).sum() / np.isin(got, (0.0, 1.0)).sum()
    assert abs(ones - 0.5) < 0.1


def test_frame_spec_and_raw_loader():
    for spec in (3, "2:9", "1:10:3", ["0", "4:6"]):
        assert TD.parse_frame_spec(spec) == JD.parse_frame_spec(spec)
    cfg = {"base_path": "/data", "datasets": {"uvg": {
        "path_template": "{sequence}/{name}_{frame:04d}.ply",
        "sequences": {"loot": {"name": "loot_vox10"}}}}}
    assert TD.RawLoader(cfg).path_for("loot", 7) == \
        JD.RawLoader(cfg).path_for("loot", 7)


def test_slice_into_cubes_byte_identical():
    xyz, rgb = _frame()
    ref = JD.slice_into_cubes(xyz, rgb, 64)
    got = TD.slice_into_cubes(xyz, rgb, 64)
    assert len(got) == len(ref) > 8
    for (gx, gc), (rx, rc) in zip(got, ref):
        assert gx.dtype == rx.dtype and gx.tobytes() == rx.tobytes()
        assert gc.dtype == rc.dtype and gc.tobytes() == rc.tobytes()


@pytest.mark.parametrize("capacity", [20000, 1500])
def test_collate_cubes_byte_identical(capacity):
    """Padding, and (at the small capacity) the random drop of overflow."""
    xyz, rgb = _frame()
    cubes = TD.slice_into_cubes(xyz, rgb, 64)[:6]
    ref = JD.collate_cubes(cubes, capacity, np.random.default_rng(3))
    got = TD.collate_cubes(cubes, capacity, np.random.default_rng(3))
    for g, r in zip(got, ref):
        assert g.dtype == r.dtype and g.tobytes() == r.tobytes()


def test_transforms_match_jax():
    cfg = {"1_ColorJitter": {"key": "ColorJitter", "seed": 4},
           "2_Rotate": {"key": "RandomRotate", "block_size": 64, "seed": 5}}
    tj, tt = JT.build_transforms(cfg), TT.build_transforms(cfg)
    xyz, rgb = _frame(n=800, extent=64)
    for _ in range(3):
        a, b = (xyz.astype(np.int32), rgb), (xyz.astype(np.int32), rgb)
        for fj, ft in zip(tj, tt):
            a, b = fj(*a), ft(*b)
            assert a[0].tobytes() == b[0].tobytes()
            assert a[1].tobytes() == b[1].tobytes()


@pytest.fixture(scope="module")
def synth_dirs(tmp_path_factory):
    root = tmp_path_factory.mktemp("synth")
    args = dict(train_frames=2, val_frames=1, test_frames=1, extent=128,
                points=6000, cube_size=32, seed0=3, verbose=False)
    JMS.build(str(root / "jax"), **args)
    TMS.build(str(root / "port"), **args)
    return root / "jax", root / "port"


def test_make_synth_matches_jax(synth_dirs):
    jdir, tdir = synth_dirs
    for split in ("train", "val", "test"):
        with np.load(jdir / f"{split}.npz") as a, \
                np.load(tdir / f"{split}.npz") as b:
            for key in ("points", "colors", "offsets"):
                assert a[key].dtype == b[key].dtype
                assert a[key].tobytes() == b[key].tobytes()
    import yaml
    jcfg = yaml.safe_load((jdir / "config.yaml").read_text())
    tcfg = TD.read_config(str(tdir / "config.yaml"))
    jcfg["name"] = tcfg["name"] = "x"
    assert jcfg == tcfg


def test_static_dataset_matches_jax(synth_dirs):
    """Both packages read the port's directory (its JSON config is YAML
    too): the same cubes with the min_points filter, the same frames."""
    _, tdir = synth_dirs
    for split, min_points in (("train", 50), ("val", 0)):
        a = JD.StaticDataset(str(tdir), split, min_points=min_points)
        b = TD.StaticDataset(str(tdir), split, min_points=min_points)
        assert len(a) == len(b) > 0
        np.testing.assert_array_equal(a.indices, b.indices)
        for i in range(len(a)):
            for x, y in zip(a[i], b[i]):
                assert x.tobytes() == y.tobytes()


@pytest.mark.parametrize("bucketing", [False, True])
def test_batch_packer_matches_jax(synth_dirs, bucketing):
    """The trainer's greedy size-bucketed packer, the JAX package's method
    run on the same dataset and seed: the same batches, byte for byte."""
    _, tdir = synth_dirs
    ds = TD.StaticDataset(str(tdir), "train", min_points=10)
    fake = types.SimpleNamespace(
        train_ds=ds, batch_size=3, capacity=4096,
        config={"batch_bucketing": bucketing},
        _CAP_LADDER=(1024, 2048, 4096))
    ref = list(JTraining._batches(fake, np.random.default_rng(1)))
    got = list(TTraining._batches(fake, np.random.default_rng(1)))
    assert len(got) == len(ref) > 1
    for gb, rb in zip(got, ref):
        for g, r in zip(gb, rb):
            assert g.tobytes() == r.tobytes()


def test_dataset_config_reader(tmp_path):
    """JSON where the file is JSON, else YAML."""
    (tmp_path / "a.yaml").write_text('{"cube_size": 64}')
    (tmp_path / "b.yaml").write_text("cube_size: 32\nname: x\n")
    assert TD.read_config(str(tmp_path / "a.yaml")) == {"cube_size": 64}
    assert TD.read_config(str(tmp_path / "b.yaml")) == {"cube_size": 32,
                                                        "name": "x"}
