"""The port's ``utils/`` against the JAX package's: ``misc`` (running
averages, bit counts, set membership with its duplicate warning),
``StageTimer``, the compact weight snapshots read across the two packages
(a port ``save_compact`` read by JAX ``load_params`` and the reverse),
and ``device_trace`` writing a trace file on the CPU."""

import os

import numpy as np
import pytest
import torch

import upcc_tpu  # noqa: F401
import jax
import jax.numpy as jnp

from upcc_tpu.data.synthetic import surface_cloud
from upcc_tpu.models.unified import UnifiedModel as JModel
from upcc_tpu.ops.sparse import from_points
from upcc_tpu.utils import misc as JM
from upcc_tpu.utils import profiling as JP
from upcc_tpu.utils import weights_io as JW
from upcc_tpu_torch.models.unified import UnifiedModel as TModel
from upcc_tpu_torch.utils import misc as TM
from upcc_tpu_torch.utils import profiling as TP
from upcc_tpu_torch.utils import weights_io as TW
from upcc_tpu_torch.weights import _flatten, params_from_jax

torch.set_num_threads(2)

CFG = {
    "max_batch": 2,
    "g_a": {"C_in": 4, "N1": 8, "N2": 8, "N3": 8, "N4": 8},
    "g_s": {"C_out": 3, "N1": 8, "N2": 8, "N3": 8, "N4": 8},
    "entropy_model": {"C_bottleneck": 8, "C_hyper_bottleneck": 8,
                      "quantization_mode": "ste", "inverse_rescaling": True,
                      "quantization_offset": True},
}


def test_average_meter_matches_jax():
    rng = np.random.default_rng(0)
    tm, jm = TM.AverageMeter(), JM.AverageMeter()
    assert tm.avg == jm.avg == 0.0
    for _ in range(20):
        v, n = float(rng.normal()), int(rng.integers(1, 5))
        tm.update(v, n)
        jm.update(v, n)
        assert (tm.val, tm.sum, tm.count, tm.avg) == \
            (jm.val, jm.sum, jm.count, jm.avg)
    tm.reset()
    assert (tm.val, tm.sum, tm.count, tm.avg) == (0.0, 0.0, 0, 0.0)


def test_count_bits_matches_jax():
    strings = [b"abc", (b"", bytearray(b"xy")), {"a": b"1234", "b": [b"z"]}]
    assert TM.count_bits(strings) == JM.count_bits(strings) == 80
    for bad in (3, "text"):
        with pytest.raises(TypeError):
            TM.count_bits(bad)


@pytest.mark.parametrize("case", ["random", "duplicates", "empty_b",
                                  "empty_a"])
def test_overlapping_mask_matches_jax(capsys, case):
    rng = np.random.default_rng(1)
    a = rng.integers(0, 50, 40).astype(np.int64)
    b = rng.integers(0, 50, 30).astype(np.int64)
    if case == "random":
        a = np.unique(a)
    elif case == "empty_b":
        b = b[:0]
    elif case == "empty_a":
        a = a[:0]
    got = TM.overlapping_mask(a, b)
    port_out = capsys.readouterr().out
    ref = JM.overlapping_mask(a, b)
    assert capsys.readouterr().out == port_out
    np.testing.assert_array_equal(got, ref)
    if case == "duplicates":
        assert port_out.startswith("Warning: ") and \
            "duplicate coordinates in overlapping_mask input" in port_out
    TM.overlapping_mask(a, b, warn_duplicates=False)
    assert capsys.readouterr().out == ""


def test_stage_timer_matches_jax(monkeypatch):
    """Both timers on the same clock readings give the same summary."""
    readings = np.cumsum(np.random.default_rng(2).random(24)).tolist()
    summaries = []
    for mod in (TP, JP):
        it = iter(readings)
        monkeypatch.setattr(mod.time, "time", lambda: next(it))
        timer = mod.StageTimer()
        for i in range(12):
            with timer.section("enc" if i % 3 else "dec"):
                pass
        summaries.append(timer.summary())
        monkeypatch.undo()
    assert summaries[0] == summaries[1]
    assert summaries[0]["enc"]["n"] == 8 and summaries[0]["dec"]["n"] == 4


def test_device_trace_writes_a_trace_file(tmp_path, capsys):
    log_dir = tmp_path / "trace"
    with TP.device_trace(str(log_dir)):
        torch.ones(64, 64) @ torch.ones(64, 64)
    files = os.listdir(log_dir)
    assert len(files) == 1 and files[0].endswith(".json")
    path = os.path.join(log_dir, files[0])
    assert os.path.getsize(path) > 0
    assert f"device trace written to {path}" in capsys.readouterr().out


@pytest.fixture(scope="module")
def jax_params():
    rng = np.random.default_rng(0)
    xyz, rgb = surface_cloud(rng, extent=32, n_target=300)
    st = from_points(jnp.zeros(len(xyz), jnp.int32), jnp.asarray(xyz),
                     jnp.asarray(rgb), capacity=512)
    q = jnp.full((1, 2), 0.5, jnp.float32)
    return jax.jit(JModel(CFG).init)({"params": jax.random.PRNGKey(0),
                                      "noise": jax.random.PRNGKey(1)}, st,
                                     q, q)["params"]


def _bf16(a):
    return np.asarray(jnp.asarray(a, jnp.float32).astype(jnp.bfloat16)
                      .astype(jnp.float32))


def test_save_compact_is_read_by_jax_load_params(jax_params, tmp_path):
    tm = TModel(CFG)
    tm.load_state_dict(params_from_jax(
        jax.tree_util.tree_map(np.asarray, jax_params), tm))
    path = str(tmp_path / "port_bf16.msgpack")
    TW.save_compact(tm, path)
    loaded = JW.load_params(jax_params, path)
    got = _flatten(jax.tree_util.tree_map(np.asarray, loaded))
    want = _flatten(jax.tree_util.tree_map(np.asarray, jax_params))
    assert set(got) == set(want)
    for name, ref in want.items():
        # upcast to the template's dtype (a few JAX leaves are float64)
        assert got[name].dtype == ref.dtype
        np.testing.assert_array_equal(got[name], _bf16(ref).astype(ref.dtype),
                                      err_msg=name)


@pytest.mark.parametrize("compact", [True, False])
def test_load_params_reads_jax_snapshots(jax_params, tmp_path, compact):
    path = str(tmp_path / "jax.msgpack")
    if compact:
        JW.save_compact(jax_params, path)
    else:
        from flax import serialization as ser
        with open(path, "wb") as f:
            f.write(ser.to_bytes(jax_params))
    tm = TW.load_params(TModel(CFG), path)
    want = _flatten(jax.tree_util.tree_map(np.asarray, jax_params))
    for name, t in tm.state_dict().items():
        assert t.dtype == torch.float32
        ref = _bf16(want[name]) if compact else want[name]
        np.testing.assert_array_equal(t.numpy(), ref, err_msg=name)
