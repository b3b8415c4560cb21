"""The port's flax-msgpack reader and weight mapping, and (slow) the port
against the JAX package at flagship width on the committed weights."""

import os

import numpy as np
import pytest
import torch

import upcc_tpu  # noqa: F401
import jax
import jax.numpy as jnp
from flax import serialization as ser

from upcc_tpu_torch.models.unified import UnifiedModel as TModel
from upcc_tpu_torch.weights import (FLAGSHIP_CONFIG, load_flax_msgpack,
                                    load_weights)

torch.set_num_threads(2)
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WEIGHTS = os.path.join(ROOT, "results", "CVPR_inverse_scaling",
                       "weights_bf16.msgpack")


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}/"))
        else:
            out[f"{prefix}{k}"] = v
    return out


def _flax_tree(path):
    with open(path, "rb") as f:
        return ser.msgpack_restore(f.read())


def test_reader_matches_flax_on_committed_weights():
    ref = _flat(_flax_tree(WEIGHTS))
    got = _flat(load_flax_msgpack(WEIGHTS))
    assert got.keys() == ref.keys() and len(got) == 81
    for key, a in ref.items():
        assert str(a.dtype) == "bfloat16"
        np.testing.assert_array_equal(got[key], np.asarray(a, np.float32))
        assert got[key].dtype == np.float32


def test_reader_handles_every_leaf_kind(tmp_path):
    rng = np.random.default_rng(0)
    tree = {"a": {"f32": rng.standard_normal((3, 4)).astype(np.float32),
                  "bf16": jnp.asarray(rng.standard_normal(7), jnp.bfloat16),
                  "f64": rng.standard_normal(2)},
            "ints": {"i32": np.arange(5, dtype=np.int32),
                     "i64": np.array([-(1 << 40), 3], np.int64),
                     "u8": np.array([0, 255], np.uint8),
                     "b": np.array([True, False])},
            "scalar": np.float32(2.5), "empty": np.zeros((0, 3), np.float32),
            "big": rng.standard_normal(70000).astype(np.float32)}
    path = tmp_path / "t.msgpack"
    path.write_bytes(ser.msgpack_serialize(tree))
    ref = _flat(_flax_tree(path))
    got = _flat(load_flax_msgpack(path))
    assert got.keys() == ref.keys()
    for key, a in ref.items():
        a = np.asarray(a)
        want = a.astype(np.float32) if np.issubdtype(a.dtype, np.floating) \
            or str(a.dtype) == "bfloat16" else a
        np.testing.assert_array_equal(got[key], want)


def test_load_weights_fills_the_flagship_model():
    model = load_weights(TModel(FLAGSHIP_CONFIG), WEIGHTS)
    ref = _flat(_flax_tree(WEIGHTS))
    sd = model.state_dict()
    assert len(sd) == len(ref)
    for key, a in ref.items():
        np.testing.assert_array_equal(sd[key.replace("/", ".")].numpy(),
                                      np.asarray(a, np.float32))


@pytest.mark.slow
def test_flagship_width_matches_jax():
    """The committed epoch-193 weights at full width, one small frame: the
    JAX codec and the port (CPU, f32) on the same frame and q.  The port's
    stream is bit-exact with itself; counts equal JAX's; bpp within 1%, D1
    and Y-PSNR within 0.1 dB; the JAX stream's decode under the port is
    printed."""
    from upcc_tpu.codec.codec import Codec as JCodec
    from upcc_tpu.data.synthetic import surface_cloud
    from upcc_tpu.eval.metrics import pc_metrics
    from upcc_tpu.models.unified import UnifiedModel as JModel
    from upcc_tpu_torch.codec.codec import Codec as TCodec

    tree = load_flax_msgpack(WEIGHTS)
    jparams = jax.tree_util.tree_map(jnp.asarray, tree)
    jc = JCodec(JModel(FLAGSHIP_CONFIG), jparams)
    jc.update()
    tc = TCodec(load_weights(TModel(FLAGSHIP_CONFIG), WEIGHTS), device="cpu")
    tc.update()
    xyz, rgb = surface_cloud(np.random.default_rng(10), extent=128,
                             n_target=6000)
    frame = np.concatenate([xyz.astype(np.float32), rgb], 1)
    q = (0.5, 0.5)
    tc.debug, tc.debug_info = True, []
    tdata = tc.compress(frame, q, block_size=1024)
    tout = tc.decompress(tdata)
    enc = [d for d in tc.debug_info if d["side"] == "enc"]
    dec = [d for d in tc.debug_info if d["side"] == "dec"]
    for e, d in zip(enc, dec):
        for key in ("y_keys", "z_sym", "y_idx", "y_sym", "scales", "means"):
            np.testing.assert_array_equal(e[key], d[key])
    jdata = jc.compress(frame, q, block_size=1024)
    jout = jc.decompress(jdata)
    assert tout.shape[0] == jout.shape[0]
    tm, jm = pc_metrics(frame, tout, 127), pc_metrics(frame, jout, 127)
    n = len(frame)
    print(f"\nflagship, {n} points: port {len(tdata) * 8 / n:.4f} bpp, "
          f"D1 {tm['sym_psnr_mse']:.3f} dB, Y {tm['sym_y_psnr']:.3f} dB; "
          f"JAX {len(jdata) * 8 / n:.4f} bpp, D1 {jm['sym_psnr_mse']:.3f} dB,"
          f" Y {jm['sym_y_psnr']:.3f} dB; identical streams: {tdata == jdata}")
    try:
        cross = tc.decompress(jdata)
        print(f"JAX stream under the port: {cross.shape[0]} points, "
              f"identical to the JAX decode: {np.array_equal(cross, jout)}")
    except Exception as exc:  # reported, not asserted
        print(f"JAX stream under the port: failed ({exc!r})")
    assert len(tdata) == pytest.approx(len(jdata), rel=0.01)
    assert abs(tm["sym_psnr_mse"] - jm["sym_psnr_mse"]) <= 0.1
    assert abs(tm["sym_y_psnr"] - jm["sym_y_psnr"]) <= 0.1
