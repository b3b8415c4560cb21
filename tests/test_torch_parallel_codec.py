"""Block-parallel inference of the port (``Codec(devices=[...])``,
``parallel/block_parallel.py``) on the CPU at the widths of
tests/test_parallel.py: groups dispatched over four listed devices (one
worker thread each) give the sequential port's bytes and the JAX
package's sequential bytes; the decode and compress_multi are the
sequential ones; distinct devices get model replicas."""

import threading

import numpy as np
import pytest
import torch

import upcc_tpu  # noqa: F401
import jax
import jax.numpy as jnp

from upcc_tpu.codec import codec as j_codec_mod
from upcc_tpu.codec.codec import Codec as JCodec
from upcc_tpu.data.synthetic import surface_cloud
from upcc_tpu.models.unified import UnifiedModel as JModel
from upcc_tpu.ops.sparse import from_points_host
from upcc_tpu.parallel import block_parallel as JBP

from upcc_tpu_torch.codec import codec as t_codec_mod
from upcc_tpu_torch.codec.codec import Codec as TCodec
from upcc_tpu_torch.models.layers import _TapConv
from upcc_tpu_torch.models.unified import UnifiedModel as TModel
from upcc_tpu_torch.parallel import block_parallel as TBP
from upcc_tpu_torch.weights import params_from_jax

torch.set_num_threads(2)

CFG = {
    "max_batch": 1,
    "g_a": {"C_in": 4, "N1": 8, "N2": 8, "N3": 8, "N4": 8},
    "g_s": {"C_out": 3, "N1": 8, "N2": 8, "N3": 8, "N4": 8},
    "entropy_model": {"C_bottleneck": 8, "C_hyper_bottleneck": 12,
                      "quantization_mode": "ste", "inverse_rescaling": True,
                      "quantization_offset": True},
}
QS = [(0.5, 0.5), (0.1, 0.9)]
BLOCK = 32
GROUP = 3  # small groups force several groups a frame


@pytest.fixture(scope="module")
def setup():
    """The JAX init, the port model on it, the frame (many 32-blocks),
    and the JAX package's sequential containers at both q's."""
    model = JModel(CFG)
    xyz, rgb = surface_cloud(np.random.default_rng(0), extent=32,
                             n_target=400)
    st = from_points_host(np.zeros(len(xyz), np.int32), xyz, rgb, 512)
    params = jax.jit(model.init)({"params": jax.random.PRNGKey(0),
                                  "noise": jax.random.PRNGKey(1)}, st,
                                 jnp.full((1, 2), 0.5, jnp.float32),
                                 jnp.ones((1, 2), jnp.float32))["params"]
    xyz2, rgb2 = surface_cloud(np.random.default_rng(1), extent=128,
                               n_target=6000)
    pc = np.concatenate([xyz2.astype(np.float32), rgb2], axis=1)
    mp = pytest.MonkeyPatch()
    mp.setattr(j_codec_mod, "MAX_GROUP", GROUP)
    try:
        jc = JCodec(model, params)
        jc.update()
        jax_blobs = [bytes(jc.compress(pc, q=q, block_size=BLOCK))
                     for q in QS]
    finally:
        mp.undo()
    np_params = jax.tree_util.tree_map(np.asarray, params)
    return np_params, pc, jax_blobs


def port_codec(np_params, **kw):
    tm = TModel(CFG)
    tm.load_state_dict(params_from_jax(np_params, tm))
    codec = TCodec(tm, **kw)
    codec.update()
    return codec


@pytest.fixture(scope="module")
def sequential(setup):
    np_params, pc, _ = setup
    mp = pytest.MonkeyPatch()
    mp.setattr(t_codec_mod, "MAX_GROUP", GROUP)
    try:
        seq = port_codec(np_params, device="cpu")
        seq.debug = True  # the sequential path, groups in order
        blobs = [seq.compress(pc, q=q, block_size=BLOCK) for q in QS]
        rec = seq.decompress(blobs[0])
    finally:
        mp.undo()
    return blobs, rec


@pytest.mark.parametrize("devices", [["cpu"] * 4, ["cpu", "cpu:0", "cpu"]],
                         ids=["one device x4", "two devices"])
def test_block_parallel_bytes_equal_sequential_and_jax(setup, sequential,
                                                       devices, monkeypatch):
    """Groups round-robin over the listed devices, one worker thread per
    entry: the containers equal the sequential port's and the JAX
    package's sequential codec's; the decode and compress_multi equal the
    sequential ones."""
    np_params, pc, jax_blobs = setup
    seq_blobs, seq_rec = sequential
    monkeypatch.setattr(t_codec_mod, "MAX_GROUP", GROUP)
    par = port_codec(np_params, device="cuda", devices=devices)
    assert par.device == torch.device("cpu")
    groups, _ = par._partition_blocks(pc, BLOCK, 1.0)
    assert len(groups) > len(devices)
    threads = set()
    real = TCodec._encode_shared

    def spy(self, *args):
        threads.add((threading.get_ident(), self.device))
        return real(self, *args)
    monkeypatch.setattr(TCodec, "_encode_shared", spy)
    blob = par.compress(pc, q=QS[0], block_size=BLOCK)
    assert blob == seq_blobs[0] == jax_blobs[0]
    assert len({t for t, _ in threads}) == len(devices)
    assert {d for _, d in threads} == set(par._replicas)
    np.testing.assert_array_equal(par.decompress(blob), seq_rec)
    multi = par.compress_multi(pc, QS, block_size=BLOCK)
    assert [bytes(m) for m in multi] == seq_blobs == jax_blobs


def test_distinct_devices_get_prepared_replicas(setup):
    """Each distinct device gets its own copy of the model, prepared by its
    own update(); an entry listed twice shares one; the first entry is the
    codec's own device."""
    np_params, _, _ = setup
    par = port_codec(np_params, devices=["cpu", "cpu:0", "cpu"])
    assert set(par._replicas) == {torch.device("cpu"),
                                  torch.device("cpu", 0)}
    rep = par._replicas[torch.device("cpu", 0)]
    assert par._replicas[torch.device("cpu")] is par
    assert rep.model is not par.model and rep.device.index == 0
    assert not rep.debug and not rep.profile and rep.tables is not None
    for a, b in zip(par.model.state_dict().values(),
                    rep.model.state_dict().values()):
        assert torch.equal(a, b) and a.data_ptr() != b.data_ptr()
    convs = [m for m in rep.model.modules() if isinstance(m, _TapConv)]
    assert all(m._plans for m in convs if not (
        m.kind == "transpose" and m.kernel_size == 2))


def test_block_parallel_helpers_match_jax():
    """round_robin_devices, shard_points_by_block (equal to the JAX
    package's) and parallel_map_blocks (block order, one worker a listed
    entry)."""
    assert TBP.round_robin_devices(5, ["a", "b"]) == \
        JBP.round_robin_devices(5, ["a", "b"]) == ["a", "b", "a", "b", "a"]
    xyz = np.random.default_rng(3).integers(-50, 300, (2000, 3))
    for got, ref in zip(TBP.shard_points_by_block(xyz, 64),
                        JBP.shard_points_by_block(xyz, 64)):
        np.testing.assert_array_equal(got, ref)
    seen = set()
    barrier = threading.Barrier(3, timeout=30)

    def fn(blk, dev):
        seen.add(threading.get_ident())
        if blk < 3:
            barrier.wait()  # three workers run at once
        return blk * 10, dev
    out = TBP.parallel_map_blocks(fn, list(range(7)), ["x", "x", "y"])
    assert out == [(i * 10, "xxy"[i % 3]) for i in range(7)]
    assert len(seen) == 3
    assert TBP.parallel_map_blocks(fn, [5], ["x", "y"]) == [(50, "x")]
