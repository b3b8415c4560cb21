"""``Codec._fetch_points`` builds the decoded [N, 6] cloud on the device
and copies it to the host once.  It is held bit for bit against the numpy
assembly it replaced (``fetch_numpy`` below), on synthetic sparse tensors
and on those the top-k and coded-geometry decodes hand it."""

import numpy as np
import pytest
import torch

from upcc_tpu_torch.codec.codec import Codec
from upcc_tpu_torch.data.synthetic import surface_cloud
from upcc_tpu_torch.models.unified import UnifiedModel
from upcc_tpu_torch.ops import coords as C
from upcc_tpu_torch.ops.sparse import SparseTensor
from upcc_tpu_torch.utils import profiling as P
from upcc_tpu_torch.weights import flagship_config

torch.set_num_threads(2)

Q = (0.5, 0.5)
CASES = ("one_group", "three_groups", "empty", "topk", "coded")


def fetch_numpy(blks, st):
    """The host assembly of the cloud as it was: keys and 8-bit colors
    copied to the host, Morton decode, origins and the division in numpy."""
    n = int(st.valid.sum())
    keys = st.keys[:n].cpu().numpy()
    colors8 = torch.clamp(torch.round(st.feats[:n].float() * 255.0),
                          0, 255).to(torch.uint8).cpu().numpy()
    bu = np.minimum(keys >> C.BATCH_SHIFT, len(blks) - 1)
    units = C.morton_decode_np(keys & C.KEY_MASK)
    origins = np.asarray([b["origin"] for b in blks], np.int32)
    xyz = units + origins[bu]
    colors = colors8.astype(np.float32) / 255.0
    return np.concatenate([xyz.astype(np.float32), colors], axis=1)


def make_codec(device):
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(0)
        model = UnifiedModel(flagship_config(16))
    c = Codec(model, device=device)
    c.update()
    return c


def synthetic(rng, g, n, cap):
    """A decoded tensor of ``g`` blocks at nonzero origins: every batch
    index present, sorted keys with SENTINEL padding, and colors that land
    on every 8-bit level (halfway cases and values outside [0, 1] too)."""
    units = rng.integers(0, 1024, (n, 3))
    batch = np.arange(n, dtype=np.int64) % g
    keys = np.unique((batch << C.BATCH_SHIFT) | C.morton_encode_np(units))
    levels = np.arange(256, dtype=np.float64)
    pool = np.concatenate([levels, levels + 0.499, levels - 0.499,
                           levels + 0.5, [-70.0, 400.0]]) / 255.0
    feats = np.zeros((cap, 3), np.float32)
    feats[:len(keys)] = rng.choice(pool, (len(keys), 3))
    padded = np.full(cap, C.SENTINEL, np.int64)
    padded[:len(keys)] = keys
    blks = [{"origin": (1024 * i + 7, 3 * i, 2048 - 5 * i)} for i in range(g)]
    return blks, SparseTensor(torch.from_numpy(padded),
                              torch.from_numpy(feats))


@pytest.fixture(scope="module")
def cpu_codec():
    return make_codec("cpu")


@pytest.fixture(scope="module")
def containers(cpu_codec):
    """A frame of a few blocks (one decode group) in each geometry mode."""
    rng = np.random.default_rng(5)
    parts = []
    for off in (0, 96):
        xyz, rgb = surface_cloud(rng, extent=64, n_target=1200)
        parts.append(np.concatenate(
            [(xyz + np.array([[off, 0, 0]])).astype(np.float32), rgb], 1))
    frame = np.concatenate(parts)
    return {geom: cpu_codec.compress(frame, Q, block_size=64, geom=geom)
            for geom in ("topk", "coded")}


@pytest.fixture(scope="module")
def inputs(cpu_codec, containers):
    """Each case's (blks, st): synthetic, or caught from the decode of
    each container."""
    rng = np.random.default_rng(5)
    out = {"one_group": synthetic(rng, 1, 3000, 4096),
           "three_groups": synthetic(rng, 3, 3000, 4096),
           "empty": synthetic(rng, 1, 0, 8)}
    fetch = Codec._fetch_points
    for geom, data in containers.items():
        caught = []

        def spy(self, blks, st):
            caught.append((blks, st))
            return fetch(self, blks, st)

        Codec._fetch_points = spy
        try:
            cpu_codec.decompress(data)
        finally:
            Codec._fetch_points = fetch
        (out[geom],) = caught
    return out


def on(st, device):
    return SparseTensor(st.keys.to(device), st.feats.to(device), st.stride)


@pytest.mark.parametrize("device", ["cpu", "cuda"])
@pytest.mark.parametrize("case", CASES)
def test_fetch_equals_the_numpy_assembly(case, device, cpu_codec, inputs):
    if device == "cuda" and not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    codec = cpu_codec if device == "cpu" else make_codec(device)
    blks, st = inputs[case]
    st = on(st, device)
    want = fetch_numpy(blks, st)
    got = codec._fetch_points(blks, st)
    assert isinstance(got, np.ndarray) and got.dtype == np.float32
    assert got.flags.c_contiguous and got.flags.writeable
    assert got.shape == want.shape == (int(st.valid.sum()), 6)
    np.testing.assert_array_equal(got.view(np.uint32), want.view(np.uint32))
    if case in ("one_group", "three_groups"):
        bu = st.keys[:len(got)].cpu().numpy() >> C.BATCH_SHIFT
        assert set(bu.tolist()) == set(range(len(blks)))
        assert len(np.unique(want[:, 3:])) == 256
    if case in ("topk", "coded"):
        assert len(blks) > 1 and len(got) > 0


def test_color_table_is_numpy_division(cpu_codec):
    want = np.arange(256, dtype=np.float32) / 255.0
    got = cpu_codec._color_levels.numpy()
    assert got.dtype == np.float32
    np.testing.assert_array_equal(got.view(np.uint32), want.view(np.uint32))


@pytest.mark.parametrize("geom", ["topk", "coded"])
def test_decode_copies_once_and_owns_its_cloud(geom, cpu_codec, containers):
    """The counter reads one [N, 6] f32 copy a frame, and the frame a
    decode returns is its own: writing into it changes no later decode."""
    with P.recording() as rec:
        got = cpu_codec.decompress(containers[geom])
    (counts,) = rec.counts.values()
    assert counts["dec.fetch.d2h_bytes"] == got.shape[0] * 24 > 0
    want = got.copy()
    got[:] = -1.0
    np.testing.assert_array_equal(cpu_codec.decompress(containers[geom]),
                                  want)
