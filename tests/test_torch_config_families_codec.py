"""Every committed experiment config through the codec in both packages:
each YAML under ``configs/`` and ``configs/ablation/`` at N=16 (as in
``tests/test_torch_config_families.py``), JAX's init with g_a's last layer
scaled by 30 (as in ``tests/test_torch_region_train.py``: at a fresh init
every latent rounds to 0 and the gain paths go unexercised), one small
two-block frame at q = (0.4, 0.7), in each geometry mode.  The port's
container is byte-identical to the JAX codec's and decodes to the
transmitted count (with region candidates: to the JAX decode's points,
which fall short of it, and to the transmitted count once the dilated
parent set is unclipped).  Left out: ``geom="coded"`` with region candidates,
which neither package supports (the port raises a ValueError,
``tests/test_torch_region.py``).  The cases run in this file and in
``tests/test_torch_config_families_codec_b.py``."""

import numpy as np
import pytest
import torch

import upcc_tpu  # noqa: F401
import jax
import jax.numpy as jnp

from upcc_tpu.codec.codec import Codec as JCodec
from upcc_tpu.data.synthetic import surface_cloud
from upcc_tpu.models.unified import UnifiedModel as JModel
from upcc_tpu.ops.sparse import SparseTensor as JST

from upcc_tpu_torch.codec import bitstream
from upcc_tpu_torch.codec.codec import Codec as TCodec
from upcc_tpu_torch.models.unified import UnifiedModel as TModel
from upcc_tpu_torch.weights import params_from_jax
from test_torch_config_families import CASES, batch, load_case
from test_torch_region_train import _scale_latents

torch.set_num_threads(2)

Q = (0.4, 0.7)
BLOCK = 64


def codec_cases(cases):
    return [(c, g) for c in cases if c != "uniform"
            for g in ("topk", "coded")
            if not (g == "coded" and c.endswith("abl_region5.yaml"))]


def frame():
    rng = np.random.default_rng(7)
    parts = []
    for off in (0, 64):
        xyz, rgb = surface_cloud(rng, extent=48, n_target=500)
        parts.append(np.concatenate(
            [(xyz + np.array([[off, 0, 0]])).astype(np.float32), rgb], 1))
    return np.concatenate(parts)


def check_case(case, geom):
    """Both codecs on the frame: byte-identical containers, the port's
    decode = sum k[2]."""
    _, mcfg = load_case(case)
    keys, feats, q, lam = batch()
    jm = JModel(mcfg)
    params = _scale_latents(jax.jit(jm.init)(
        {"params": jax.random.PRNGKey(0), "noise": jax.random.PRNGKey(1)},
        JST(jnp.asarray(keys), jnp.asarray(feats)), jnp.asarray(q),
        jnp.asarray(lam))["params"])
    jc = JCodec(jm, params)
    jc.update()
    tm = TModel(mcfg)
    tm.load_state_dict(params_from_jax(
        jax.tree_util.tree_map(np.asarray, params), tm))
    tc = TCodec(tm, device="cpu")
    tc.update()
    pc = frame()
    tdata = tc.compress(pc, Q, block_size=BLOCK, geom=geom)
    jdata = jc.compress(pc, Q, block_size=BLOCK, geom=geom)
    assert tdata == jdata, (case, geom, len(tdata), len(jdata))
    blocks, _ = bitstream.read_container(tdata)
    assert len(blocks) == 2
    rec = tc.decompress(tdata)
    sent = sum(int(b["k"][2]) for b in blocks)
    if mcfg["g_s"].get("region_candidates"):
        # a reference defect (ROADMAP Queue 3): region g_s clips its
        # 27-dilated parent set to region_dilate_factor x the parent
        # capacity, and the keys sort block-major, so a group's later
        # blocks lose their candidates (here the second block at the finest
        # level).  The port decodes what the JAX codec decodes, and with the
        # dilated set unclipped every transmitted point: the clip is the
        # whole shortfall
        jrec = jc.decompress(jdata)
        np.testing.assert_array_equal(rec[:, :3], jrec[:, :3])
        tc.model.g_s.region_dilate_factor = 27.0
        assert tc.decompress(tdata).shape[0] == sent
    else:
        assert rec.shape[0] == sent
    return len(tdata)


# spread over this file and _codec_b.py (--dist loadfile)
CODEC_SPLIT = (codec_cases(CASES)[:10], codec_cases(CASES)[10:])


@pytest.mark.parametrize("case,geom", CODEC_SPLIT[0])
def test_config_codec_container_equals_jax(case, geom):
    print(f"{case} {geom}: {check_case(case, geom)} B byte-identical")


def test_codec_cases_cover_every_config_and_mode():
    cases = sum(CODEC_SPLIT, [])
    assert len(cases) == 2 * (len(CASES) - 1) - 1 == 19
    assert ("configs/ablation/abl_region5.yaml", "topk") in cases
