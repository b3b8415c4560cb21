"""The port's graft entry (``upcc_tpu_torch.graft_entry``) against the root
``__graft_entry__.py`` on the CPU at N=16: the JAX ``_build(flagship=False,
extent=16, n_per=200, cap=512, batch=1)`` parameters carried into the port
with ``weights.params_from_jax``, the same noise handed to both packages by
shape (``tests/test_torch_train.py``'s ``inject``), and the port's ``fn``
held against the JAX ``model.apply`` in training mode.  g_a's last layer
is scaled by 30 in both (as in ``tests/test_torch_region_train.py``): at a
fresh init every latent rounds to 0 and the prediction's features are all
zero.

Tolerance (``test_torch_train.py``'s f32 rule for arrays): the prediction's
keys are equal; its features and y's likelihoods within 1e-3 of their
largest JAX element (both f32, JAX at "highest" precision, summed in other
orders)."""

import os
import sys

import numpy as np
import pytest
import torch

import upcc_tpu  # noqa: F401
import jax

from upcc_tpu_torch import graft_entry
from upcc_tpu_torch.weights import params_from_jax
from test_torch_region_train import _scale_latents
from test_torch_train import GRAD_RTOL, Noise, inject

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
import __graft_entry__ as root_entry  # noqa: E402

torch.set_num_threads(2)

BUILD = {"flagship": False, "extent": 16, "n_per": 200, "cap": 512,
         "batch": 1}


@pytest.fixture(scope="module")
def both():
    jmodel, params, st, q, lam = root_entry._build(**BUILD)
    params = _scale_latents(params)
    model, x, tq, tlam = graft_entry._build(device="cpu", **BUILD)
    model.load_state_dict(params_from_jax(
        jax.tree_util.tree_map(np.asarray, params), model))
    noise = Noise(5)
    mp = pytest.MonkeyPatch()
    inject(mp, noise)
    try:
        out = jax.jit(lambda p: jmodel.apply(
            {"params": p}, st, q, lam, training=True,
            rngs={"noise": jax.random.PRNGKey(2)}))(params)
        fn = graft_entry.make_forward(model)
        got = fn(x.keys, x.feats, tq, tlam)
        keys = model(x, tq, tlam, training=True)["prediction"].keys
    finally:
        mp.undo()
    return {"st": st, "x": x, "q": (q, tq), "lam": (lam, tlam),
            "jax": out, "port": got, "port_keys": keys}


def test_graft_inputs_equal_jax(both):
    np.testing.assert_array_equal(both["x"].keys.numpy(),
                                  np.asarray(both["st"].keys))
    np.testing.assert_array_equal(both["x"].feats.numpy(),
                                  np.asarray(both["st"].feats))
    for j, t in (both["q"], both["lam"]):
        np.testing.assert_array_equal(t.numpy(), np.asarray(j))


def test_graft_forward_matches_jax(both):
    jo = both["jax"]
    feats, lik_y = both["port"]
    np.testing.assert_array_equal(both["port_keys"].numpy(),
                                  np.asarray(jo["prediction"].keys))
    for got, ref in ((feats, jo["prediction"].feats),
                     (lik_y, jo["likelihoods"]["y"])):
        got, ref = got.detach().numpy(), np.asarray(ref)
        assert got.shape == ref.shape and np.isfinite(got).all()
        assert np.abs(ref).max() > 0
        err = np.abs(got - ref).max() / np.abs(ref).max()
        print(f"max|port - jax| / max|jax| = {err:.3e}")
        assert err <= GRAD_RTOL


def test_graft_entry_example_args_and_export(monkeypatch):
    """entry() builds the flagship's widths on the asked device and hands
    back (fn, (keys, feats, q, lam)); the dry run is parallel/dryrun's."""
    from upcc_tpu_torch.parallel import dryrun
    assert graft_entry.dryrun_multichip is dryrun.dryrun_multichip
    seen = {}
    build = graft_entry._build

    def small(**kw):
        seen.update(kw)
        return build(**dict(BUILD, device=kw["device"]))
    monkeypatch.setattr(graft_entry, "_build", small)
    fn, args = graft_entry.entry(device="cpu")
    assert seen == {"device": "cpu"}
    keys, feats, q, lam = args
    assert keys.shape == (512,) and feats.shape == (512, 3)
    assert q.shape == lam.shape == (1, 2)
    out = fn(*args)
    assert all(torch.isfinite(o).all() for o in out)
    # the same noise on every call
    torch.testing.assert_close(fn(*args)[1], out[1], rtol=0, atol=0)
    # the card is the default, and without one entry() raises
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="not available"):
        graft_entry.entry()


def test_graft_build_flagship_widths():
    """_build's flagship model: N=128, C_hyper 192, min_one_child."""
    model = graft_entry._build(extent=16, n_per=50, cap=256, batch=1,
                               device="cpu")[0]
    cfg = model.config
    assert cfg["g_a"]["N1"] == cfg["g_s"]["N4"] == 128
    assert cfg["entropy_model"]["C_hyper_bottleneck"] == 192
    assert cfg["g_s"]["min_one_child"] and cfg["max_batch"] == 1
