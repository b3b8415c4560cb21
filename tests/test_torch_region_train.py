"""Region-candidate training of the port against the JAX package, on the
CPU at N=16: one training step's masks, loss parts and gradients, a trail
of 5 whole updates, and the backward of the cross maps the region
transposes run over (rows of the 27-dilated parent set, sources of the
parent set).

Noise is handed to both packages from numpy by shape, as in
tests/test_torch_train.py, whose helpers and tolerances this file uses:
loss parts within 1e-5 relative; each gradient within 1e-3 of its
largest JAX element; parameters after the updates within 1e-2 of the
size of their update."""

import numpy as np
import pytest
import torch

import upcc_tpu  # noqa: F401
import jax
import jax.numpy as jnp

from upcc_tpu.data.synthetic import batch_of_cubes
from upcc_tpu.models.unified import UnifiedModel as JModel
from upcc_tpu.models.unified import host_root_maps as j_roots
from upcc_tpu.ops import family as JF
from upcc_tpu.ops.sparse import SparseTensor as JST
from upcc_tpu.ops.sparse import dilate_keys as j_dilate
from upcc_tpu.ops.sparse import voxelize_host_np
from upcc_tpu.training.loss import Loss as JLoss
from upcc_tpu.training.train_step import TrainState
from upcc_tpu.training.train_step import make_optimizer as j_optimizer
from upcc_tpu.training.train_step import make_train_step

from upcc_tpu_torch.models.unified import UnifiedModel as TModel
from upcc_tpu_torch.models.unified import host_root_maps as t_roots
from upcc_tpu_torch.ops import family as F
from upcc_tpu_torch.ops.sparse import SparseTensor as TST
from upcc_tpu_torch.training.loss import Loss as TLoss
from upcc_tpu_torch.training.train_step import TrainStep
from upcc_tpu_torch.utils import profiling
from upcc_tpu_torch.weights import _flatten, params_from_jax
from test_torch_train import (GRAD_RTOL, LOSS, LOSS_RTOL, N_TAP_LAYERS,
                              Noise, T, inject)

torch.set_num_threads(2)

CFG = {
    "max_batch": 2,
    "g_a": {"C_in": 4, "N1": 16, "N2": 16, "N3": 16, "N4": 16},
    "g_s": {"C_out": 3, "N1": 16, "N2": 16, "N3": 16, "N4": 16,
            "region_candidates": True},
    "entropy_model": {"C_bottleneck": 16, "C_hyper_bottleneck": 24,
                      "quantization_mode": "ste", "inverse_rescaling": True,
                      "quantization_offset": True},
}
CAP = 2048
TRAIL = 5
TRAIL_CFG = {"model_learning_rate": 1e-3, "bottleneck_learning_rate": 1e-2,
             "clip_grad_norm": 1.0}
# g_a's last layer scaled from its init: at a fresh init every latent
# rounds to 0, and then no conv weight of g_s receives a gradient
LATENT_SCALE = 30.0


def _scale_latents(params):
    def scale(path, v):
        names = [getattr(k, "key", None) for k in path]
        return v * LATENT_SCALE if names == ["g_a", "conv4", "w"] else v
    return jax.tree_util.tree_map_with_path(scale, params)


@pytest.fixture(scope="module")
def batch():
    rng = np.random.default_rng(0)
    b, x, c = batch_of_cubes(rng, 2, extent=32, n_per=500, capacity=CAP)
    keys, feats = voxelize_host_np(b, x, c, CAP)
    q = np.array([[0.3, 0.7], [0.8, 0.2]], np.float32)
    lam = np.array([[50.0, 6000.0], [120.0, 900.0]], np.float32)
    return keys, feats, q, lam


@pytest.fixture(scope="module")
def jax_step(batch):
    """JAX's init and one region step's (loss, parts, grads, forward),
    through make_train_step's own loss function."""
    keys, feats, q, lam = batch
    jm = JModel(CFG)
    xj = JST(jnp.asarray(keys), jnp.asarray(feats))
    params = _scale_latents(jax.jit(jm.init)(
        {"params": jax.random.PRNGKey(0), "noise": jax.random.PRNGKey(1)},
        xj, jnp.asarray(q), jnp.asarray(lam))["params"])
    step = make_train_step(jm, JLoss(LOSS, max_batch=2), j_optimizer({}))
    loss_fn = dict(zip(step.__code__.co_freevars,
                       (c.cell_contents for c in step.__closure__)))["loss_fn"]
    root = j_roots(keys, CFG)
    mp = pytest.MonkeyPatch()
    noise = Noise(11)
    inject(mp, noise)
    try:
        (total, parts), grads = jax.jit(jax.value_and_grad(
            loss_fn, has_aux=True))(params, xj, jnp.asarray(q),
                                    jnp.asarray(lam), jax.random.PRNGKey(3),
                                    root)
        out = jax.jit(lambda p: jm.apply(
            {"params": p}, xj, jnp.asarray(q), jnp.asarray(lam),
            training=True, root_nbrs=root,
            rngs={"noise": jax.random.PRNGKey(3)}))(params)
    finally:
        mp.undo()
    return {"params": params,
            "np_params": jax.tree_util.tree_map(np.asarray, params),
            "total": float(total),
            "parts": {k: float(v) for k, v in parts.items()},
            "grads": _flatten(jax.tree_util.tree_map(np.asarray, grads)),
            "out": out, "noise": noise, "model": jm}


def port_model(np_params):
    tm = TModel(CFG)
    tm.load_state_dict(params_from_jax(np_params, tm))
    return tm


@pytest.fixture(scope="module")
def port_step(batch, jax_step):
    """The port's region step on the same batch and noise, recording every
    K1 call's map (rows, sources, self or cross)."""
    keys, feats, q, lam = batch
    calls = []
    gemm = F._gemm

    def record(flat, idx, ok, w, self_map=True):
        calls.append((flat.shape[0], idx, ok, self_map))
        return gemm(flat, idx, ok, w, self_map)
    mp = pytest.MonkeyPatch()
    inject(mp, jax_step["noise"])
    mp.setattr(F, "_gemm", record)
    try:
        tm = port_model(jax_step["np_params"])
        step = TrainStep(tm, TLoss(LOSS, 2), {})
        x = TST(T(keys), T(feats))
        with torch.no_grad():
            out = tm(x, T(q), T(lam), training=True,
                     root_nbrs=t_roots(keys, CFG))
        del calls[:]
        with profiling.recording() as rec:
            total, parts = step.loss(x, T(q), T(lam), t_roots(keys, CFG))
            total.backward()
        prepares = rec.total("taps.prepared")
    finally:
        mp.undo()
    return {"out": out, "total": float(total.detach()),
            "parts": {k: float(v.detach()) for k, v in parts.items()},
            "model": tm, "calls": calls, "prepares": prepares}


def test_region_train_masks_equal_jax(jax_step, port_step):
    """Every level's candidate keys (8 per dilated parent, SENTINEL where
    the transpose covers nothing) and the pruned prediction's keys are the
    same integers; the candidate sets are not 8 children per parent."""
    jo, to = jax_step["out"], port_step["out"]
    for lvl in range(3):
        np.testing.assert_array_equal(np.asarray(jo["candidates"][lvl].keys),
                                      to["candidates"][lvl].keys.numpy())
    np.testing.assert_array_equal(np.asarray(jo["prediction"].keys),
                                  to["prediction"].keys.numpy())
    np.testing.assert_array_equal(np.asarray(jo["k"]), to["k"].numpy())
    y_rows = int(to["likelihoods"]["y"].shape[0])
    assert to["candidates"][0].keys.shape[0] == 8 * 3 * y_rows


def test_region_train_loss_parts_match_jax(jax_step, port_step):
    assert set(port_step["parts"]) == set(jax_step["parts"])
    for k, v in jax_step["parts"].items():
        assert abs(port_step["parts"][k] - v) <= LOSS_RTOL * abs(v) + 1e-7, k
    assert abs(port_step["total"] - jax_step["total"]) \
        <= LOSS_RTOL * abs(jax_step["total"])


def test_region_train_gradients_match_jax(jax_step, port_step):
    grads = jax_step["grads"]
    tm = port_step["model"]
    assert {n for n, _ in tm.named_parameters()} == set(grads)
    for name, p in tm.named_parameters():
        ref = grads[name]
        got = p.grad.numpy() if p.grad is not None else np.zeros_like(ref)
        err = np.abs(got - ref).max()
        assert err <= GRAD_RTOL * np.abs(ref).max() + 1e-12, (name, err)
    # every conv weight of g_s receives a gradient, the region
    # transposes' through their cross maps
    for name, p in tm.g_s.named_parameters():
        if name.endswith(".w"):
            assert p.grad.abs().sum() > 0, name


def test_region_train_maps_and_prepares(port_step):
    """The three region transposes run over cross maps (rows of the
    dilated set, 3x the parents' capacity); each transposes back to
    itself.  One step prepares each tap layer once and its mirrored plan
    once, as the flagship's step does."""
    cross = [c for c in port_step["calls"] if not c[3]]
    # the three transposes and h_s's head
    assert len(cross) == 4
    assert len(port_step["calls"]) == N_TAP_LAYERS
    assert port_step["prepares"] == 2 * N_TAP_LAYERS - 1
    dilated = [c for c in cross if c[1].shape[0] == 3 * c[0]]
    assert len(dilated) == 3
    for n_src, idx, ok, _ in cross:
        ti, to = F.transposed_map(idx, ok, n_src)
        back, bok = F.transposed_map(ti, to, idx.shape[0])
        assert torch.equal(bok, ok)
        assert torch.equal(torch.where(ok, back, 0), torch.where(ok, idx, 0))


def test_region_trail_of_5_updates_matches_jax(batch, jax_step):
    """Five whole updates (loss, backward, clipping, both Adam groups) of
    the port's TrainStep against the JAX package's jitted step on the same
    batch and noise: every step's loss parts within LOSS_RTOL, and every
    parameter after the trail within 1e-2 of the size of its update."""
    keys, feats, q, lam = batch
    tx = j_optimizer(TRAIL_CFG)
    step = jax.jit(make_train_step(jax_step["model"],
                                   JLoss(LOSS, max_batch=2), tx))
    xj = JST(jnp.asarray(keys), jnp.asarray(feats))
    root = j_roots(keys, CFG)
    params = jax_step["params"]
    state = TrainState(params, tx.init(params), jnp.zeros((), jnp.int32))
    trails = {"jax": [], "port": []}
    mp = pytest.MonkeyPatch()
    inject(mp, jax_step["noise"])
    try:
        for _ in range(TRAIL):
            state, m = step(state, xj, jnp.asarray(q), jnp.asarray(lam),
                            jax.random.PRNGKey(3), root)
            trails["jax"].append({k: float(v) for k, v in m.items()})
        tm = port_model(jax_step["np_params"])
        ts = TrainStep(tm, TLoss(LOSS, 2), TRAIL_CFG)
        for _ in range(TRAIL):
            m = ts(TST(T(keys), T(feats)), T(q), T(lam), t_roots(keys, CFG))
            trails["port"].append({k: float(v) for k, v in m.items()})
    finally:
        mp.undo()
    for i, (j, p) in enumerate(zip(trails["jax"], trails["port"])):
        assert set(j) == set(p)
        for k, v in j.items():
            assert abs(p[k] - v) <= LOSS_RTOL * abs(v) + 1e-6, (i, k, p[k], v)
    ref = _flatten(jax.tree_util.tree_map(np.asarray, state.params))
    init = _flatten(jax_step["np_params"])
    for name, p in tm.named_parameters():
        moved = np.abs(ref[name] - init[name]).max()
        err = np.abs(p.detach().numpy() - ref[name]).max()
        assert err <= 1e-2 * moved + 1e-7, (name, err, moved)


def _region_cross_map(seed, n=120, span=10):
    """A region level's cross map: rows the 27-dilation of a parent set
    (3x its capacity), sources the parent set."""
    from upcc_tpu.ops import coords as JC
    rng = np.random.default_rng(seed)
    parts = []
    for b in range(2):
        u = np.unique(rng.integers(0, span, (n, 3)), axis=0)
        parts.append(JC.morton_encode_np(u) | (np.int64(b) << JC.BATCH_SHIFT))
    keys = np.sort(np.concatenate(parts))
    keys = np.concatenate([keys, np.full(9, JC.SENTINEL, np.int64)])
    d_keys = np.asarray(j_dilate(jnp.asarray(keys), 3 * len(keys)))
    idx, ok = F.cross_neighbors(T(d_keys), T(keys))
    return keys, d_keys, idx, ok


@pytest.mark.parametrize("cin,cout,seed", [(16, 16, 0), (16, 4, 1),
                                           (8, 12, 2)])
def test_region_cross_map_backward_matches_jax_vjp(cin, cout, seed):
    """On a region cross map, the port's backward of a kernel-5 transpose
    (dgrad: K1 with the mirrored plan on ``transposed_map``; wgrad: K1w's
    plain version, laid into the dense stack) against jax's vjp of the JAX
    package's ``_tap_scan_gemm`` on the same dense stack."""
    keys, d_keys, idx, ok = _region_cross_map(seed)
    n_src = len(keys)
    rng = np.random.default_rng(seed + 10)
    w = T(rng.normal(size=(125, cin, cout)).astype(np.float32))
    taps = F.prepare_train_taps(w, "transpose", 5)
    flat = T(rng.normal(size=(n_src, cin)).astype(np.float32))
    dacc = T(rng.normal(size=(len(d_keys), taps.k_out)).astype(np.float32))
    ti, to = F.transposed_map(idx, ok, n_src)
    dflat = F.tap_gemm(dacc, ti, to, taps.plan_t())
    dw = taps.plan.lay(F.tap_wgrad(flat, idx, ok, dacc, taps.plan))

    dense = taps.dense.detach().numpy()
    _, vjp = jax.vjp(lambda f, wd: JF._tap_scan_gemm(
        f, n_src, jnp.asarray(idx.numpy()), jnp.asarray(ok.numpy()), wd,
        jnp.float32), jnp.asarray(flat.numpy()), jnp.asarray(dense))
    jd_flat, jd_w = vjp(jnp.asarray(dacc.numpy()))
    np.testing.assert_allclose(dflat, np.asarray(jd_flat), rtol=1e-5,
                               atol=1e-4)
    listed = (taps.plan.lay(torch.ones(taps.plan.n_blocks, taps.plan.bk,
                                       taps.plan.bn)) != 0).numpy()
    np.testing.assert_allclose(dw, np.asarray(jd_w) * listed, rtol=1e-5,
                               atol=1e-4)
    # the blocks the plan does not list are zero in the dense stack
    assert not np.any(dense * ~listed)


def test_region_row_lists_follow_each_new_map():
    """K1w's per-tap row lists are kept on the map tensor; region training
    builds a new cross map every step, and each map gets its own lists
    (the rows with ok, per tap, ascending)."""
    for seed in (3, 4):
        _, _, _, ok = _region_cross_map(seed)
        lists, ends = F.wgrad_row_lists(ok)
        rows, taps = ok.shape
        ends = ends.numpy()
        for t in range(taps):
            lo = 0 if t == 0 else int(ends[t * rows - 1])
            hi = int(ends[(t + 1) * rows - 1])
            got = lists.numpy()[1 + lo:1 + hi] - t * rows
            np.testing.assert_array_equal(got, np.nonzero(ok[:, t].numpy())[0])


def test_chip_smoke_region_training_config_matches_yaml():
    """chip_smoke.py writes abl_region5's training keys out (the GPU host
    has no yaml); they must equal configs/ablation/abl_region5.yaml."""
    import os

    import yaml

    import chip_smoke
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    with open(os.path.join(root, "configs", "ablation",
                           "abl_region5.yaml")) as f:
        ref = yaml.safe_load(f)
    got = chip_smoke.region_train_config("/x")
    for key in ("results_path", "data_path"):
        ref.pop(key)
        got.pop(key)
    assert got == ref
