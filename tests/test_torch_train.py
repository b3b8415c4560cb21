"""The port's training path against the JAX package, on the CPU at N=16
(the widths of tests/test_trainer_e2e.py): K1's backward (the plain dgrad
and wgrad, the mirrored-plan dgrad, the self-map property of every
training map), the custom gradients, one whole training step's loss parts
and gradients, the Adam + clipping update, a tiny trainer with resume, and
the weight export read back by ``upcc_tpu``.

Noise: the JAX package draws through flax's ``make_rng``; the tests hand
both packages the same numpy-made arrays, keyed by shape (z's [C, 1, N]
noise of the bottleneck, y's [N, C] noise of the rate proxy), by patching
the draws from here.  Tolerances: loss parts within 1e-5 relative;
gradients, per parameter, max|port - jax| <= 1e-3 * max|jax| (measured
2e-5: both f32, JAX at "highest" precision, summed in other orders)."""

import os
import types

import numpy as np
import pytest
import torch

import upcc_tpu  # noqa: F401
import jax
import jax.numpy as jnp
import optax

import upcc_tpu.models.entropy.bottleneck as JB
import upcc_tpu.models.entropy.gaussian as JG
from upcc_tpu.data.synthetic import batch_of_cubes
from upcc_tpu.models import bound as JBound
from upcc_tpu.models.unified import UnifiedModel as JModel
from upcc_tpu.models.unified import host_root_maps as j_roots
from upcc_tpu.ops import family as JF
from upcc_tpu.ops.sparse import SparseTensor as JST, voxelize_host_np
from upcc_tpu.training.loss import Loss as JLoss
from upcc_tpu.training.train_step import make_optimizer as j_optimizer
from upcc_tpu.training.train_step import make_train_step
from upcc_tpu.training.trainer import make_lr_schedule as j_schedule
from upcc_tpu.utils.weights_io import load_params

import upcc_tpu_torch.models.entropy.bottleneck as TB
import upcc_tpu_torch.models.entropy.gaussian as TG
from upcc_tpu_torch.models import bound as TBound
from upcc_tpu_torch.models.unified import UnifiedModel as TModel
from upcc_tpu_torch.models.unified import host_root_maps as t_roots
from upcc_tpu_torch.ops import coords as TC
from upcc_tpu_torch.ops import family as F
from upcc_tpu_torch.ops.sparse import SparseTensor as TST
from upcc_tpu_torch.training.loss import Loss as TLoss
from upcc_tpu_torch.training.train_step import (TrainStep,
                                                clip_by_global_norm,
                                                make_lr_schedule,
                                                make_optimizer)
from upcc_tpu_torch.utils import profiling
from upcc_tpu_torch.weights import _flatten, params_from_jax, \
    save_flax_msgpack

torch.set_num_threads(2)

CFG = {
    "max_batch": 2,
    "g_a": {"C_in": 4, "N1": 16, "N2": 16, "N3": 16, "N4": 16},
    "g_s": {"C_out": 3, "N1": 16, "N2": 16, "N3": 16, "N4": 16,
            "min_one_child": True},
    "entropy_model": {"C_bottleneck": 16, "C_hyper_bottleneck": 24,
                      "quantization_mode": "ste", "inverse_rescaling": True,
                      "quantization_offset": True},
}
LOSS = {
    "focal": {"type": "Multiscale_FocalLoss", "alpha": 0.5, "gamma": 2.0},
    "color": {"type": "ColorLoss", "loss": "L2"},
    "bpp-y": {"type": "BPPLoss", "key": "y", "weight": 1.0},
    "bpp-z": {"type": "BPPLoss", "key": "z", "weight": 1.0},
}
CAP = 2048
# tap layers of the config (the kernel-2 transposes of h_s have no taps)
N_TAP_LAYERS = 18
LOSS_RTOL = 1e-5
GRAD_RTOL = 1e-3


def T(x):
    return torch.from_numpy(np.array(x))


# -- noise handed to both packages -------------------------------------------

class Noise:
    """U(-0.5, 0.5) arrays by shape, made once from a numpy seed."""

    def __init__(self, seed):
        self.rng = np.random.default_rng(seed)
        self.arrays = {}

    def __call__(self, shape):
        shape = tuple(int(s) for s in shape)
        if shape not in self.arrays:
            self.arrays[shape] = self.rng.uniform(
                -0.5, 0.5, shape).astype(np.float32)
        return self.arrays[shape]


def inject(monkeypatch, noise):
    monkeypatch.setattr(JB, "jax", types.SimpleNamespace(
        random=types.SimpleNamespace(
            uniform=lambda key, shape, *a: jnp.asarray(noise(shape))),
        lax=jax.lax, nn=jax.nn))
    monkeypatch.setattr(JG, "quantize_noise",
                        lambda v, rng: v + jnp.asarray(noise(v.shape)))
    draw = lambda shape, like, generator=None: torch.from_numpy(noise(shape))
    monkeypatch.setattr(TB, "uniform_noise", draw)
    monkeypatch.setattr(TG, "uniform_noise", draw)


# -- fixtures ------------------------------------------------------------------

@pytest.fixture(scope="module")
def batch():
    rng = np.random.default_rng(0)
    b, x, c = batch_of_cubes(rng, 2, extent=32, n_per=500, capacity=CAP)
    keys, feats = voxelize_host_np(b, x, c, CAP)
    q = np.array([[0.3, 0.7]] * 2, np.float32)
    lam = np.array([[50.0, 6000.0]] * 2, np.float32)
    return keys, feats, q, lam


@pytest.fixture(scope="module")
def jax_step(batch):
    """JAX's init and one step's (loss, parts, grads, forward) on the
    batch, through make_train_step's own loss function."""
    keys, feats, q, lam = batch
    jm = JModel(CFG)
    xj = JST(jnp.asarray(keys), jnp.asarray(feats))
    params = jax.jit(jm.init)({"params": jax.random.PRNGKey(0),
                               "noise": jax.random.PRNGKey(1)}, xj,
                              jnp.asarray(q), jnp.asarray(lam))["params"]
    step = make_train_step(jm, JLoss(LOSS, max_batch=2), j_optimizer({}))
    loss_fn = dict(zip(step.__code__.co_freevars,
                       (c.cell_contents for c in step.__closure__)))["loss_fn"]
    root = j_roots(keys, CFG)
    mp = pytest.MonkeyPatch()
    noise = Noise(7)
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
    np_tree = jax.tree_util.tree_map(np.asarray, params)
    return {"params": params, "np_params": np_tree, "total": float(total),
            "parts": {k: float(v) for k, v in parts.items()},
            "grads": _flatten(jax.tree_util.tree_map(np.asarray, grads)),
            "out": out, "noise": noise, "model": jm}


def port_model(np_params):
    tm = TModel(CFG)
    tm.load_state_dict(params_from_jax(np_params, tm))
    return tm


# -- K1's backward -------------------------------------------------------------

SHAPES = [("conv", 3, 4, 6), ("conv", 5, 4, 4), ("down", 5, 4, 8),
          ("transpose", 5, 8, 4), ("grand_conv", 3, 2, 2),
          ("grand_transpose", 5, 4, 2), ("grand_down", 5, 2, 4)]


def _random_call(kind, ks, cin, cout, rows=40, n_src=30, seed=0):
    rng = np.random.default_rng(seed)
    w = rng.normal(size=(ks ** 3, cin, cout)).astype(np.float32)
    dense = F._dense_taps(T(w), kind, ks)
    flat = rng.normal(size=(n_src, dense.shape[1])).astype(np.float32)
    idx = rng.integers(0, n_src + 5, (rows, 27)).astype(np.int32)
    ok = rng.random((rows, 27)) < 0.7
    dacc = rng.normal(size=(rows, dense.shape[2])).astype(np.float32)
    return w, dense, flat, idx, ok, dacc


@pytest.mark.parametrize("kind,ks,cin,cout", SHAPES)
def test_tap_backward_plain_matches_autograd_and_jax(kind, ks, cin, cout):
    """tap_dgrad_plain / tap_wgrad_plain against torch.autograd through
    tap_gemm_plain and against jax's vjp of _tap_scan_gemm, to f32
    rounding, on each call shape."""
    _, dense, flat, idx, ok, dacc = _random_call(kind, ks, cin, cout)
    n_src = flat.shape[0]
    ft = T(flat).requires_grad_()
    wt = dense.clone().requires_grad_()
    F.tap_gemm_plain(ft, T(idx), T(ok), wt).backward(T(dacc))
    dflat = F.tap_dgrad_plain(T(dacc), T(idx), T(ok), dense, n_src)
    dw = F.tap_wgrad_plain(T(flat), T(idx), T(ok), T(dacc))
    np.testing.assert_allclose(dflat, ft.grad, rtol=1e-5, atol=1e-4)
    np.testing.assert_allclose(dw, wt.grad, rtol=1e-5, atol=1e-4)

    _, vjp = jax.vjp(lambda f, w: JF._tap_scan_gemm(
        f, n_src, jnp.asarray(idx), jnp.asarray(ok), w, jnp.float32),
        jnp.asarray(flat), jnp.asarray(dense.numpy()))
    jd_flat, jd_w = vjp(jnp.asarray(dacc))
    np.testing.assert_allclose(dflat, np.asarray(jd_flat), rtol=1e-5,
                               atol=1e-4)
    np.testing.assert_allclose(dw, np.asarray(jd_w), rtol=1e-5, atol=1e-4)


def _key_set(n, extent, seed):
    rng = np.random.default_rng(seed)
    units = rng.integers(0, extent, (n, 3)).astype(np.int32)
    b = rng.integers(0, 2, n)
    return torch.unique(TC.make_keys(T(b), T(units)))


@pytest.mark.parametrize("kind,ks,cin,cout", SHAPES)
def test_mirrored_plan_dgrad_equals_plain_dgrad(kind, ks, cin, cout):
    """On a self map, K1 with the mirrored, transposed plan is the dgrad;
    the listed-block wgrad is the dense wgrad's listed blocks."""
    keys = _key_set(300, 12, 1)
    idx, ok = F.root_neighbors(keys)
    n = keys.shape[0]
    rng = np.random.default_rng(2)
    w = T(rng.normal(size=(ks ** 3, cin, cout)).astype(np.float32))
    taps = F.prepare_train_taps(w, kind, ks)
    dacc = T(rng.normal(size=(n, taps.k_out)).astype(np.float32))
    flat = T(rng.normal(size=(n, taps.plan.k_in)).astype(np.float32))
    got = F.tap_gemm(dacc, idx, ok, taps.plan_t())
    ref = F.tap_dgrad_plain(dacc, idx, ok, taps.plan, n)
    np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-4)
    blocks = F.tap_wgrad(flat, idx, ok, dacc, taps.plan)
    dense = F.tap_wgrad_plain(flat, idx, ok, dacc)
    assert blocks.shape == (taps.plan.n_blocks, taps.plan.bk, taps.plan.bn)
    listed = taps.plan.lay(torch.ones_like(blocks)) != 0
    np.testing.assert_allclose(taps.plan.lay(blocks), dense * listed,
                               rtol=1e-5, atol=1e-4)


def test_cross_map_dgrad_through_transposed_map():
    """A cross map's dgrad: K1 on its scattered transposed map with the
    mirrored plan equals the plain scatter-add."""
    out_keys = _key_set(200, 10, 3)
    in_keys = _key_set(260, 10, 4)
    idx, ok = F.cross_neighbors(out_keys, in_keys)
    rng = np.random.default_rng(5)
    w = T(rng.normal(size=(27, 4, 4)).astype(np.float32))
    taps = F.prepare_train_taps(w, "conv", 3)
    n_src = in_keys.shape[0]
    dacc = T(rng.normal(size=(out_keys.shape[0], taps.k_out))
             .astype(np.float32))
    ti, to = F.transposed_map(idx, ok, n_src)
    got = F.tap_gemm(dacc, ti, to, taps.plan_t())
    ref = F.tap_dgrad_plain(dacc, idx, ok, taps.plan, n_src)
    np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-4)


def test_training_forward_maps_and_prepares(batch, jax_step, monkeypatch):
    """Every K1 call of a training forward: self maps satisfy
    ok[r, k] => idx[idx[r, k], 26-k] == r (with rows = sources); the one
    cross map (h_s's head) transposes back to itself.  One step prepares
    each tap layer once and its mirrored plan once (g_a's first layer has
    no dgrad)."""
    keys, feats, q, lam = batch
    tm = port_model(jax_step["np_params"])
    calls = []
    gemm = F._gemm

    def record(flat, idx, ok, w, self_map=True):
        calls.append((flat.shape[0], idx, ok, self_map))
        return gemm(flat, idx, ok, w, self_map)
    monkeypatch.setattr(F, "_gemm", record)
    step = TrainStep(tm, TLoss(LOSS, 2), {})
    with profiling.recording() as rec:
        step(TST(T(keys), T(feats)), T(q), T(lam), t_roots(keys, CFG))
    assert rec.total("taps.prepared") == 2 * N_TAP_LAYERS - 1
    assert len(calls) == N_TAP_LAYERS
    mirror = torch.arange(26, -1, -1)
    cross = 0
    for n_src, idx, ok, self_map in calls:
        if not self_map:
            cross += 1
            ti, to = F.transposed_map(idx, ok, n_src)
            back, bok = F.transposed_map(ti, to, idx.shape[0])
            assert torch.equal(bok, ok)
            assert torch.equal(torch.where(ok, back, 0),
                               torch.where(ok, idx, 0))
            continue
        assert idx.shape[0] == n_src
        rows = torch.arange(idx.shape[0])[:, None].expand_as(idx)
        back = idx.long()[idx.long(), mirror[None, :]]
        assert bool(torch.all(~ok | (back == rows)))
        back_ok = ok[idx.long(), mirror[None, :]]
        assert bool(torch.all(~ok | back_ok))
    assert cross == 1


# -- custom gradients ----------------------------------------------------------

def test_lower_bound_and_quantize_ste_gradients_match_jax():
    rng = np.random.default_rng(0)
    x = rng.normal(size=200).astype(np.float32) * 0.3
    x[:5] = 0.11  # at the bound
    g = rng.normal(size=200).astype(np.float32)
    for fj, ft in ((lambda v: JBound.lower_bound(v, 0.11),
                    lambda v: TBound.lower_bound(v, 0.11)),
                   (JBound.quantize_ste, TBound.quantize_ste)):
        yj, vjp = jax.vjp(fj, jnp.asarray(x))
        xt = T(x).requires_grad_()
        yt = ft(xt)
        yt.backward(T(g))
        np.testing.assert_array_equal(yt.detach().numpy(), np.asarray(yj))
        np.testing.assert_array_equal(xt.grad.numpy(),
                                      np.asarray(vjp(jnp.asarray(g))[0]))


# -- one training step against JAX --------------------------------------------

@pytest.fixture(scope="module")
def port_step(batch, jax_step):
    keys, feats, q, lam = batch
    mp = pytest.MonkeyPatch()
    inject(mp, jax_step["noise"])
    try:
        tm = port_model(jax_step["np_params"])
        step = TrainStep(tm, TLoss(LOSS, 2), {})
        x = TST(T(keys), T(feats))
        out = tm(x, T(q), T(lam), root_nbrs=t_roots(keys, CFG))
        total, parts = step.loss(x, T(q), T(lam), t_roots(keys, CFG))
        total.backward()
    finally:
        mp.undo()
    return {"out": out, "total": float(total.detach()),
            "parts": {k: float(v.detach()) for k, v in parts.items()},
            "model": tm}


def test_train_step_masks_equal_jax(jax_step, port_step):
    """First the top-k masks: every level's candidate keys and the pruned
    prediction's keys are the same integers."""
    jo, to = jax_step["out"], port_step["out"]
    for lvl in range(3):
        np.testing.assert_array_equal(np.asarray(jo["candidates"][lvl].keys),
                                      to["candidates"][lvl].keys.numpy())
    np.testing.assert_array_equal(np.asarray(jo["prediction"].keys),
                                  to["prediction"].keys.numpy())
    np.testing.assert_array_equal(np.asarray(jo["k"]), to["k"].numpy())


def test_train_step_loss_parts_match_jax(jax_step, port_step):
    assert set(port_step["parts"]) == set(jax_step["parts"])
    for k, v in jax_step["parts"].items():
        assert abs(port_step["parts"][k] - v) <= LOSS_RTOL * abs(v) + 1e-7, k
    assert abs(port_step["total"] - jax_step["total"]) \
        <= LOSS_RTOL * abs(jax_step["total"])


def test_train_step_gradients_match_jax(jax_step, port_step):
    grads = jax_step["grads"]
    tm = port_step["model"]
    names = [n for n, _ in tm.named_parameters()]
    assert set(names) == set(grads)
    for name, p in tm.named_parameters():
        ref = grads[name]
        got = p.grad.numpy() if p.grad is not None else np.zeros_like(ref)
        err = np.abs(got - ref).max()
        assert err <= GRAD_RTOL * np.abs(ref).max() + 1e-12, (name, err)


def test_quantiles_gradient_comes_from_aux_only(batch, jax_step):
    """The main loss never reaches ``quantiles``; the aux loss reaches
    nothing else."""
    keys, feats, q, lam = batch
    mp = pytest.MonkeyPatch()
    inject(mp, jax_step["noise"])
    try:
        tm = port_model(jax_step["np_params"])
        out = tm(TST(T(keys), T(feats)), T(q), T(lam),
                 root_nbrs=t_roots(keys, CFG))
        main, _ = TLoss(LOSS, 2)(TST(T(keys), T(feats)), out)
        main.backward()
    finally:
        mp.undo()
    qp = tm.entropy_model.bottleneck.quantiles
    assert qp.grad is None or not qp.grad.any()
    tm.zero_grad(set_to_none=True)
    tm.aux_loss().backward()
    for name, p in tm.named_parameters():
        if name.endswith("quantiles"):
            assert p.grad is not None and p.grad.abs().sum() > 0
        else:
            assert p.grad is None or not p.grad.any(), name


def test_adam_and_clipping_match_optax():
    """Three updates of two groups (main clipped by optax's global-norm
    rule at a StepLR rate, quantiles at their own rate) against the JAX
    package's optimizer."""
    cfg = {"model_learning_rate": 3e-3, "bottleneck_learning_rate": 1e-2,
           "clip_grad_norm": 0.5, "scheduler_step_size": 1,
           "scheduler_gamma": 0.5}
    rng = np.random.default_rng(0)
    shapes = {"a": {"w": (3, 4), "b": (4,)},
              "bottleneck": {"quantiles": (2, 1, 3), "bias_0": (2, 3, 1)}}
    params = {g: {k: rng.normal(size=s).astype(np.float32)
                  for k, s in d.items()} for g, d in shapes.items()}
    grads = [{g: {k: rng.normal(size=s).astype(np.float32) * scale
                  for k, s in d.items()} for g, d in shapes.items()}
             for scale in (3.0, 0.01, 1.0)]
    tx = j_optimizer(cfg, lr_schedule=j_schedule(cfg, 2))
    jp = jax.tree_util.tree_map(jnp.asarray, params)
    state = tx.init(jp)
    for g in grads:
        upd, state = tx.update(jax.tree_util.tree_map(jnp.asarray, g),
                               state, jp)
        jp = optax.apply_updates(jp, upd)

    module = torch.nn.Module()
    for g, d in params.items():
        sub = torch.nn.Module()
        for k, v in d.items():
            sub.register_parameter(k, torch.nn.Parameter(T(v)))
        module.add_module(g, sub)
    opt = make_optimizer(module, cfg)
    sched = make_lr_schedule(cfg, 2)
    main, _ = opt.param_groups
    for i, g in enumerate(grads):
        for name, p in module.named_parameters():
            grp, leaf = name.split(".")
            p.grad = T(g[grp][leaf])
        clip_by_global_norm(main["params"], cfg["clip_grad_norm"])
        main["lr"] = sched(i)
        opt.step()
    for name, p in module.named_parameters():
        grp, leaf = name.split(".")
        np.testing.assert_allclose(p.detach().numpy(),
                                   np.asarray(jp[grp][leaf]), rtol=1e-5,
                                   atol=1e-6)


# -- export ---------------------------------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_export_loads_under_jax(jax_step, batch, tmp_path, dtype):
    """Weights written by the port load with upcc_tpu's load_params (every
    leaf equal, bf16-rounded for the compact snapshot) and give the same
    analysis-transform outputs in both packages."""
    keys, feats, _, _ = batch
    tm = port_model(jax_step["np_params"])
    with torch.no_grad():
        for p in tm.parameters():  # weights that differ from the init
            p.add_(0.01 * torch.randn_like(p))
    path = str(tmp_path / "w.msgpack")
    save_flax_msgpack(tm, path, dtype)
    loaded = load_params(jax_step["params"], path)
    flat = _flatten(jax.tree_util.tree_map(np.asarray, loaded))
    sd = tm.state_dict()
    assert set(flat) == set(sd)
    for name, v in sd.items():
        want = v.numpy() if dtype == "float32" else \
            v.to(torch.bfloat16).float().numpy()
        np.testing.assert_array_equal(flat[name], want)
    jm = jax_step["model"]
    root = j_roots(keys, CFG)["ga"]
    ref = jax.jit(lambda p: jm.apply(
        {"params": p}, JST(jnp.asarray(keys), jnp.asarray(feats)), root,
        method=jm.ga_device))(loaded)
    tm2 = port_model(flat_tree(flat))
    with torch.no_grad():
        got = tm2.ga_device(TST(T(keys), T(feats)),
                            t_roots(keys, CFG)["ga"])
    np.testing.assert_array_equal(np.asarray(ref["y_keys"]),
                                  got["y_keys"].numpy())
    np.testing.assert_allclose(got["y_feats"].numpy(),
                               np.asarray(ref["y_feats"]), rtol=1e-4,
                               atol=1e-4)


def flat_tree(flat):
    tree = {}
    for name, v in flat.items():
        node = tree
        *path, leaf = name.split(".")
        for part in path:
            node = node.setdefault(part, {})
        node[leaf] = v
    return tree


# -- the trainer ------------------------------------------------------------------

def test_tiny_training_end_to_end_with_resume(tmp_path):
    """Training on a tiny synthetic set: 2 epochs x 3 steps with one
    validation through real bitstreams; the files the JAX trainer writes;
    a second Training resumes from the newest checkpoint."""
    from upcc_tpu_torch.data.dataset import write_split
    from upcc_tpu_torch.data.synthetic import surface_cloud
    from upcc_tpu_torch.training.trainer import Training
    ds = tmp_path / "dataset"
    ds.mkdir()
    rng = np.random.default_rng(0)
    for split, n in [("train", 12), ("val", 1), ("test", 1)]:
        pts, cols = zip(*[surface_cloud(rng, extent=32, n_target=400)
                          for _ in range(n)])
        write_split(str(ds / f"{split}.npz"), list(pts), list(cols))
    cfg = {
        "experiment_name": "tiny_exp", "results_path": str(tmp_path / "res"),
        "model": {k: dict(v) for k, v in CFG.items() if k != "max_batch"},
        "data_path": str(ds), "min_points_train": 10,
        "transforms": {"train": {
            "1_ColorJitter": {"key": "ColorJitter"},
            "2_Rotate": {"key": "RandomRotate", "block_size": 32}}},
        "q_map": {"lambda_A_min": 0, "lambda_A_max": 12800,
                  "lambda_G_min": 0, "lambda_G_max": 200,
                  "mode": "quadratic"},
        "epochs": 2, "batch_size": 2, "val_every": 2, "loss": LOSS,
    }
    tr = Training(cfg, capacity=1024, max_steps_per_epoch=3, device="cpu",
                  renders=False)
    tr.train()
    exp = tmp_path / "res" / "tiny_exp"
    for name in ("config.yaml", "weights.msgpack", "weights_bf16.msgpack",
                 "weights.msgpack.meta.json", "val.csv"):
        assert (exp / name).exists(), name
    assert sorted(os.listdir(exp / "ckpts")) == ["ckpt_000.pt",
                                                 "ckpt_001.pt"]
    rows = (exp / "val.csv").read_text().splitlines()
    assert len(rows) == 5 and rows[0].startswith("epoch,item,q_g,q_a,bpp")
    cfg["epochs"] = 3
    tr2 = Training(cfg, capacity=1024, max_steps_per_epoch=3, device="cpu",
                   renders=False)
    assert tr2.start_epoch == 2 and tr2.step_fn.step == 6
    for a, b in zip(tr.model.state_dict().values(),
                    tr2.model.state_dict().values()):
        assert torch.equal(a, b)
    for pa, pb in zip(tr.step_fn.optimizer.state_dict()["state"].values(),
                      tr2.step_fn.optimizer.state_dict()["state"].values()):
        assert torch.equal(pa["exp_avg"], pb["exp_avg"])


def test_chip_smoke_training_config_matches_yaml():
    """chip_smoke.py writes the flagship's training keys out (the GPU host
    has no yaml); they must equal configs/CVPR_inverse_scaling.yaml."""
    import yaml

    import chip_smoke
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    with open(os.path.join(root, "configs", "CVPR_inverse_scaling.yaml")) as f:
        ref = yaml.safe_load(f)
    got = chip_smoke.train_config("/x")
    for key in ("results_path", "data_path"):
        ref.pop(key)
        got.pop(key)
    assert got == ref


# -- the ops the losses and SparseConv use ---------------------------------------

def _sparse_pair(n, extent, seed, channels=3, stride=1):
    from upcc_tpu.ops.sparse import from_points as j_from_points
    from upcc_tpu_torch.ops.sparse import from_points as t_from_points
    rng = np.random.default_rng(seed)
    b = rng.integers(0, 2, n).astype(np.int32)
    b[-5:] = -1
    xyz = rng.integers(0, extent, (n, 3)).astype(np.int32)
    f = rng.normal(size=(n, channels)).astype(np.float32)
    cap = n + 16
    js = j_from_points(jnp.asarray(b), jnp.asarray(xyz), jnp.asarray(f), cap,
                       stride=stride)
    ts = t_from_points(T(b), T(xyz), T(f), cap, stride=stride)
    return js, ts


def test_sparse_helpers_match_jax():
    """from_points (dedup, first occurrence wins), lookup, features_at,
    concat, with_feats and mask_feats."""
    from upcc_tpu.ops import sparse as JS
    from upcc_tpu_torch.ops import sparse as TS
    js, ts = _sparse_pair(400, 8, 0)
    np.testing.assert_array_equal(np.asarray(js.keys), ts.keys.numpy())
    np.testing.assert_array_equal(np.asarray(js.feats), ts.feats.numpy())
    js2, ts2 = _sparse_pair(300, 8, 1)
    ji, jf = JS.lookup(js, js2.keys)
    ti, tf = TS.lookup(ts, ts2.keys)
    np.testing.assert_array_equal(np.asarray(ji), ti.numpy())
    np.testing.assert_array_equal(np.asarray(jf), tf.numpy())
    np.testing.assert_array_equal(np.asarray(JS.features_at(js, js2.keys)),
                                  TS.features_at(ts, ts2.keys).numpy())
    jc, tc = JS.concat([js, js2], 500), TS.concat([ts, ts2], 500)
    np.testing.assert_array_equal(np.asarray(jc.keys), tc.keys.numpy())
    np.testing.assert_array_equal(np.asarray(jc.feats), tc.feats.numpy())
    np.testing.assert_array_equal(np.asarray(js.mask_feats()),
                                  TS.mask_feats(ts).numpy())
    assert TS.with_feats(ts, ts.feats * 2, stride=4).stride == 4


@pytest.mark.parametrize("mode", ["same", "down", "up"])
def test_conv_ops_match_jax(mode):
    """apply_sparse_conv / apply_channelwise_conv / apply_avg_pool of
    ops/conv.py against the JAX package's on the same key sets."""
    from upcc_tpu.ops import conv as JCV
    from upcc_tpu.ops.sparse import downsample_keys as j_down
    from upcc_tpu.ops.sparse import upsample_children_keys as j_up
    from upcc_tpu_torch.ops import conv as TCV
    js, ts = _sparse_pair(500, 10, 2, channels=4)
    if mode == "same":
        out = np.asarray(js.keys)
    elif mode == "down":
        out = np.asarray(j_down(js.keys))
    else:
        out = np.asarray(j_up(js.keys))[:1024]
    offs = TC.kernel_offsets(3 if mode != "up" else 2)
    rng = np.random.default_rng(3)
    w = rng.normal(size=(len(offs), 4, 5)).astype(np.float32)
    b = rng.normal(size=5).astype(np.float32)
    wc = rng.normal(size=(len(offs), 4)).astype(np.float32)
    ref = JCV.apply_sparse_conv(js, jnp.asarray(out), jnp.asarray(w),
                                jnp.asarray(b), offs, mode, 1)
    got = TCV.apply_sparse_conv(ts, T(out), T(w), T(b), offs, mode, 1)
    np.testing.assert_allclose(got.feats, np.asarray(ref.feats), rtol=1e-5,
                               atol=1e-5)
    ref = JCV.apply_channelwise_conv(js, jnp.asarray(out), jnp.asarray(wc),
                                     offs, mode, 1)
    got = TCV.apply_channelwise_conv(ts, T(out), T(wc), offs, mode, 1)
    np.testing.assert_allclose(got.feats, np.asarray(ref.feats), rtol=1e-5,
                               atol=1e-5)
    ref = JCV.apply_avg_pool(js, jnp.asarray(out), offs, mode, 1)
    got = TCV.apply_avg_pool(ts, T(out), offs, mode, 1)
    np.testing.assert_allclose(got.feats, np.asarray(ref.feats), rtol=1e-5,
                               atol=1e-6)


def test_sparse_conv_layer_and_shepards_loss_match_jax():
    """layers.SparseConv on flax's parameters, and the Shepard loss (its
    window-9 channelwise conv) with its gradient to the prediction."""
    from upcc_tpu.models.layers import SparseConv as JSC
    from upcc_tpu.training import loss as JL
    from upcc_tpu_torch.models import layers as TL
    from upcc_tpu_torch.training import loss as TLmod
    js, ts = _sparse_pair(400, 9, 4)
    jl = JSC(3, 6, 3)
    p = jl.init(jax.random.PRNGKey(0), js)["params"]
    tl = TL.SparseConv(3, 6, 3)
    tl.load_state_dict({k: T(np.asarray(v)) for k, v in p.items()})
    np.testing.assert_allclose(tl(ts).feats.detach().numpy(),
                               np.asarray(jl.apply({"params": p}, js).feats),
                               rtol=1e-5, atol=1e-5)
    pj, pt = _sparse_pair(300, 9, 5)
    q_map = np.array([[10.0, 300.0], [20.0, 50.0]], np.float32)
    ref, vjp = jax.vjp(lambda f: JL.shepards_loss(
        js, pj.replace(feats=f), jnp.asarray(q_map), window_size=5, p=4,
        max_batch=2), pj.feats)
    f = pt.feats.clone().requires_grad_()
    got = TLmod.shepards_loss(ts, pt.replace(feats=f), T(q_map),
                              window_size=5, p=4, max_batch=2)
    got.backward()
    assert abs(float(got.detach()) - float(ref)) <= 1e-5 * abs(float(ref))
    np.testing.assert_allclose(f.grad, np.asarray(vjp(jnp.ones((), jnp.float32))[0]),
                               rtol=1e-4, atol=1e-7)


def test_two_train_steps_match_jax(batch, jax_step):
    """Two whole updates (loss, backward, clipping, both Adam groups) of the
    port's TrainStep against two of the JAX package's jitted step on the
    same batch and noise: every parameter within 1e-2 of the size of its
    update (Adam divides by sqrt(v), which enlarges the f32 differences of
    small gradients: measured 1.4e-3 at worst)."""
    from upcc_tpu.training.train_step import TrainState
    keys, feats, q, lam = batch
    cfg = {"model_learning_rate": 1e-3, "bottleneck_learning_rate": 1e-2,
           "clip_grad_norm": 1.0}
    jm = jax_step["model"]
    tx = j_optimizer(cfg)
    step = jax.jit(make_train_step(jm, JLoss(LOSS, max_batch=2), tx))
    xj = JST(jnp.asarray(keys), jnp.asarray(feats))
    root = j_roots(keys, CFG)
    params = jax_step["params"]
    state = TrainState(params, tx.init(params), jnp.zeros((), jnp.int32))
    mp = pytest.MonkeyPatch()
    inject(mp, jax_step["noise"])
    try:
        for _ in range(2):
            state, _ = step(state, xj, jnp.asarray(q), jnp.asarray(lam),
                            jax.random.PRNGKey(3), root)
        tm = port_model(jax_step["np_params"])
        ts = TrainStep(tm, TLoss(LOSS, 2), cfg)
        for _ in range(2):
            ts(TST(T(keys), T(feats)), T(q), T(lam), t_roots(keys, CFG))
    finally:
        mp.undo()
    ref = _flatten(jax.tree_util.tree_map(np.asarray, state.params))
    init = _flatten(jax_step["np_params"])
    for name, p in tm.named_parameters():
        moved = np.abs(ref[name] - init[name]).max()
        err = np.abs(p.detach().numpy() - ref[name]).max()
        assert err <= 1e-2 * moved + 1e-7, (name, err, moved)


def test_loss_trail_over_20_steps_matches_jax(batch, jax_step):
    """20 whole updates at the flagship's learning rates (main 1e-4,
    quantiles 1e-3, clip 1.0) from the same init, on one fixed batch with
    fixed noise: every step's loss parts within LOSS_RTOL of the JAX
    package's.  Neither trail falls at every step (the RD loss rises at
    step 3 in both); the port's trail is JAX's.  ``pytest -rP`` prints
    both trails."""
    from upcc_tpu.training.train_step import TrainState
    keys, feats, q, lam = batch
    cfg = {"model_learning_rate": 1e-4, "bottleneck_learning_rate": 1e-3,
           "clip_grad_norm": 1.0}
    tx = j_optimizer(cfg)
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
        for _ in range(20):
            state, m = step(state, xj, jnp.asarray(q), jnp.asarray(lam),
                            jax.random.PRNGKey(3), root)
            trails["jax"].append({k: float(v) for k, v in m.items()})
        ts = TrainStep(port_model(jax_step["np_params"]), TLoss(LOSS, 2), cfg)
        for _ in range(20):
            m = ts(TST(T(keys), T(feats)), T(q), T(lam), t_roots(keys, CFG))
            trails["port"].append({k: float(v) for k, v in m.items()})
    finally:
        mp.undo()
    for name, trail in trails.items():
        print(f"{name} loss: " + " ".join(f"{t['loss']:.4f}" for t in trail))
        print(f"{name} RD loss (without aux): " + " ".join(
            f"{t['loss'] - t['aux_loss']:.4f}" for t in trail))
    for i, (j, p) in enumerate(zip(trails["jax"], trails["port"])):
        assert set(j) == set(p)
        for k, v in j.items():
            assert abs(p[k] - v) <= LOSS_RTOL * abs(v) + 1e-6, (i, k, p[k], v)
