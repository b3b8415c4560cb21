"""The port's multi-rank training steps against the JAX package, on the
CPU over gloo with spawned ranks, at the widths of tests/test_parallel.py
(N=8, C_bottleneck 8, C_hyper 12): the data-parallel step on 2 ranks and
the 2-D (data x model) step on a 2x2 mesh, each against the mean of JAX's
per-shard gradients through the JAX package's optimizer
(tests/test_torch_parallel_mesh.py has the rest of the parallel package).

The clip binds (JAX's mean-gradient norm is ~3000, the clip 1), and the
gradients are held where the step clips, before the optimizer: after
Adam's first update a parameter has moved by about lr * sign(g), which
shows neither the gradient's size nor the clip.

Tolerances: the loss within 2e-4 relative of the mean of JAX's per-shard
losses (tests/test_parallel.py's own); each gradient, before and after
clipping, within 1e-3 of its tensor's largest |value|, and the norm within
1e-3 of JAX's (tests/test_torch_train.py's gradient tolerance); the norm
within 1e-5 of the norm of the recorded gradients (measured 9e-8; leaving
out the model peer's shards moves it by 4e-5, as the shards hold 2e-4 of
the squares here); each parameter after the update within 1e-2 of the
size of its update (tests/test_torch_train.py's)."""


import numpy as np
import pytest
import torch

import upcc_tpu  # noqa: F401
import jax
import jax.numpy as jnp
import optax

from upcc_tpu.data.synthetic import batch_of_cubes
from upcc_tpu.models.unified import UnifiedModel as JModel
from upcc_tpu.models.unified import host_root_maps as j_roots
from upcc_tpu.ops.sparse import SparseTensor as JST
from upcc_tpu.ops.sparse import voxelize_host_np
from upcc_tpu.training.loss import Loss as JLoss
from upcc_tpu.training.train_step import make_optimizer as j_optimizer
from upcc_tpu.training.train_step import make_train_step

from upcc_tpu_torch.models.unified import UnifiedModel as TModel
from upcc_tpu_torch.parallel import multihost
from upcc_tpu_torch.parallel.model_parallel import sharded
from upcc_tpu_torch.weights import _flatten
from test_torch_train import GRAD_RTOL, LOSS, Noise, inject
import torch_dist_ranks as ranks

torch.set_num_threads(2)

CFG = {
    "max_batch": 1,
    "g_a": {"C_in": 4, "N1": 8, "N2": 8, "N3": 8, "N4": 8},
    "g_s": {"C_out": 3, "N1": 8, "N2": 8, "N3": 8, "N4": 8},
    "entropy_model": {"C_bottleneck": 8, "C_hyper_bottleneck": 12,
                      "quantization_mode": "ste", "inverse_rescaling": True,
                      "quantization_offset": True},
}
RATES = {"model_learning_rate": 1e-3, "bottleneck_learning_rate": 1e-2,
         "clip_grad_norm": 1.0}
CAP = 512
LOSS_RTOL = 2e-4
NORM_RTOL = 1e-5
# g_a's last layer scaled from its init, so that the latents do not all
# round to 0 (then every g_s conv weight gets a gradient)
LATENT_SCALE = 30.0


@pytest.fixture(scope="module")
def shards():
    """Two data shards: (keys, feats, q, lam) each, own q and lambda."""
    out = []
    for d, (q, lam) in enumerate([((0.3, 0.7), (50.0, 6000.0)),
                                  ((0.8, 0.2), (120.0, 900.0))]):
        b, x, c = batch_of_cubes(np.random.default_rng(d), 1, extent=16,
                                 n_per=150, capacity=CAP)
        keys, feats = voxelize_host_np(b, x, c, CAP)
        out.append((keys, feats, np.array([q], np.float32),
                    np.array([lam], np.float32)))
    return out


@pytest.fixture(scope="module")
def jax_ref(shards):
    """JAX's init, each shard's loss, and one update on the mean of the
    shards' gradients through make_optimizer."""
    jm = JModel(CFG)
    keys, feats, q, lam = shards[0]
    init = jax.jit(jm.init)({"params": jax.random.PRNGKey(0),
                             "noise": jax.random.PRNGKey(1)},
                            JST(jnp.asarray(keys), jnp.asarray(feats)),
                            jnp.asarray(q), jnp.asarray(lam))["params"]
    init = jax.tree_util.tree_map_with_path(
        lambda path, v: v * LATENT_SCALE
        if [getattr(k, "key", None) for k in path] == ["g_a", "conv4", "w"]
        else v, init)
    tx = j_optimizer(RATES)
    step = make_train_step(jm, JLoss(LOSS, max_batch=1), tx)
    loss_fn = dict(zip(step.__code__.co_freevars,
                       (c.cell_contents for c in step.__closure__)))["loss_fn"]
    grad_fn = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))
    noise = Noise(3)
    mp = pytest.MonkeyPatch()
    inject(mp, noise)
    try:
        losses, grads = [], []
        for keys, feats, q, lam in shards:
            (total, _), g = grad_fn(init, JST(jnp.asarray(keys),
                                              jnp.asarray(feats)),
                                    jnp.asarray(q), jnp.asarray(lam),
                                    jax.random.PRNGKey(3),
                                    j_roots(keys, CFG))
            losses.append(float(total))
            grads.append(g)
    finally:
        mp.undo()
    mean = jax.tree_util.tree_map(lambda *g: sum(g) / len(g), *grads)
    upd, _ = tx.update(mean, tx.init(init), init)
    new = optax.apply_updates(init, upd)
    np_init = jax.tree_util.tree_map(np.asarray, init)
    grad = _flatten(jax.tree_util.tree_map(np.asarray, mean))
    main = {n: g for n, g in grad.items() if not n.endswith("quantiles")}
    norm = float(optax.global_norm(main))
    clip = RATES["clip_grad_norm"]
    return {"init": np_init, "init_flat": _flatten(np_init),
            "new": _flatten(jax.tree_util.tree_map(np.asarray, new)),
            "grad": grad, "norm": norm,
            "clipped": {n: g if norm < clip else g / norm * clip
                        for n, g in main.items()},
            "losses": losses, "noise": dict(noise.arrays)}


def _check_gradients(out, jax_ref, n_model=1):
    """Where each rank clips: its gradients (a sharded leaf's: its slice)
    against JAX's mean gradient, and after clipping against JAX's clipped
    one, each within GRAD_RTOL of the tensor's largest |value|; the norm
    it clips by against JAX's, and against the norm of its data row's
    gradients as recorded (the model peers' slices once each, the
    replicated leaves once) within NORM_RTOL."""
    assert jax_ref["norm"] > 4 * RATES["clip_grad_norm"]  # the clip binds
    for o in out:
        log, m = o["clipped"], o.get("model_index", 0)
        for which in ("pre", "post"):
            ref_all = jax_ref["grad" if which == "pre" else "clipped"]
            for name, ref in ref_all.items():
                if sharded(ref.shape, n_model):
                    c = ref.shape[-1] // n_model
                    ref = ref[..., m * c:(m + 1) * c]
                got = log[which].get(name, np.zeros_like(ref))
                err = np.abs(got - ref).max()
                assert err <= GRAD_RTOL * np.abs(ref).max() + 1e-12, \
                    (which, name, err)
        assert abs(log["norm"] - jax_ref["norm"]) \
            <= GRAD_RTOL * jax_ref["norm"]
    row = out[:n_model]  # data row 0
    sq = 0.0
    for name, g in row[0]["clipped"]["pre"].items():
        if name.endswith("quantiles"):
            continue
        peers = row if sharded(jax_ref["grad"][name].shape, n_model) \
            else row[:1]
        sq += sum(np.sum(o["clipped"]["pre"][name].astype(np.float64) ** 2)
                  for o in peers)
    for o in row:
        assert abs(o["clipped"]["norm"] - np.sqrt(sq)) \
            <= NORM_RTOL * np.sqrt(sq), (o["clipped"]["norm"], np.sqrt(sq))


def _check_update(params, jax_ref):
    for name, ref in jax_ref["new"].items():
        moved = np.abs(ref - jax_ref["init_flat"][name]).max()
        err = np.abs(params[name] - ref).max()
        assert err <= 1e-2 * moved + 1e-7, (name, err, moved)


def test_data_parallel_two_ranks_matches_jax(shards, jax_ref, tmp_path):
    """Two gloo ranks, one shard each: the step's loss is the mean of
    JAX's per-shard losses; the updated parameters are JAX's update on the
    mean gradient; both replicas hold the same bits."""
    multihost.spawn(ranks.dp_rank, 2, (CFG, LOSS, RATES, jax_ref["init"],
                                       shards, jax_ref["noise"],
                                       str(tmp_path)), device="cpu")
    out = ranks.load(str(tmp_path), 2)
    assert out[0]["hash"] == out[1]["hash"]
    for o in out:
        np.testing.assert_allclose(o["metrics"]["loss"],
                                   np.mean(jax_ref["losses"]), rtol=LOSS_RTOL)
    _check_gradients(out, jax_ref)
    _check_update(out[0]["params"], jax_ref)


def test_sharded_2x2_matches_jax_and_halves_sharded_leaves(shards, jax_ref,
                                                           tmp_path):
    """A 2x2 (data x model) mesh on 4 gloo ranks, data row d on shard d:
    the same loss and update as the JAX reference (which a 1x1 mesh
    computes); all four ranks gather the same parameters; each rank holds
    half of every sharded leaf and its Adam moments."""
    multihost.spawn(ranks.sharded_rank, 4, (CFG, LOSS, RATES,
                                            jax_ref["init"], shards,
                                            jax_ref["noise"], 2,
                                            str(tmp_path)), device="cpu")
    out = ranks.load(str(tmp_path), 4)
    assert len({o["hash"] for o in out}) == 1
    for o in out:
        np.testing.assert_allclose(o["metrics"]["loss"],
                                   np.mean(jax_ref["losses"]), rtol=LOSS_RTOL)
    _check_gradients(out, jax_ref, n_model=2)
    _check_update(out[0]["params"], jax_ref)
    params = list(TModel(CFG).parameters())
    want = sum(p.numel() * 4 // (2 if sharded(p.shape, 2) else 1)
               for p in params)
    n_sharded = sum(p.numel() * 4 for p in params if sharded(p.shape, 2))
    assert n_sharded > 0.9 * out[0]["full_bytes"]
    for o in out:
        params, moments = o["owned"]
        assert params == want
        assert moments == 2 * want
