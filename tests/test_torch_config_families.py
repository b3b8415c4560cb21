"""Every committed experiment config through one training step in both
packages (the port's twin of ``tests/test_config_families.py``): each YAML
under ``configs/`` and ``configs/ablation/``, plus the flagship with
``quantization_mode: "uniform"``, narrowed to N=16 (C_bottleneck 16,
C_hyper_bottleneck 24; every flag, the loss, the q map and the optimizer
settings from the YAML), on ``tests/test_torch_train.py``'s batch and
noise (its fixed q and lambda; the config's q map is held equal in both
packages on a grid of q).

JAX's init is carried to the port (``weights.params_from_jax``).
Tolerances (measured at these sizes on the CPU, both f32, JAX at "highest"
precision, summed in other orders): the total loss within 2e-7 relative,
each loss part within 1e-5 relative (``test_torch_train.py``'s); every
gradient within 3.7e-5 of its largest JAX element.  The step: the port's
update of both Adam groups (clipping on the main group) on its gradients
equals optax's on the same gradients, every parameter within 1e-5 of the
size of its update plus two ulps of its largest element (the two round
p - update differently).  Adam's first step turns gradients far below its
eps into updates that move with their last bits, so the update is held
on one set of gradients.  The cases run in this file and in ``_b.py`` and
``_c.py`` beside it; the codec's containers are held in
``tests/test_torch_config_families_codec.py`` and ``_codec_b.py``."""

import copy
import glob
import os

import numpy as np
import pytest
import torch
import yaml

import upcc_tpu  # noqa: F401
import jax
import jax.numpy as jnp
import optax

from upcc_tpu.data.q_func import QFunc as JQFunc
from upcc_tpu.models.unified import UnifiedModel as JModel
from upcc_tpu.models.unified import host_root_maps as j_roots
from upcc_tpu.ops.sparse import SparseTensor as JST, voxelize_host_np
from upcc_tpu.data.synthetic import batch_of_cubes
from upcc_tpu.training.loss import Loss as JLoss
from upcc_tpu.training.train_step import make_optimizer as j_optimizer
from upcc_tpu.training.train_step import make_train_step

from upcc_tpu_torch.data.q_func import QFunc as TQFunc
from upcc_tpu_torch.models.unified import UnifiedModel as TModel
from upcc_tpu_torch.models.unified import host_root_maps as t_roots
from upcc_tpu_torch.ops.sparse import SparseTensor as TST
from upcc_tpu_torch.training.loss import Loss as TLoss
from upcc_tpu_torch.training.train_step import TrainStep
from upcc_tpu_torch.weights import _flatten, params_from_jax
from test_torch_train import LOSS_RTOL, Noise, T, inject

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIGS = sorted(glob.glob(os.path.join(REPO, "configs", "*.yaml"))) + \
    sorted(glob.glob(os.path.join(REPO, "configs", "ablation", "*.yaml")))
CASES = [os.path.relpath(p, REPO) for p in CONFIGS] + ["uniform"]
CAP = 2048
TOTAL_RTOL = 2e-7
GRAD_TOL = 3.7e-5
STEP_TOL = 1e-5


def load_case(case):
    """(YAML dict, model config at N=16) of a case; "uniform" is the
    flagship with quantization_mode "uniform"."""
    path = os.path.join(REPO, "configs", "CVPR_inverse_scaling.yaml") \
        if case == "uniform" else os.path.join(REPO, case)
    with open(path) as f:
        cfg = yaml.safe_load(f)
    m = copy.deepcopy(cfg["model"])
    em = m["entropy_model"]
    em.update(C_bottleneck=16, C_hyper_bottleneck=24)
    em.pop("type", None)
    if case == "uniform":
        em["quantization_mode"] = "uniform"
    return cfg, {"max_batch": 2,
                 "g_a": {**m["g_a"], "N1": 16, "N2": 16, "N3": 16, "N4": 16},
                 "g_s": {**m["g_s"], "N1": 16, "N2": 16, "N3": 16, "N4": 16},
                 "entropy_model": em}


def batch():
    """test_torch_train.py's batch: keys, feats, q and lambda."""
    rng = np.random.default_rng(0)
    b, x, c = batch_of_cubes(rng, 2, extent=32, n_per=500, capacity=CAP)
    keys, feats = voxelize_host_np(b, x, c, CAP)
    q = np.array([[0.3, 0.7]] * 2, np.float32)
    lam = np.array([[50.0, 6000.0]] * 2, np.float32)
    return keys, feats, q, lam


def rates(cfg):
    return {k: cfg[k] for k in ("model_learning_rate",
                                "bottleneck_learning_rate", "clip_grad_norm")
            if k in cfg}


def check_step(case):
    """One forward, loss, backward and update of ``case`` in both
    packages, held to the tolerances above."""
    cfg, mcfg = load_case(case)
    keys, feats, q, lam = batch()
    # the config's q map: the same lambdas in both packages
    qs = np.linspace(0, 1, 11, dtype=np.float32)[:, None].repeat(2, 1)
    np.testing.assert_allclose(
        TQFunc(cfg["q_map"]).scale_q_vals(T(qs)).numpy(),
        np.asarray(JQFunc(cfg["q_map"]).scale_q_vals(jnp.asarray(qs))),
        rtol=1e-6)
    jm = JModel(mcfg)
    xj = JST(jnp.asarray(keys), jnp.asarray(feats))
    params = jax.jit(jm.init)({"params": jax.random.PRNGKey(0),
                               "noise": jax.random.PRNGKey(1)}, xj,
                              jnp.asarray(q), jnp.asarray(lam))["params"]
    tm = TModel(mcfg)
    tm.load_state_dict(params_from_jax(
        jax.tree_util.tree_map(np.asarray, params), tm))
    tx = j_optimizer(rates(cfg))
    step = make_train_step(jm, JLoss(cfg["loss"], max_batch=2), tx)
    loss_fn = dict(zip(step.__code__.co_freevars,
                       (c.cell_contents for c in step.__closure__)))["loss_fn"]
    ts = TrainStep(tm, TLoss(cfg["loss"], 2), rates(cfg))
    x = TST(T(keys), T(feats))
    mp = pytest.MonkeyPatch()
    inject(mp, Noise(7))
    try:
        (jtotal, jparts), jgrads = jax.jit(jax.value_and_grad(
            loss_fn, has_aux=True))(params, xj, jnp.asarray(q),
                                    jnp.asarray(lam), jax.random.PRNGKey(3),
                                    j_roots(keys, mcfg))
        ts.optimizer.zero_grad(set_to_none=True)
        total, parts = ts.loss(x, T(q), T(lam), t_roots(keys, mcfg))
        total.backward()
    finally:
        mp.undo()

    assert abs(float(total) - float(jtotal)) <= TOTAL_RTOL * abs(
        float(jtotal)), (float(total), float(jtotal))
    assert set(parts) == set(jparts)
    for k, v in jparts.items():
        assert abs(float(parts[k]) - float(v)) \
            <= LOSS_RTOL * abs(float(v)) + 1e-7, k
    ref = _flatten(jax.tree_util.tree_map(np.asarray, jgrads))
    names = [n for n, _ in tm.named_parameters()]
    assert set(names) == set(ref)
    for name, p in tm.named_parameters():
        got = p.grad.numpy() if p.grad is not None \
            else np.zeros_like(ref[name])
        err = np.abs(got - ref[name]).max()
        assert err <= GRAD_TOL * np.abs(ref[name]).max() + 1e-12, (name, err)

    # one update of both Adam groups (clipping on the main group) on the
    # port's gradients, against optax's update on the same gradients
    def j_update(grads, params):
        updates, _ = tx.update(grads, tx.init(params), params)
        return optax.apply_updates(params, updates)

    init = _flatten(jax.tree_util.tree_map(np.asarray, params))
    new = _flatten(jax.tree_util.tree_map(
        np.asarray, jax.jit(j_update)(grad_tree(tm), params)))
    ts.update({"loss": total.detach()})
    for name, p in tm.named_parameters():
        moved = np.abs(new[name] - init[name]).max()
        err = np.abs(p.detach().numpy() - new[name]).max()
        ulp = np.spacing(np.float32(max(np.abs(init[name]).max(),
                                        np.abs(new[name]).max())))
        assert err <= STEP_TOL * moved + 2 * ulp, (name, err, moved)


def grad_tree(model):
    """The model's gradients as the nested flax tree (zeros where a
    parameter has none)."""
    tree = {}
    for name, p in model.named_parameters():
        node = tree
        *path, leaf = name.split(".")
        for part in path:
            node = node.setdefault(part, {})
        node[leaf] = (p.grad if p.grad is not None
                      else torch.zeros_like(p)).numpy().copy()
    return tree


# the cases are spread over three files so that --dist loadfile runs them
# on three workers: with a cold JAX cache a case costs 13-42 s of tracing
# and compiling, the eleven about 290 s in one process
STEP_SPLIT = (CASES[:4], CASES[4:8], CASES[8:])


@pytest.mark.parametrize("case", STEP_SPLIT[0])
def test_config_step_matches_jax(case):
    check_step(case)


def test_cases_cover_every_committed_config():
    names = {os.path.basename(c) for c in CASES}
    assert len(CONFIGS) == 10 and {"abl_region5.yaml", "abl_child8.yaml",
                                    "CVPR_inverse_nn.yaml"} <= names
    assert sum(STEP_SPLIT, []) == CASES
