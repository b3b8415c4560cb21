"""The rest of the port's parallel package on the CPU (the multi-rank
steps against JAX are in tests/test_torch_parallel.py): the 1x1 sharded
step against the in-process reference, the shard rule against the JAX
package's ``_leaf_spec`` on the flagship's parameter shapes, the 2-D
mesh, the data-row layout and the per-shard draws (the twin of
tests/test_multihost_prep.py), ``multihost.initialize`` and ``spawn``,
the dry run, and the new modules importing with JAX blocked."""

import os
import subprocess
import sys
import types

import numpy as np
import pytest
import torch

import upcc_tpu  # noqa: F401
from upcc_tpu.parallel.model_parallel import _leaf_spec

from upcc_tpu_torch.data.q_func import QFunc
from upcc_tpu_torch.models.unified import UnifiedModel as TModel
from upcc_tpu_torch.parallel import data_parallel as dp
from upcc_tpu_torch.parallel import multihost
from upcc_tpu_torch.parallel.model_parallel import make_mesh_2d, sharded
from upcc_tpu_torch.training.loss import Loss as TLoss
from upcc_tpu_torch.training.train_step import TrainStep
from upcc_tpu_torch.weights import FLAGSHIP_CONFIG, _flatten, flax_tree
from test_torch_parallel import CFG, LATENT_SCALE, RATES, shards  # noqa: F401
from test_torch_train import LOSS, Noise, inject
import torch_dist_ranks as ranks

torch.set_num_threads(2)
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_sharded_step_on_a_1x1_mesh_matches_reference_step(shards, tmp_path):
    """A 1x1 mesh (one rank) against ``reference_step`` in this process on
    the same shard, init and noise: the same arithmetic but for the order
    of sums (thread counts, the norm's two parts), so the gradients where
    they are clipped, and the norm, within 1e-5 of the reference's, and
    each parameter within 1e-3 of its update."""
    torch.manual_seed(0)
    tm = TModel(CFG)
    with torch.no_grad():
        tm.g_a.conv4.w.mul_(LATENT_SCALE)
    init = flax_tree(tm)
    init_flat = _flatten(init)
    noise = Noise(3)
    mp = pytest.MonkeyPatch()
    inject(mp, noise)
    try:
        step = TrainStep(ranks._model(CFG, init), TLoss(LOSS, 1), RATES)
        want = ranks.watch_clip(step)
        x, q, lam, root = ranks._inputs(CFG, shards[0])
        metrics = dp.reference_step(step, [(x, q, lam, root, None)])
    finally:
        mp.undo()
    multihost.spawn(ranks.sharded_rank, 1, (CFG, LOSS, RATES, init,
                                            shards[:1], dict(noise.arrays),
                                            1, str(tmp_path)), device="cpu")
    got = ranks.load(str(tmp_path), 1)[0]
    np.testing.assert_allclose(got["metrics"]["loss"], float(metrics["loss"]),
                               rtol=1e-6)
    clipped = got["clipped"]
    assert want["norm"] > 4 * RATES["clip_grad_norm"]
    assert abs(clipped["norm"] - want["norm"]) <= 1e-5 * want["norm"]
    for which in ("pre", "post"):
        assert set(clipped[which]) == set(want[which])
        for name, ref in want[which].items():
            err = np.abs(clipped[which][name] - ref).max()
            assert err <= 1e-5 * np.abs(ref).max() + 1e-12, (which, name)
    moved_any = False
    for name, p in step.model.named_parameters():
        moved = np.abs(p.detach().numpy() - init_flat[name]).max()
        moved_any |= moved > 0
        err = np.abs(got["params"][name] - p.detach().numpy()).max()
        assert err <= 1e-3 * moved + 1e-9, (name, err, moved)
    assert moved_any


@pytest.mark.parametrize("n_model", [1, 2, 4, 8])
def test_shard_rule_equals_leaf_spec_on_flagship_shapes(n_model):
    """``sharded`` decides exactly as the JAX package's ``_leaf_spec`` on
    every parameter shape of the flagship."""
    from jax.sharding import PartitionSpec as P
    with torch.device("meta"):
        tm = TModel(dict(FLAGSHIP_CONFIG, max_batch=8))
    shapes = [tuple(p.shape) for p in tm.parameters()]
    assert len(shapes) > 50
    n = 0
    for shape in shapes:
        want = _leaf_spec(types.SimpleNamespace(shape=shape), n_model) != P()
        assert sharded(shape, n_model) == want, shape
        n += want
    assert n > 0


def test_make_mesh_2d_raises_with_too_few_ranks():
    with pytest.raises(ValueError, match="need 8 ranks, have 4"):
        make_mesh_2d(4, 2, ranks=range(4))
    mesh = make_mesh_2d(2, 2, ranks=range(6))
    assert mesh.shape == {"data": 2, "model": 2}
    np.testing.assert_array_equal(mesh.ranks, [[0, 1], [2, 3]])


# -- data rows (the twin of tests/test_multihost_prep.py) --------------------

def test_local_dp_rows_single_process():
    assert dp.local_dp_rows(dp.make_mesh()) == (0, 1)


def _as_rank(monkeypatch, rank, world):
    monkeypatch.setattr(multihost, "world", lambda: (rank, world))


def test_local_dp_rows_contiguous_blocks(monkeypatch):
    """Each rank of a data mesh owns its own row; a rank that a grid
    lists on adjacent rows owns the block of them."""
    mesh = dp.make_mesh(8)
    for r in range(8):
        _as_rank(monkeypatch, r, 8)
        assert dp.local_dp_rows(mesh) == (r, r + 1)
    _as_rank(monkeypatch, 1, 4)
    assert dp.local_dp_rows(dp.Mesh([0, 1, 1, 2], ("data",))) == (1, 3)


def test_local_dp_rows_rejects_bad_layouts(monkeypatch):
    _as_rank(monkeypatch, 0, 4)
    with pytest.raises(ValueError, match="non-contiguous"):
        dp.local_dp_rows(dp.Mesh([0, 1, 0, 2], ("data",)))
    _as_rank(monkeypatch, 5, 8)
    with pytest.raises(ValueError, match="on no row"):
        dp.local_dp_rows(dp.make_mesh(4))


def test_local_dp_rows_multi_axis_mesh(monkeypatch):
    """On a (data, model) mesh a rank's row is its data index, whichever
    axis comes first."""
    mesh = dp.Mesh(np.arange(8).reshape(4, 2), ("data", "model"))
    flipped = dp.Mesh(np.arange(8).reshape(4, 2).T, ("model", "data"))
    for r in range(8):
        _as_rank(monkeypatch, r, 8)
        assert dp.local_dp_rows(mesh) == (r // 2, r // 2 + 1)
        assert dp.local_dp_rows(flipped) == (r // 2, r // 2 + 1)
    with pytest.raises(ValueError, match="no axis"):
        dp.local_dp_rows(mesh, axis="tensor")


Q_MAP = {"mode": "quadratic", "lambda_A_min": 0.0, "lambda_A_max": 1.0,
         "lambda_G_min": 0.0, "lambda_G_max": 1.0, "corner_p": 0.15}


@pytest.mark.parametrize("world", [1, 2, 4])
def test_shard_draws_do_not_depend_on_the_world(world, monkeypatch):
    """Each rank of a world of 1, 2 or 4 takes, in the trainer's
    data-parallel loop, the full group's rows of q and lambda and the
    noise of its own shard index: equal to what the shard draws in any
    other world."""
    from upcc_tpu_torch.training.trainer import Training
    qf = QFunc(Q_MAP)
    full_q, full_lam = dp.group_draws(qf, 4, 2, epoch=3, step=1)
    for n in (1, 2):
        q, lam = dp.group_draws(qf, n, 2, epoch=3, step=1)
        np.testing.assert_array_equal(q, full_q[:n])
        np.testing.assert_array_equal(lam, full_lam[:n])
    assert not torch.equal(full_q[0], full_q[1])

    def noise_of(shard):
        return torch.rand(5, generator=dp.noise_generator("cpu", 3, 1,
                                                          shard))
    calls = []

    class Stub:
        _dp_steps = Training._dp_steps
        _shard_step = Training._shard_step

        def __init__(self):
            self.n_dp, self.batch_size, self.q_func = world, 2, qf
            self.max_steps_per_epoch, self.device = 2, torch.device("cpu")
            self.dp_mesh = dp.make_mesh(world)

        def batch_tensors(self, batch, capacity):
            return (batch, capacity), None

        def step_fn(self, x, q, lam, root, gen):
            calls.append((x, q, lam, torch.rand(5, generator=gen)))
            return {}

    for rank in range(world):
        monkeypatch.setattr(multihost, "world", lambda r=rank: (r, world))
        calls.clear()
        batches = iter([(np.zeros(8 + i), None, None)
                        for i in range(2 * world)])
        list(Stub()._dp_steps(3, batches))
        assert len(calls) == 2
        for step, ((batch, cap), q, lam, noise) in enumerate(calls):
            q_all, lam_all = dp.group_draws(qf, world, 2, 3, step)
            np.testing.assert_array_equal(q, q_all[rank])
            np.testing.assert_array_equal(lam, lam_all[rank])
            # the rank's own batch, at the group's largest capacity
            assert len(batch[0]) == 8 + step * world + rank
            assert cap == 8 + step * world + world - 1
            if step == 1:
                np.testing.assert_array_equal(noise, torch.rand(
                    5, generator=dp.noise_generator("cpu", 3, 1, rank)))
    assert not torch.equal(noise_of(0), noise_of(1))


# -- multihost ----------------------------------------------------------------

ENV = ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK", "LOCAL_RANK")


def test_multihost_initialize_is_a_noop_without_coordinates(monkeypatch):
    for k in ENV:
        monkeypatch.delenv(k, raising=False)
    assert multihost.initialize() is False
    assert multihost.is_primary() is True
    assert multihost.world() == (0, 1)


@pytest.mark.parametrize("source", ["arguments", "environment"])
def test_multihost_initialize_forwards(monkeypatch, source):
    """Explicit arguments, or torchrun's environment, reach
    init_process_group; gloo on the CPU; a second call returns True
    without joining again."""
    for k in ENV:
        monkeypatch.delenv(k, raising=False)
    calls = []
    state = {"up": False}

    def init(backend, **kw):
        calls.append((backend, kw))
        state["up"] = True
    monkeypatch.setattr(torch.distributed, "init_process_group", init)
    monkeypatch.setattr(torch.distributed, "is_initialized",
                        lambda: state["up"])
    if source == "arguments":
        assert multihost.initialize("tcp://10.0.0.1:1234", 4, 2,
                                    device="cpu") is True
    else:
        for k, v in zip(ENV, ("10.0.0.1", "1234", "4", "2", "2")):
            monkeypatch.setenv(k, v)
        assert multihost.initialize(device="cpu") is True
    assert calls == [("gloo", {"init_method": "tcp://10.0.0.1:1234",
                               "world_size": 4, "rank": 2})]
    assert multihost.initialize(device="cpu") is True
    assert len(calls) == 1


def test_multihost_initialize_refuses_what_it_cannot_do(monkeypatch):
    """Half the coordinates raise; a CUDA rank device without CUDA raises
    (nothing falls back to the CPU)."""
    for k in ENV:
        monkeypatch.delenv(k, raising=False)
    with pytest.raises(ValueError, match="incomplete"):
        multihost.initialize(world_size=2)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="not available"):
        multihost.initialize("tcp://localhost:1", 1, 0, device="cuda")
    assert not torch.distributed.is_initialized()


def test_spawn_reports_a_failed_rank():
    with pytest.raises(RuntimeError, match="rank 1 failed on purpose"):
        multihost.spawn(ranks.fail_on_rank_one, 2, device="cpu",
                        timeout=120)


def test_spawn_defaults_to_cuda_and_raises_without_it(monkeypatch):
    """Without ``device``, spawn asks for CUDA: on a machine without it,
    resolve_device's error comes before any process starts."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)

    def no_process(*a, **kw):
        raise AssertionError("spawn started processes")
    monkeypatch.setattr(multihost.multiprocessing, "get_context", no_process)
    with pytest.raises(RuntimeError, match="not available"):
        multihost.spawn(ranks.fail_on_rank_one, 2, timeout=120)


class _Started(Exception):
    pass


@pytest.mark.parametrize("device,world,cards,starts", [
    ("cuda", 2, 1, False), ("cuda", 2, 2, True), ("cuda:1", 2, 1, False),
    ("cuda:0", 2, 1, True), ("cuda:1", 1, 2, True)])
def test_spawn_checks_the_card_count_before_any_process(
        monkeypatch, device, world, cards, starts):
    """With too few cards (an unindexed ``cuda`` and more ranks than
    cards, or ``cuda:i`` past the last card) spawn raises before it makes
    any process; ``cuda:0`` shared by every rank stays allowed."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: cards)
    made = []

    class Context:
        def Queue(self):
            return None

        def Process(self, *a, **kw):
            made.append(kw)
            raise _Started

    monkeypatch.setattr(multihost.multiprocessing, "get_context",
                        lambda method: Context())
    if starts:
        with pytest.raises(_Started):
            multihost.spawn(ranks.fail_on_rank_one, world, device=device)
        assert len(made) == 1
    else:
        with pytest.raises(RuntimeError, match="CUDA device"):
            multihost.spawn(ranks.fail_on_rank_one, world, device=device)
        assert made == []


def test_dryrun_multichip_two_ranks(capfd):
    from upcc_tpu_torch.parallel.dryrun import dryrun_multichip
    dryrun_multichip(2)
    out = capfd.readouterr().out
    assert "dryrun: data-parallel step over 2 ranks (2 data shards)" in out
    assert "dryrun: 2-D 1x2 step over 2 ranks" in out


def test_new_modules_import_with_jax_blocked():
    """The parallel and data modules, the trainer and the codec import
    with jax, flax and upcc_tpu made unimportable (a site set-up may import
    jax into every process, so the child removes it first)."""
    mods = ["upcc_tpu_torch.parallel.multihost",
            "upcc_tpu_torch.parallel.data_parallel",
            "upcc_tpu_torch.parallel.model_parallel",
            "upcc_tpu_torch.parallel.block_parallel",
            "upcc_tpu_torch.parallel.dryrun",
            "upcc_tpu_torch.data.cube_io", "upcc_tpu_torch.data.download",
            "upcc_tpu_torch.training.trainer", "upcc_tpu_torch.train",
            "upcc_tpu_torch.codec.codec"]
    code = f"""
import importlib, sys
banned = ("jax", "jaxlib", "flax", "optax", "orbax", "upcc_tpu")
def blocked(name):
    return name.split(".")[0] in banned
for name in list(sys.modules):
    if blocked(name):
        del sys.modules[name]
class Block:
    def find_spec(self, name, path=None, target=None):
        if blocked(name):
            raise ImportError("blocked: " + name)
sys.meta_path.insert(0, Block())
for m in {mods!r}:
    importlib.import_module(m)
assert not any(blocked(n) for n in sys.modules), sorted(
    n for n in sys.modules if blocked(n))
print("ok")
"""
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr[-3000:]
    assert res.stdout.strip().endswith("ok")
