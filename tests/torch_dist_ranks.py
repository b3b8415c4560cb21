"""Rank bodies of the port's multi-process CPU tests (spawned by
``upcc_tpu_torch.parallel.multihost.spawn``; importable by name, so not a
test module).  They import the port only: each rank writes what the test
compares to ``<out>/rank<r>.pt``."""

import builtins
import hashlib
import os

import torch

import upcc_tpu_torch.models.entropy.bottleneck as TB
import upcc_tpu_torch.models.entropy.gaussian as TG
from upcc_tpu_torch.models.unified import UnifiedModel, host_root_maps
from upcc_tpu_torch.ops.sparse import SparseTensor
from upcc_tpu_torch.training.loss import Loss
from upcc_tpu_torch.weights import params_from_jax


def _inject(noise):
    """The training noise from the test's arrays, by shape."""
    draw = lambda shape, like, generator=None: torch.from_numpy(
        noise[tuple(int(s) for s in shape)])
    TB.uniform_noise = draw
    TG.uniform_noise = draw


def _model(cfg, init):
    tm = UnifiedModel(cfg)
    tm.load_state_dict(params_from_jax(init, tm))
    return tm


def _inputs(cfg, shard):
    keys, feats, q, lam = shard
    x = SparseTensor(torch.from_numpy(keys), torch.from_numpy(feats))
    return x, torch.from_numpy(q), torch.from_numpy(lam), \
        host_root_maps(keys, cfg)


def state_hash(module_or_tensors):
    """sha256 of every tensor's bytes, in order."""
    h = hashlib.sha256()
    tensors = module_or_tensors.values() \
        if isinstance(module_or_tensors, dict) else module_or_tensors
    for t in tensors:
        h.update(t.detach().contiguous().numpy().tobytes())
    return h.hexdigest()


def watch_clip(step):
    """Records, where ``step`` clips: every gradient the optimizer holds
    before clipping (``pre``), the global norm it clips by (``norm``) and
    the main group's gradients after (``post``), by parameter name (a
    sharded leaf's: this rank's slice)."""
    main, aux = ([n for n, _ in step.model.named_parameters()
                  if (n.split(".")[-1] == "quantiles") == is_aux]
                 for is_aux in (False, True))
    log = {}
    clip = step.clip_gradients

    def grads(names, group):
        return {n: t.grad.detach().clone().numpy()
                for n, t in zip(names, group["params"]) if t.grad is not None}

    def spy(params):
        main_group, aux_group = step.optimizer.param_groups
        log["pre"] = {**grads(main, main_group), **grads(aux, aux_group)}
        norm = clip(params)
        log["norm"] = float(norm)
        log["post"] = grads(main, main_group)
        return norm
    step.clip_gradients = spy
    return log


def dp_rank(rank, world, cfg, loss_cfg, rates, init, shards, noise, out):
    """One DataParallelStep on shard ``rank``."""
    from upcc_tpu_torch.parallel.data_parallel import DataParallelStep
    torch.set_num_threads(1)
    _inject(noise)
    tm = _model(cfg, init)
    step = DataParallelStep(tm, Loss(loss_cfg, cfg["max_batch"]), rates)
    clipped = watch_clip(step)
    metrics = step(*_inputs(cfg, shards[rank]))
    sd = tm.state_dict()
    torch.save({"params": {k: v.numpy() for k, v in sd.items()},
                "metrics": {k: float(v) for k, v in metrics.items()},
                "clipped": clipped, "hash": state_hash(sd)},
               os.path.join(out, f"rank{rank}.pt"))


def sharded_rank(rank, world, cfg, loss_cfg, rates, init, shards, noise,
                 n_model, out):
    """One ShardedTrainStep on an (world // n_model) x n_model mesh; data
    row d runs shard d."""
    from upcc_tpu_torch.parallel.model_parallel import (ShardedTrainStep,
                                                        make_mesh_2d)
    torch.set_num_threads(1)
    _inject(noise)
    tm = _model(cfg, init)
    full_bytes = sum(p.numel() * p.element_size() for p in tm.parameters())
    step = ShardedTrainStep(tm, Loss(loss_cfg, cfg["max_batch"]), rates,
                            make_mesh_2d(world // n_model, n_model))
    clipped = watch_clip(step)
    metrics = step(*_inputs(cfg, shards[rank // n_model]))
    full = step.full_parameters()
    torch.save({"params": {k: v.numpy() for k, v in full.items()},
                "metrics": {k: float(v) for k, v in metrics.items()},
                "clipped": clipped, "model_index": rank % n_model,
                "owned": step.owned_bytes(), "full_bytes": full_bytes,
                "hash": state_hash(full)},
               os.path.join(out, f"rank{rank}.pt"))


def train_rank(rank, world, cfg, out):
    """Training over the process group: one epoch, then a second Training
    that resumes and trains one more.  Records the files each rank opened
    for writing under the results directory and the state's hashes."""
    from upcc_tpu_torch.training.trainer import Training
    torch.set_num_threads(1)
    results = os.path.abspath(cfg["results_path"])
    written = []
    real_open = builtins.open

    def spy(file, mode="r", *args, **kwargs):
        if isinstance(file, (str, os.PathLike)) and any(
                c in mode for c in "wax+") \
                and os.path.abspath(file).startswith(results):
            written.append(os.path.relpath(file, results))
        return real_open(file, mode, *args, **kwargs)
    real_save = torch.save

    def save_spy(obj, f, *args, **kwargs):
        written.append(os.path.relpath(f, results))
        return real_save(obj, f, *args, **kwargs)
    builtins.open, torch.save = spy, save_spy
    try:
        tr = Training(dict(cfg, epochs=1), capacity=cfg["capacity"],
                      device="cpu", renders=False)
        steps = []
        tr.step_fn = _Counted(tr.step_fn, steps)
        tr.train()
        first = {"n_dp": tr.n_dp, "updates": tr.step_fn.step,
                 "capacities": steps,
                 "model": state_hash(tr.model.state_dict()),
                 "adam": state_hash([v for st in tr.step_fn.optimizer.state
                                     .values() for k, v in st.items()
                                     if k != "step"])}
        tr2 = Training(dict(cfg, epochs=2), capacity=cfg["capacity"],
                       device="cpu", renders=False)
        resumed = {"start_epoch": tr2.start_epoch,
                   "updates": tr2.step_fn.step,
                   "model": state_hash(tr2.model.state_dict())}
        tr2.train()
        second = {"updates": tr2.step_fn.step,
                  "model": state_hash(tr2.model.state_dict())}
    finally:
        builtins.open, torch.save = real_open, real_save
    torch.save({"first": first, "resumed": resumed, "second": second,
                "written": written}, os.path.join(out, f"rank{rank}.pt"))


def fail_on_rank_one(rank, world):
    """Rank 1 raises; rank 0 waits for it in a collective."""
    if rank == 1:
        raise ValueError("rank 1 failed on purpose")
    torch.distributed.barrier()


class _Counted:
    """A step that records each call's capacity before running it."""

    def __init__(self, step, log):
        self._step, self._log = step, log

    def __call__(self, x, *args, **kwargs):
        self._log.append(int(x.keys.shape[0]))
        return self._step(x, *args, **kwargs)

    def __getattr__(self, name):
        return getattr(self._step, name)


def load(out, world):
    return [torch.load(os.path.join(out, f"rank{r}.pt"), weights_only=False)
            for r in range(world)]
