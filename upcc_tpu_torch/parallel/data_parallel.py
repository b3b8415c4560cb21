"""Data-parallel training over ``torch.distributed`` (the JAX package's
``parallel/data_parallel.py``).

Each rank runs the full model on its own collated, fixed-capacity batch.
The gradients are averaged over the data group before the optimizer
update, so clipping by the global norm sees the mean gradient, as
``jax.lax.pmean`` then ``optimizer.update`` do in the JAX step; both Adam
groups follow.  The reduction is explicit (``all_reduce_mean``): one
``all_reduce`` a step of every gradient flattened into one buffer, with a
count of the ranks that produced each and the step's metrics.  A parameter
to which no rank gave a gradient keeps none (Adam skips it, as on one
device); one that only some ranks reached counts zeros from the others.
Every rank ends with the same sums, so replicas that start equal stay
bit-identical even where a rank's own gradients carry the rounding of
CUDA's atomics.  Only ``all_reduce``, ``all_gather`` and ``broadcast`` are
used: gloo serves them on CUDA tensors too.

A shard's quality pair and noise come from generators seeded by (epoch,
group step, shard index), never by the rank, so a shard draws the same
values whatever the world size (``group_draws``, ``noise_generator``).
"""

import numpy as np
import torch
import torch.distributed as dist

from ..training.train_step import TrainStep
from . import multihost

# the two draws of a shard, each from its own seed
_Q_STREAM, _NOISE_STREAM = 0, 1


class Mesh:
    """A named grid of ranks (the port's counterpart of a
    ``jax.sharding.Mesh`` device grid)."""

    def __init__(self, ranks, axis_names):
        self.ranks = np.asarray(ranks, np.int64)
        self.axis_names = tuple(axis_names)
        if self.ranks.ndim != len(self.axis_names):
            raise ValueError(f"{self.ranks.ndim}-D grid, axis names "
                             f"{self.axis_names}")

    @property
    def shape(self):
        return dict(zip(self.axis_names, self.ranks.shape))


def make_mesh(n_ranks=None, axis="data"):
    """The 1-D data mesh over ranks [0, n_ranks) (default: the world)."""
    return Mesh(np.arange(n_ranks or multihost.world()[1]), (axis,))


def local_dp_rows(mesh, axis="data"):
    """This rank's contiguous [lo, hi) rows of the mesh's data axis: the
    rows it stands in (one, as meshes are built; each rank prepares only
    these rows' batches).  Raises if the axis is unknown, or the rank is
    on no row or on rows that are not contiguous."""
    if axis not in mesh.axis_names:
        raise ValueError(f"mesh has no axis {axis!r}: {mesh.axis_names}")
    grid = np.moveaxis(mesh.ranks, mesh.axis_names.index(axis), 0)
    rank = multihost.world()[0]
    rows = [i for i, g in enumerate(grid) if np.any(g == rank)]
    if not rows:
        raise ValueError(f"rank {rank} is on no row of mesh axis {axis!r}")
    lo, hi = rows[0], rows[-1] + 1
    if rows != list(range(lo, hi)):
        raise ValueError(f"rank {rank} rows are non-contiguous on axis "
                         f"{axis!r}: {rows}")
    return lo, hi


def shard_seed(epoch, step, shard, stream):
    """A generator seed from (epoch, group step, shard index, stream)."""
    return int(np.random.SeedSequence([epoch, step, shard, stream])
               .generate_state(1, np.uint64)[0] >> 1)


def group_draws(q_func, n_shards, batch_size, epoch, step):
    """(q, lambda), each [n_shards, batch_size, 2] on the CPU: one quality
    pair a shard from the shard's own generator.  Every rank draws the
    whole group and takes its rows."""
    qs, lams = zip(*(
        q_func.sample(torch.Generator().manual_seed(
            shard_seed(epoch, step, i, _Q_STREAM)), batch_size)
        for i in range(n_shards)))
    return torch.stack(qs), torch.stack(lams)


def noise_generator(device, epoch, step, shard):
    """The shard's generator of training noise on ``device``."""
    return torch.Generator(device=device).manual_seed(
        shard_seed(epoch, step, shard, _NOISE_STREAM))


def all_reduce_mean(params, metrics, group=None):
    """Average every parameter's gradient and every metric over ``group``
    in one ``all_reduce``.  ``p.grad`` becomes a view of the reduced
    buffer (None where no rank had a gradient).  Returns the mean
    metrics."""
    n = dist.get_world_size(group)
    dev = params[0].device
    names = list(metrics)
    have = torch.tensor([p.grad is not None for p in params],
                        dtype=torch.float32, device=dev)
    flat = torch.cat(
        [(p.grad if p.grad is not None else torch.zeros_like(p))
         .reshape(-1).float() for p in params]
        + [have, torch.stack([metrics[k].float() for k in names]).to(dev)])
    dist.all_reduce(flat, group=group)
    flat /= n
    end = flat.numel() - len(names)
    reached = (flat[end - len(params):end] > 0).tolist()
    pos = 0
    for p, r in zip(params, reached):
        chunk = flat[pos:pos + p.numel()]
        pos += p.numel()
        p.grad = chunk.view_as(p).to(p.dtype) if r else None
    return dict(zip(names, flat[end:]))


def broadcast_state(model, src=0, group=None):
    """Every parameter and buffer from rank ``src`` (replicas start
    equal)."""
    for t in list(model.parameters()) + list(model.buffers()):
        dist.broadcast(t.data, src, group=group)


class DataParallelStep(TrainStep):
    """``TrainStep`` whose update averages the gradients and metrics over
    ``group`` first (default: the world).  Every rank calls it once a step
    with its own batch."""

    def __init__(self, model, loss_obj, config, steps_per_epoch=1,
                 aux_weight=1.0, group=None):
        super().__init__(model, loss_obj, config, steps_per_epoch,
                         aux_weight)
        self.group = group

    def update(self, metrics):
        return super().update(all_reduce_mean(
            list(self.model.parameters()), metrics, self.group))


def reference_step(step, batches):
    """One update of ``step`` (a ``TrainStep``) on the mean of the
    gradients of ``batches`` — [(x, q, lam, root_nbrs, generator)] — in
    one process: what a data-parallel step over len(batches) ranks
    computes.  Returns the mean metrics."""
    params = list(step.model.parameters())
    sums, metrics = {}, []
    for x, q, lam, root, gen in batches:
        step.optimizer.zero_grad(set_to_none=True)
        total, parts = step.loss(x, q, lam, root, gen)
        total.backward()
        metrics.append({"loss": total.detach(),
                        **{k: v.detach() for k, v in parts.items()}})
        for p in params:
            if p.grad is not None:
                sums[p] = sums[p] + p.grad if p in sums else p.grad
    for p in params:
        p.grad = sums[p] / len(batches) if p in sums else None
    return step.update({k: sum(m[k] for m in metrics) / len(batches)
                        for k in metrics[0]})
