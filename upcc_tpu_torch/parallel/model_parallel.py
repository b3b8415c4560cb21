"""2-D (data x model) sharded training over ``torch.distributed`` (the JAX
package's ``parallel/model_parallel.py``).

The ranks form a grid ``("data", "model")``.  Every parameter whose last
(output-channel) axis divides by the model axis and keeps at least 2
columns a shard is sharded on that axis (``sharded``, the JAX package's
``_leaf_spec`` rule): each rank of a data row owns one slice of it and that
slice's Adam moments.  Everything else (biases, quantiles, scalars) is
replicated.  Ranks of one data row run the same batch; rows run their own.

The step is the single-device step: before the forward each sharded weight
is gathered whole over the model group (``all_gather``), so K1's weight
preparation sees the whole weight as on one device; the backward's
gradients are averaged over the world (the model peers' are the same
batch's, so this is the data mean, and every rank ends with the same
bits); each rank keeps its slice; the global norm for clipping is the sum
of squares of this rank's shards summed over the model group, plus the
replicated leaves counted once.  Between steps the gathered weights give
their memory back: a rank holds its slices, the replicated leaves and
their Adam moments.
"""

import numpy as np
import torch
import torch.distributed as dist

from ..training.train_step import (TrainStep, clip_by_global_norm,
                                   make_optimizer, sum_of_squares)
from . import multihost
from .data_parallel import Mesh, all_reduce_mean


def make_mesh_2d(n_data, n_model, ranks=None):
    """The (data, model) grid over ``ranks`` (default: the world's)."""
    ranks = list(ranks) if ranks is not None \
        else list(range(multihost.world()[1]))
    need = n_data * n_model
    if len(ranks) < need:
        raise ValueError(f"need {need} ranks, have {len(ranks)}")
    return Mesh(np.asarray(ranks[:need]).reshape(n_data, n_model),
                ("data", "model"))


def sharded(shape, n_model):
    """Whether a leaf of this shape is sharded on its last axis over
    ``n_model`` ranks (else replicated)."""
    return len(shape) >= 2 and shape[-1] % n_model == 0 \
        and shape[-1] >= 2 * n_model


class MeshGroups:
    """The process groups of a 2-D mesh (each data row's model group and
    the mesh's own) and this rank's place in it.
    Every rank of the world must build it (each group is created by all
    ranks, in one order)."""

    def __init__(self, mesh):
        rank = multihost.world()[0]
        grid = mesh.ranks
        hit = np.argwhere(grid == rank)
        if len(hit) != 1:
            raise ValueError(f"rank {rank} is not once on the mesh")
        self.data_index, self.model_index = (int(v) for v in hit[0])
        self.n_data, self.n_model = grid.shape
        self.model_group = None
        for d in range(self.n_data):
            g = dist.new_group(grid[d].tolist())
            if d == self.data_index:
                self.model_group = g
        self.world_group = dist.new_group(grid.reshape(-1).tolist())


class ShardedTrainStep(TrainStep):
    """``TrainStep`` on a 2-D mesh: one call a step on every rank, with its
    data row's batch.  ``full_parameters()`` gathers the whole
    parameters."""

    def __init__(self, model, loss_obj, config, mesh, steps_per_epoch=1,
                 aux_weight=1.0):
        super().__init__(model, loss_obj, config, steps_per_epoch,
                         aux_weight)
        self.groups = MeshGroups(mesh)
        n, m = self.groups.n_model, self.groups.model_index
        self.owned = {}  # parameter -> the tensor this rank updates
        for p in model.parameters():
            if sharded(p.shape, n):
                c = p.shape[-1] // n
                self.owned[p] = p.detach()[..., m * c:(m + 1) * c] \
                    .clone().requires_grad_()
            else:
                self.owned[p] = p
        self.optimizer = make_optimizer(model, config, self.owned.get)
        self._release()

    def _shards(self):
        return [(p, o) for p, o in self.owned.items() if o is not p]

    def _gather(self):
        """Every sharded parameter whole again, from the model group."""
        for p, o in self._shards():
            p.untyped_storage().resize_(p.numel() * p.element_size())
            parts = [torch.empty_like(o) for _ in range(self.groups.n_model)]
            dist.all_gather(parts, o.detach(), group=self.groups.model_group)
            with torch.no_grad():
                p.copy_(torch.cat(parts, dim=-1))

    def _release(self):
        for p, _ in self._shards():
            p.untyped_storage().resize_(0)

    def __call__(self, x, q, lam, root_nbrs=None, generator=None):
        self._gather()
        try:
            self.model.zero_grad(set_to_none=True)
            self.optimizer.zero_grad(set_to_none=True)
            total, parts = self.loss(x, q, lam, root_nbrs, generator)
            total.backward()
            metrics = all_reduce_mean(
                list(self.model.parameters()),
                {"loss": total.detach(),
                 **{k: v.detach() for k, v in parts.items()}},
                self.groups.world_group)
            n, m = self.groups.n_model, self.groups.model_index
            for p, o in self._shards():
                c = p.shape[-1] // n
                o.grad = None if p.grad is None \
                    else p.grad[..., m * c:(m + 1) * c].contiguous()
                p.grad = None
        finally:
            self._release()
        return self.update(metrics)

    def clip_gradients(self, params):
        """The global norm: this rank's shards' squares summed over the
        model group, plus the replicated leaves' once."""
        mine = set(map(id, (o for _, o in self._shards())))
        have = [o for o in params if o.grad is not None]
        sq = torch.as_tensor(
            sum_of_squares([o.grad for o in have if id(o) in mine]),
            dtype=torch.float32, device=params[0].device).reshape(1)
        dist.all_reduce(sq, group=self.groups.model_group)
        rep_sq = sum_of_squares([o.grad for o in have if id(o) not in mine])
        return clip_by_global_norm(params, self.clip,
                                   torch.sqrt(sq[0] + rep_sq))

    def full_parameters(self):
        """{name: whole parameter} (a copy), gathered over the model
        group; every rank of the grid must call it."""
        self._gather()
        try:
            return {name: p.detach().clone()
                    for name, p in self.model.named_parameters()}
        finally:
            self._release()

    def owned_bytes(self):
        """(parameter bytes, Adam moment bytes) this rank holds between
        steps: its slices and the replicated leaves, and their moments."""
        params = sum(o.numel() * o.element_size() for o in self.owned.values())
        moments = sum(v.numel() * v.element_size()
                      for st in self.optimizer.state.values()
                      for k, v in st.items()
                      if k in ("exp_avg", "exp_avg_sq"))
        return params, moments
