"""The training step: loss, two Adam groups, global-norm clipping, StepLR.

Adam on the main parameters, clipped by their global norm, at the StepLR
rate; a separate Adam at ``bottleneck_learning_rate`` on the bottleneck's
``quantiles``, driven by the aux (quantile-fitting) loss alone.  One
backward of ``main + aux`` serves both: the stop-gradients of the
bottleneck keep the main loss off ``quantiles`` and the aux loss off
everything else.

Clipping follows optax's ``clip_by_global_norm``, which the JAX package
uses: ``g / norm * clip`` where ``norm >= clip``, else ``g`` (not
``torch.nn.utils.clip_grad_norm_``'s ``clip / (norm + 1e-6)``).  torch's
Adam computes optax's ``adam`` update with the same defaults.
"""

import torch

from ..utils import profiling


def make_lr_schedule(config, steps_per_epoch):
    """StepLR in steps: lr * gamma ** (step // (step_size * steps per
    epoch)); the update of step t (from 0) uses rate(t)."""
    base = config.get("model_learning_rate", 1e-4)
    step_size = config.get("scheduler_step_size", 150) * steps_per_epoch
    gamma = config.get("scheduler_gamma", 0.1)
    return lambda step: base * gamma ** (step // step_size)


def param_groups(model):
    """(main parameters, quantile parameters), by name."""
    main, aux = [], []
    for name, p in model.named_parameters():
        (aux if name.split(".")[-1] == "quantiles" else main).append(p)
    return main, aux


def make_optimizer(model, config, tensor_of=None):
    """The two Adam groups; tensor_of: parameter -> the tensor the
    optimizer updates in its place (a rank's slice in a sharded step)."""
    main, aux = param_groups(model)
    if tensor_of is not None:
        main, aux = [tensor_of(p) for p in main], [tensor_of(p) for p in aux]
    return torch.optim.Adam([
        {"params": main, "lr": config.get("model_learning_rate", 1e-4)},
        {"params": aux, "lr": config.get("bottleneck_learning_rate", 1e-3)}])


def sum_of_squares(grads):
    return sum(torch.sum(g.float() * g.float()) for g in grads)


def clip_by_global_norm(params, clip, norm=None):
    """optax's rule, in place on the gradients; returns the norm.  norm:
    the global norm where the gradients here are part of it (a sharded
    step), else computed from them."""
    grads = [p.grad for p in params if p.grad is not None]
    if not grads:
        return torch.zeros(())
    if norm is None:
        norm = torch.sqrt(sum_of_squares(grads))
    keep = norm < clip
    for g in grads:
        g.copy_(torch.where(keep, g, g / norm * clip))
    return norm


class TrainStep:
    """One optimizer update per call on a voxelized batch."""

    def __init__(self, model, loss_obj, config, steps_per_epoch=1,
                 aux_weight=1.0):
        self.model = model
        self.loss_obj = loss_obj
        self.aux_weight = aux_weight
        self.clip = config.get("clip_grad_norm", 1.0)
        self.schedule = make_lr_schedule(config, steps_per_epoch)
        self.optimizer = make_optimizer(model, config)
        self.step = 0

    def loss(self, x, q, lam, root_nbrs=None, generator=None):
        """(main + aux_weight * aux, parts with ``aux_loss``)."""
        with profiling.span("train.forward"):
            out = self.model(x, q, lam, training=True, root_nbrs=root_nbrs,
                             generator=generator)
            main, parts = self.loss_obj(x, out)
            aux = self.model.aux_loss()
            parts = dict(parts, aux_loss=aux)
            return main + self.aux_weight * aux, parts

    def __call__(self, x, q, lam, root_nbrs=None, generator=None):
        """Loss, backward, clip, update.  Returns the metrics as tensors
        (``loss`` and each part) and leaves the gradients in place."""
        self.optimizer.zero_grad(set_to_none=True)
        total, parts = self.loss(x, q, lam, root_nbrs, generator)
        with profiling.span("train.backward"):
            total.backward()
        return self.update({"loss": total.detach(),
                            **{k: v.detach() for k, v in parts.items()}})

    def clip_gradients(self, params):
        """Clip ``params``' gradients in place by their global norm;
        returns the norm."""
        return clip_by_global_norm(params, self.clip)

    def update(self, metrics):
        """Clip the main group, set its rate, step both Adam groups on the
        gradients in place; returns ``metrics``."""
        with profiling.span("train.clip_adam"):
            main_group, _ = self.optimizer.param_groups
            self.clip_gradients(main_group["params"])
            main_group["lr"] = self.schedule(self.step)
            self.optimizer.step()
            self.step += 1
            return metrics
