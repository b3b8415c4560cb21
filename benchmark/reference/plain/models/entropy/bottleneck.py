"""Factorized entropy bottleneck (fully-factorized learned prior): the
parameters, the quantization medians, the training forward (noise, ste or
round quantization with the likelihood of the integer bin), the aux
(quantile) loss and the numpy freeze of the learned density into integer
CDF tables for rANS.

The stop-gradients are the JAX package's: the medians that centre the ste
rounding and the sign of the likelihood's symmetric form are detached, so
the main loss never reaches ``quantiles``; the aux loss evaluates the
density with its parameters detached, so it reaches nothing else."""

import math

import torch
from torch import nn

from ..bound import lower_bound, quantize_ste
from .gaussian import uniform_noise

LIKELIHOOD_BOUND = 1e-9
TAIL_MASS = 1e-9


class FactorizedBottleneck(nn.Module):
    """Parameters ``matrix_i`` [C, f_out, f_in], ``bias_i`` [C, f_out, 1],
    ``factor_i`` [C, f_out, 1] and ``quantiles`` [C, 1, 3], laid out as the
    JAX package's flax module."""

    def __init__(self, channels, filters=(3, 3, 3, 3), init_scale=10.0):
        super().__init__()
        self.channels = channels
        self.filters = tuple(filters)
        f = (1,) + self.filters + (1,)
        scale = init_scale ** (1 / (len(self.filters) + 1))
        for i in range(len(self.filters) + 1):
            init = math.log(math.expm1(1 / scale / f[i + 1]))
            self.register_parameter(f"matrix_{i}", nn.Parameter(
                torch.full((channels, f[i + 1], f[i]), init)))
            self.register_parameter(f"bias_{i}", nn.Parameter(
                torch.rand(channels, f[i + 1], 1) - 0.5))
            if i < len(self.filters):
                self.register_parameter(f"factor_{i}", nn.Parameter(
                    torch.zeros(channels, f[i + 1], 1)))
        self.quantiles = nn.Parameter(torch.tensor(
            [[[-init_scale, 0.0, init_scale]]]).repeat(channels, 1, 1))

    def medians(self):
        return self.quantiles[:, 0, 1]

    def _logits_cumulative(self, x, detach_density=False):
        """x [C, 1, M] -> logits of the cumulative [C, 1, M]."""
        sg = (lambda v: v.detach()) if detach_density else (lambda v: v)
        n = len(self.filters) + 1
        for i in range(n):
            m = torch.nn.functional.softplus(sg(getattr(self, f"matrix_{i}")))
            x = torch.einsum("coi,cim->com", m, x) \
                + sg(getattr(self, f"bias_{i}"))
            if i < n - 1:
                x = x + torch.tanh(sg(getattr(self, f"factor_{i}"))) \
                    * torch.tanh(x)
        return x

    def _likelihood(self, x):
        """x [C, 1, M] -> likelihood of the integer bin around x."""
        upper = self._logits_cumulative(x + 0.5)
        lower = self._logits_cumulative(x - 0.5)
        sign = -torch.sign(upper + lower).detach()
        return torch.abs(torch.sigmoid(sign * upper)
                         - torch.sigmoid(sign * lower))

    def forward(self, feats, mode="noise", generator=None, noise=True):
        """feats [N, C] -> (quantized [N, C], likelihood [N, C]).

        'noise': additive U(-0.5, 0.5) proxy; 'ste': round(x - median) +
        median with a straight-through gradient, the likelihood at the
        noise proxy when ``noise`` (training) else at the rounded value;
        'round': hard rounding.  Noise comes from ``generator``."""
        x = feats.T[:, None, :]  # [C, 1, N]
        med = self.medians().detach()[:, None, None]
        if mode == "noise":
            xq = x + uniform_noise(x.shape, x, generator)
            lik_in = xq
        elif mode == "ste":
            xq = quantize_ste(x - med) + med
            lik_in = x + uniform_noise(x.shape, x, generator) if noise \
                else torch.round(x - med) + med
        else:
            xq = torch.round(x - med) + med
            lik_in = xq
        lik = lower_bound(self._likelihood(lik_in), LIKELIHOOD_BOUND)
        return xq[:, 0, :].T, lik[:, 0, :].T

    def aux_loss(self):
        """Quantile-fitting loss: trains ``quantiles`` against the detached
        density's tails and median."""
        logits = self._logits_cumulative(self.quantiles, detach_density=True)
        target = math.log(2 / TAIL_MASS - 1)
        t = torch.tensor([-target, 0.0, target], dtype=torch.float32,
                         device=logits.device)
        return torch.sum(torch.abs(logits - t))
