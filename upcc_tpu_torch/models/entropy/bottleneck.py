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

import numpy as np
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

    def numpy_params(self):
        return {name: p.detach().float().cpu().numpy()
                for name, p in self.named_parameters()}


def build_cdf_tables(params, channels, filters=(3, 3, 3, 3), precision=16):
    """Freeze the learned density into integer CDF tables for rANS.

    params: numpy arrays by parameter name.  Returns dict(cdf int32[C, L],
    cdf_length int32[C], offset int32[C])."""
    q = np.asarray(params["quantiles"])  # [C, 1, 3]
    med = q[:, 0, 1]
    minima = np.maximum(np.ceil(med - q[:, 0, 0]).astype(np.int32), 0)
    maxima = np.maximum(np.ceil(q[:, 0, 2] - med).astype(np.int32), 0)
    pmf_length = minima + maxima + 1
    max_len = int(pmf_length.max())

    samples = np.arange(max_len, dtype=np.float32)[None, :] \
        - minima[:, None] + med[:, None]

    def logits_np(x):
        x = x[:, None, :]
        for i in range(len(filters) + 1):
            m = np.logaddexp(0, np.asarray(params[f"matrix_{i}"]))  # softplus
            x = np.einsum("coi,cim->com", m, x) + np.asarray(params[f"bias_{i}"])
            if i < len(filters):
                x = x + np.tanh(np.asarray(params[f"factor_{i}"])) * np.tanh(x)
        return x[:, 0, :]

    def sigmoid(v):
        return 1.0 / (1.0 + np.exp(-v))

    upper = logits_np(samples + 0.5)
    lower = logits_np(samples - 0.5)
    sign = -np.sign(upper + lower)
    pmf = np.abs(sigmoid(sign * upper) - sigmoid(sign * lower))

    tail_lower = sigmoid(logits_np((med - minima - 0.5)[:, None])[:, 0])
    tail_upper = 1.0 - sigmoid(logits_np((med + maxima + 0.5)[:, None])[:, 0])
    tail = tail_lower + tail_upper

    from ...coding.rans import pmf_to_quantized_cdf
    cdfs = np.zeros((channels, max_len + 2), np.int32)
    lengths = np.zeros((channels,), np.int32)
    for c in range(channels):
        L = int(pmf_length[c])
        qc = pmf_to_quantized_cdf(pmf[c, :L], tail[c], precision)
        cdfs[c, :len(qc)] = qc
        lengths[c] = len(qc)
    return {"cdf": cdfs, "cdf_length": lengths, "offset": -minima}
