"""Generalized Divisive Normalization (GDN1) for flat sparse features:
``out = F / (|F| @ gamma + beta)`` (``*`` when inverse).  Parameters are
stored reparameterized as ``sqrt(v + pedestal)`` and recovered with a
lower-bounded square, as in the JAX package."""

import torch
from torch import nn

from .bound import lower_bound

_PEDESTAL = 2.0 ** -18


class GDN(nn.Module):
    def __init__(self, channels, inverse=False, beta_min=1e-6,
                 gamma_init=0.1):
        super().__init__()
        self.inverse = inverse
        self.beta_min = beta_min
        self.beta = nn.Parameter(torch.sqrt(torch.ones(channels) + _PEDESTAL))
        self.gamma = nn.Parameter(torch.sqrt(
            gamma_init * torch.eye(channels) + _PEDESTAL))

    def forward(self, feats):
        beta_bound = (self.beta_min + _PEDESTAL) ** 0.5
        gamma_bound = _PEDESTAL ** 0.5
        beta = lower_bound(self.beta, beta_bound) ** 2 - _PEDESTAL
        gamma = lower_bound(self.gamma, gamma_bound) ** 2 - _PEDESTAL
        norm = torch.abs(feats) @ gamma + beta
        if self.inverse:
            return feats * norm
        return feats / norm
