"""Entropy models: factorized bottleneck, Gaussian conditional, hyperprior."""

from . import gaussian
from .bottleneck import FactorizedBottleneck
from .hyperprior import MeanScaleHyperprior
