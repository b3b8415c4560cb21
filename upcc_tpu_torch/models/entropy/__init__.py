"""Entropy models: factorized bottleneck, Gaussian conditional, hyperprior."""

from . import gaussian
from .bottleneck import FactorizedBottleneck, build_cdf_tables
from .hyperprior import MeanScaleHyperprior
