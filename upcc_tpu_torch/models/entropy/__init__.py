"""Entropy models: factorized bottleneck, Gaussian conditional, hyperprior."""
