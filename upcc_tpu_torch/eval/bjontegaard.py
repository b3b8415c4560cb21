"""Bjøntegaard-delta rate/quality between two RD curves.

The port's copy of the JAX package's ``eval/bjontegaard.py``: the standard
BD construction (Bjøntegaard, VCEG-M33) in log-rate space, BD-PSNR and
BD-Rate as definite integrals over the overlapping range, with a
shape-preserving monotone piecewise cubic (PCHIP) as the interpolant
instead of one global cubic polynomial.

Why PCHIP: a global cubic through a *saturating* RD curve (many
near-duplicate quality values — what a learned codec produces past its
quality ceiling) is ill-conditioned; it oscillates by orders of magnitude
*inside* the interpolation range and turns BD-rate into garbage.  PCHIP is
local and monotonicity-preserving, so the integral is always bounded by the
data.
"""

import numpy as np
from scipy.interpolate import PchipInterpolator


def _prep(x, y):
    """Sort by x and merge duplicate/near-duplicate abscissae (mean y).

    PCHIP needs strictly increasing x; RD sweeps routinely contain repeated
    quality values (saturated corner points) and, after Pareto filtering,
    repeated rates.  Points closer than ``tol`` in x are one knot."""
    x = np.asarray(x, float)
    y = np.asarray(y, float)
    order = np.argsort(x, kind="stable")
    x, y = x[order], y[order]
    span = x[-1] - x[0]
    tol = max(span, 1.0) * 1e-9
    xs, ys = [x[0]], [[y[0]]]
    for xi, yi in zip(x[1:], y[1:]):
        if xi - xs[-1] <= tol:
            ys[-1].append(yi)
        else:
            xs.append(xi)
            ys.append([yi])
    return np.array(xs), np.array([float(np.mean(g)) for g in ys])


def _interpolant(x, y):
    """PCHIP through the deduplicated knots; a degenerate curve (all
    abscissae equal, e.g. an untrained model emitting constant bpp)
    collapses to the constant function instead of raising."""
    xs, ys = _prep(x, y)
    if len(xs) < 2:
        c = float(ys[0])
        return lambda t: np.full_like(np.asarray(t, float), c)
    return PchipInterpolator(xs, ys, extrapolate=True)


def _fit_and_integrate(x, y, lo, hi):
    """Mean of the PCHIP interpolant of (x, y) over [lo, hi]."""
    xs, ys = _prep(x, y)
    if len(xs) < 2 or hi <= lo:
        return float("nan")
    f = PchipInterpolator(xs, ys, extrapolate=True)
    return float(f.integrate(lo, hi)) / (hi - lo)


def _overlap_fraction(a, b):
    """Fraction of the NARROWER range covered by the intersection, in [0, 1].

    Both BD integrals are evaluated on the intersection only (pure
    interpolation for both fits), so the quantity the gate must bound is
    how representative that shared domain is of the curves — measured
    against the narrower one.  Dividing by the union instead would NaN a
    candidate curve fully bracketed by a wider anchor sweep (overlap 1.0
    of the candidate, ~0.1 of the union)."""
    lo, hi = max(a.min(), b.min()), min(a.max(), b.max())
    span = min(a.max() - a.min(), b.max() - b.min())
    return float(max(0.0, hi - lo) / span) if span > 0 else 0.0


def rate_overlap(rate_a, rate_b):
    """Overlap fraction of the two curves' log-rate ranges (the bd_psnr
    integration domain)."""
    return _overlap_fraction(np.log10(np.asarray(rate_a, float)),
                             np.log10(np.asarray(rate_b, float)))


def quality_overlap(psnr_a, psnr_b):
    """Overlap fraction of the two curves' quality ranges (the bd_rate
    integration domain)."""
    return _overlap_fraction(np.asarray(psnr_a, float),
                             np.asarray(psnr_b, float))


def bd_psnr(rate_a, psnr_a, rate_b, psnr_b, min_overlap=0.0):
    """Average quality gain of curve B over anchor A (dB) at equal rate.

    Returns NaN when the intersection of the curves' log-rate ranges
    covers no more than ``min_overlap`` of the narrower range — a
    sliver-sized shared domain makes the averaged delta unrepresentative
    of either curve."""
    la, lb = np.log10(np.asarray(rate_a, float)), np.log10(np.asarray(rate_b, float))
    if _overlap_fraction(la, lb) <= min_overlap:
        return float("nan")
    lo = max(la.min(), lb.min())
    hi = min(la.max(), lb.max())
    ia = _fit_and_integrate(la, np.asarray(psnr_a, float), lo, hi)
    ib = _fit_and_integrate(lb, np.asarray(psnr_b, float), lo, hi)
    return float(ib - ia)


def bd_rate(rate_a, psnr_a, rate_b, psnr_b, min_overlap=0.0):
    """Average rate change of curve B vs anchor A (%) at equal quality.

    Returns NaN when the intersection of the quality ranges covers no
    more than ``min_overlap`` of the narrower range (see bd_psnr)."""
    la, lb = np.log10(np.asarray(rate_a, float)), np.log10(np.asarray(rate_b, float))
    pa, pb = np.asarray(psnr_a, float), np.asarray(psnr_b, float)
    if _overlap_fraction(pa, pb) <= min_overlap:
        return float("nan")
    lo = max(pa.min(), pb.min())
    hi = min(pa.max(), pb.max())
    ia = _fit_and_integrate(pa, la, lo, hi)
    ib = _fit_and_integrate(pb, lb, lo, hi)
    return float((10.0 ** (ib - ia) - 1.0) * 100.0)


class BjontegaardModel:
    """Fitted RD model for plotting interpolated curves, on the same
    PCHIP interpolant the deltas integrate."""

    def __init__(self, rate, quality):
        lr = np.log10(np.asarray(rate, float))
        q = np.asarray(quality, float)
        self._quality_of_lograte = _interpolant(lr, q)
        self._lograte_of_quality = _interpolant(q, lr)

    def quality_at(self, rate):
        return self._quality_of_lograte(np.log10(rate))

    def rate_at(self, quality):
        return 10.0 ** self._lograte_of_quality(quality)
