"""Lambert W in float64 numpy (counterpart of ``repro/core/lambertw.py``).

The paper's optimal allocation (Theorem 2) is built on the lower branch
``W_{-1}(z)`` for ``z = -exp(-(alpha*mu + 1)) in [-1/e, 0)``. Both real
branches are provided:

* ``lambertw0(z)``  — principal branch, ``z >= -1/e``, ``W >= -1``.
* ``lambertwm1(z)`` — lower branch, ``z in [-1/e, 0)``, ``W <= -1``.

Branch-appropriate initial guess, then a fixed number of Halley
iterations, exactly as the reference does it.
"""
from __future__ import annotations

import numpy as np

_HALLEY_ITERS = 12
_TINY = np.finfo(np.float64).tiny


def _halley(w, z, iters: int = _HALLEY_ITERS):
    """Halley iterations for f(w) = w e^w - z."""
    with np.errstate(divide="ignore", invalid="ignore", over="ignore"):
        for _ in range(iters):
            ew = np.exp(w)
            f = w * ew - z
            denom = ew * (w + 1.0) - (w + 2.0) * f / (2.0 * w + 2.0)
            # guard the branch point w = -1 where denom -> 0
            w = w - f / np.where(np.abs(denom) > 0, denom, 1.0)
    return w


def lambertwm1(z):
    """Lower real branch ``W_{-1}`` on ``[-1/e, 0)``; NaN outside it."""
    z = np.asarray(z, dtype=np.float64)
    ez1 = 1.0 + np.e * z
    # branch-point series: W ~ -1 + p - p^2/3 + 11 p^3/72, p = -sqrt(2(1+ez))
    p = -np.sqrt(np.maximum(2.0 * ez1, 0.0))
    w_series = -1.0 + p - p * p / 3.0 + 11.0 * p**3 / 72.0
    # asymptotic for z -> 0^-: W ~ log(-z) - log(-log(-z))
    lz = np.log(np.maximum(-z, _TINY))
    w_asym = lz - np.log(-lz)
    w0 = np.where(ez1 < 0.05, w_series, w_asym)
    w0 = np.minimum(w0, -1.0 - 1e-12)  # stay on the lower branch
    w = _halley(w0, z)
    valid = (z >= -np.exp(-1.0) - 1e-300) & (z < 0)
    return np.where(valid, w, np.nan)


def lambertwm1_neg_exp(c):
    """``W_{-1}(-exp(-c))`` for c >= 1, stable when exp(-c) underflows.

    In log space ``w e^w = -e^{-c}`` becomes ``u = c + log(u)`` with
    ``w = -u``, a fast-converging fixed point for large c.
    """
    c = np.asarray(c, dtype=np.float64)
    direct = lambertwm1(-np.exp(-np.minimum(c, 30.0)))
    u = c + np.log(np.maximum(c, 1.1))
    for _ in range(5):
        u = c + np.log(u)
    return np.where(c < 30.0, direct, -u)


def lambertw0(z):
    """Principal real branch ``W_0`` on ``[-1/e, inf)``; NaN below it."""
    z = np.asarray(z, dtype=np.float64)
    ez1 = 1.0 + np.e * z
    p = np.sqrt(np.maximum(2.0 * ez1, 0.0))
    w_series = -1.0 + p - p * p / 3.0 + 11.0 * p**3 / 72.0
    lz = np.log(np.maximum(z, _TINY))
    w_large = lz - np.log(np.maximum(lz, _TINY))
    w0 = np.where(z < 0.25, w_series,
                  np.where(z < 3.0, np.log1p(np.maximum(z, -0.5)) * 0.7, w_large))
    w0 = np.maximum(w0, -1.0 + 1e-12)
    w = _halley(w0, z)
    valid = z >= -np.exp(-1.0) - 1e-300
    return np.where(valid, w, np.nan)
