"""Chi-square and closed-form polynomial continuum renormalisation.

The reference renormalises the *data* by a degree-2 polynomial fit to
``data/model`` before computing the spectrum chi-square
(``norm_spec``, ``mft6.py:193-196``; applied at ``mft6.py:1172-1174``):

    frac = data / model
    p = Polynomial.fit(wl, frac, deg=2)      # least squares on scaled domain
    data_renorm = data / p(wl)

``numpy.polynomial.Polynomial.fit`` maps ``wl`` affinely onto [-1, 1] and
solves an ordinary least-squares problem in that basis; evaluating the fit at
the same ``wl`` therefore equals ``V @ pinv(V) @ frac`` for the scaled-domain
Vandermonde ``V``.  Both factors depend only on the (fixed) data wavelength
grid, so we precompute ``V [n,3]`` and ``pinv(V) [3,n]`` once and the per-walker
cost is two tiny matvecs.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np


def chisq(model, data, var):
    """Pointwise ``(model-data)^2 / var^2`` (reference ``chisq``, mft6.py:115-122).

    Note the reference squares ``var`` — i.e. ``var`` is the 1-sigma error.
    """
    return (jnp.asarray(model) - jnp.asarray(data)) ** 2 / jnp.asarray(var) ** 2


def polyfit_renorm_matrix(wl, deg=2):
    """Precompute (V, pinv(V)) for closed-form polynomial fits on a fixed grid.

    Returns float64 numpy arrays; cast to device dtype at pack time.
    """
    wl = np.asarray(wl, dtype=np.float64)
    lo, hi = wl.min(), wl.max()
    x = 2.0 * (wl - lo) / (hi - lo) - 1.0  # affine map onto [-1, 1]
    V = np.vander(x, deg + 1, increasing=True)  # [n, deg+1]
    Vpinv = np.linalg.pinv(V)  # [deg+1, n]
    return V, Vpinv


def continuum_renorm(data, model, V, Vpinv):
    """Renormalised data: ``data / polyfit2(wl, data/model)`` (jit-safe).

    Args:
        data: [n] observed flux.
        model: [n] model flux on the same grid.
        V: [n, k] scaled-domain Vandermonde from :func:`polyfit_renorm_matrix`.
        Vpinv: [k, n] its pseudo-inverse.
    """
    frac = data / model
    # full-f32 contractions on a GPU, which may otherwise run them in TF32
    coeffs = jnp.matmul(Vpinv, frac, precision=jax.lax.Precision.HIGHEST)
    fitted = jnp.matmul(V, coeffs, precision=jax.lax.Precision.HIGHEST)
    return data / fitted
