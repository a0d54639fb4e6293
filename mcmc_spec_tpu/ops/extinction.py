"""CCM89 interstellar extinction (JAX in-graph, numpy host-side).

Re-implements the Cardelli, Clayton & Mathis (1989) extinction law used by the
reference through the Cython ``extinction`` package (``mft6.py:46-64``:
``ext_mag = extinction.ccm89(wl, av, rv); spec = extinction.apply(ext_mag, spec)``).

The curve is a branchwise polynomial in ``x = 1/lambda(um) = 1e4/lambda(AA)``:
infrared (0.3 <= x < 1.1), optical/NIR (1.1 <= x < 3.3), UV (3.3 <= x < 8),
and far-UV (8 <= x <= 10).  ``A(lambda) = Av * (a(x) + b(x)/Rv)``.

Everything is branchless (``where`` masks) so the JAX path traces to a single
fused XLA computation; the hot path precomputes ``k(lambda) = ccm89(wl, 1, rv)``
once and applies ``10**(-0.4 * Av * k)`` per evaluation, which is exact because
CCM89 is linear in Av.

Array-module dispatch: JAX arrays/tracers run through ``jax.numpy`` (jit-safe);
everything else runs through numpy.  Host-side callers (``pack_target`` builds
``k(lambda)`` once per target on float64 numpy) would otherwise trigger ~25
op-by-op XLA compilations each, vs milliseconds in numpy.  The two paths
are bit-identical in float64 (same IEEE element-wise operations).
"""
from __future__ import annotations

import numpy as np

# Optical/NIR polynomial coefficients (CCM89 Table 3), ascending degree.
_OPT_A = np.array([1.0, 0.17699, -0.50447, -0.02427, 0.72085, 0.01979, -0.77530, 0.32999])
_OPT_B = np.array([0.0, 1.41338, 2.28305, 1.07233, -5.38434, -0.62251, 5.30260, -2.09002])


def _xp(arr):
    import jax
    import jax.numpy as jnp

    return jnp if isinstance(arr, jax.Array) else np


def _polyval_ascending(xp, coeffs, y):
    """Evaluate sum_k coeffs[k] * y**k (coeffs in ascending order)."""
    out = xp.zeros_like(y)
    for c in reversed(list(coeffs)):
        out = out * y + c
    return out


def ccm89(wl_aa, av, rv=3.1):
    """CCM89 extinction A(lambda) in magnitudes.

    Args:
        wl_aa: wavelength array in Angstroms (jax or numpy; the jax path is
            jit-traceable, the numpy path compiles nothing).
        av: V-band extinction in magnitudes (scalar).
        rv: ratio of total to selective extinction, default 3.1.

    Returns:
        A(lambda) in magnitudes, same shape as ``wl_aa``.
    """
    xp = _xp(wl_aa)
    wl_aa = xp.asarray(wl_aa)
    x = 1e4 / wl_aa  # inverse microns

    # Infrared: 0.3 <= x < 1.1  (we also extrapolate the power law below 0.3,
    # matching the behaviour needed for long-wavelength model grids)
    xir = xp.power(xp.maximum(x, 1e-12), 1.61)
    a_ir = 0.574 * xir
    b_ir = -0.527 * xir

    # Optical/NIR: 1.1 <= x < 3.3
    y = x - 1.82
    a_opt = _polyval_ascending(xp, _OPT_A, y)
    b_opt = _polyval_ascending(xp, _OPT_B, y)

    # UV: 3.3 <= x < 8
    fa = xp.where(
        x >= 5.9,
        -0.04473 * (x - 5.9) ** 2 - 0.009779 * (x - 5.9) ** 3,
        0.0,
    )
    fb = xp.where(
        x >= 5.9,
        0.2130 * (x - 5.9) ** 2 + 0.1207 * (x - 5.9) ** 3,
        0.0,
    )
    a_uv = 1.752 - 0.316 * x - 0.104 / ((x - 4.67) ** 2 + 0.341) + fa
    b_uv = -3.090 + 1.825 * x + 1.206 / ((x - 4.62) ** 2 + 0.263) + fb

    # Far-UV: 8 <= x <= 10
    z = x - 8.0
    a_fuv = -1.073 - 0.628 * z + 0.137 * z**2 - 0.070 * z**3
    b_fuv = 13.670 + 4.257 * z - 0.420 * z**2 + 0.374 * z**3

    a = xp.where(x < 1.1, a_ir, xp.where(x < 3.3, a_opt, xp.where(x < 8.0, a_uv, a_fuv)))
    b = xp.where(x < 1.1, b_ir, xp.where(x < 3.3, b_opt, xp.where(x < 8.0, b_uv, b_fuv)))

    return av * (a + b / rv)


def apply_extinction(ext_mag, flux):
    """Apply an extinction curve in magnitudes to a flux array."""
    return flux * _xp(flux).power(10.0, -0.4 * ext_mag)


def extinct(wl_aa, flux, av, rv=3.1):
    """Redden ``flux`` by CCM89 extinction (reference ``extinct``, mft6.py:46-64)."""
    return apply_extinction(ccm89(wl_aa, av, rv), flux)
