"""Interpolation primitives: fixed-grid projections and bilinear (T, logg) blends.

Two kinds of interpolation dominate the reference's hot loop:

1. ``scipy.interpolate.interp1d`` from the model wavelength grid onto the data
   grid, rebuilt per evaluation (``mft6.py:1169-1170``).  Piecewise-linear
   interpolation onto a *fixed* target grid is a sparse linear map; we
   precompute the (index, weight) pairs once (:func:`interp1d_weights`) and
   apply them as two gathers + blend (:func:`apply_interp`), or bake them all
   the way into the grid tensor at pack time (exact, since the map commutes
   with every linear op in the forward model).

2. Bilinear interpolation in (Teff, logg) between the 4 bracketing grid
   spectra (``get_spec``/``interp_2_spec``, ``mft6.py:387-563,198-209``).  The
   reference re-globs the model directory per call to discover the grid axes;
   here the axes are static device arrays and bracketing is a
   ``searchsorted`` + clip (:func:`bilinear_bracket`), with the blend as a
   4-row gather (:func:`bilinear_gather_blend`).  Degenerate brackets (query
   exactly on a grid point) fall out of the same formula with weight 0/1,
   matching the reference's special-cased branches.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np


def interp1d_weights(src_wl, dst_wl):
    """(idx, w) such that ``f_dst = (1-w)*f_src[idx] + w*f_src[idx+1]``.

    Matches ``scipy.interpolate.interp1d(kind='linear')`` on in-range targets.
    Host-side precompute; returns numpy int32/float64.
    """
    src = np.asarray(src_wl, dtype=np.float64)
    dst = np.asarray(dst_wl, dtype=np.float64)
    idx = np.searchsorted(src, dst, side="right") - 1
    idx = np.clip(idx, 0, len(src) - 2)
    w = (dst - src[idx]) / (src[idx + 1] - src[idx])
    return idx.astype(np.int32), w


def linear_interp_matrix(src_wl, dst_wl):
    """Dense [n_dst, n_src] linear-interpolation matrix (for grid projection)."""
    idx, w = interp1d_weights(src_wl, dst_wl)
    n_dst, n_src = len(np.asarray(dst_wl)), len(np.asarray(src_wl))
    M = np.zeros((n_dst, n_src), dtype=np.float64)
    rows = np.arange(n_dst)
    np.add.at(M, (rows, idx), 1.0 - w)
    np.add.at(M, (rows, idx + 1), w)
    return M


def apply_interp(idx, w, flux):
    """Apply precomputed interp1d weights along the last axis (jit-safe)."""
    f0 = jnp.take(flux, idx, axis=-1)
    f1 = jnp.take(flux, idx + 1, axis=-1)
    return f0 * (1.0 - w) + f1 * w


def bilinear_bracket(axis_vals, q):
    """Bracketing index and fractional weight on a sorted 1-D axis (jit-safe).

    Returns ``(i, w)`` with ``axis_vals[i] <= q <= axis_vals[i+1]`` (clipped to
    the axis range) and ``w = (q - axis_vals[i]) / (axis_vals[i+1] - axis_vals[i])``.
    """
    axis_vals = jnp.asarray(axis_vals)
    i = jnp.clip(jnp.searchsorted(axis_vals, q, side="right") - 1, 0, axis_vals.shape[0] - 2)
    lo = axis_vals[i]
    hi = axis_vals[i + 1]
    w = (q - lo) / (hi - lo)
    return i, w


def tent_weights(nodes, q):
    """Piecewise-linear (tent/hat) basis weights, branchless and gather-free.

    ``w[..., j]`` is node j's linear-interpolation weight for query ``q``:
    ``tent_weights(nodes, q) @ ys == np.interp(q, nodes, ys)`` exactly
    (including edge clamping).  A per-query scalar gather does not
    vectorize over a walker batch; this formulation is a [..., n_nodes]
    broadcast + matvec that does.
    """
    nodes = jnp.asarray(nodes)
    q = jnp.asarray(q)[..., None]
    prev = jnp.concatenate([nodes[:1] - 1.0, nodes[:-1]])
    nxt = jnp.concatenate([nodes[1:], nodes[-1:] + 1.0])
    left = (q - prev) / (nodes - prev)
    right = (nxt - q) / (nxt - nodes)
    w = jnp.clip(jnp.minimum(left, right), 0.0, 1.0)
    # edge clamping: the first/last node keeps full weight outside the range
    w0 = jnp.clip((nodes[1] - q[..., 0]) / (nodes[1] - nodes[0]), 0.0, 1.0)
    wn = jnp.clip((q[..., 0] - nodes[-2]) / (nodes[-1] - nodes[-2]), 0.0, 1.0)
    w = w.at[..., 0].set(w0)
    w = w.at[..., -1].set(wn)
    return w


def pwl_interp(xs, ys, q):
    """``np.interp(q, xs, ys)`` as a tent-basis matvec (jit/vmap-safe, no gathers)."""
    return jnp.matmul(tent_weights(xs, q), jnp.asarray(ys),
                      precision=jax.lax.Precision.HIGHEST)


def bilinear_gather_blend(table, ti, tw, gi, gw):
    """Bilinearly blend ``table[nT, nG, ...]`` at fractional indices (jit-safe).

    ``ti, tw`` from :func:`bilinear_bracket` on the Teff axis, ``gi, gw`` on the
    logg axis.  Matches the reference's logg-then-Teff linear blending
    (``mft6.py:507-519``) — bilinear interpolation is order-independent.
    """
    f00 = table[ti, gi]
    f01 = table[ti, gi + 1]
    f10 = table[ti + 1, gi]
    f11 = table[ti + 1, gi + 1]
    f0 = f00 * (1.0 - gw) + f01 * gw
    f1 = f10 * (1.0 - gw) + f11 * gw
    return f0 * (1.0 - tw) + f1 * tw
