"""Count-median spectrum lane: the spectrum chi^2 without a sort.

The sort-based composition (``inference.batched._spec_chi2_xla``) sorts the
whole ``[nw, nd]`` model for its median, which grows with nd; for the
native-resolution regime (nd ~ 10^5-10^6, PHOENIX HiRes; see
``parallel.spec_shard``) the GPU runs the same semantics here, beyond
``flags.LARGE_ND``, as plain XLA:

* the grid matmul fused with CCM89 extinction (one write of the ``[NW, nd]``
  model);
* ``median_nonneg_xla`` — the exact rank median as a **k-ary radix count
  search**: 2 bits per round (3 thresholds, whose counts XLA fuses into one
  pass over the bitcast model), 16 rounds for f32 instead of the 31 a
  bisection needs and no sort.  Bit-identical to the sorted-rank median (it
  is an exact order-statistic search; tests pin this).  ``psum_axis`` makes the
  same search distributed — ``parallel.spec_shard`` uses it with the counts
  psum'd over the spec mesh;
* the continuum-renorm projection and the residual sum, which XLA fuses
  into reductions over the model.

Semantics are pinned against ``inference.batched._spec_chi2_xla`` /
``_spec_chi2_xla_median_only`` (tests/test_spec_segmented.py).  Reference
scope: the reference decimates to coarse grids instead of scaling
(``redres``, mft6.py:154-170); this regime has no reference counterpart.
"""
from __future__ import annotations

import functools

import jax
import jax.numpy as jnp

_HI = jax.lax.Precision.HIGHEST
LN10_04 = -0.4 * 2.302585092994046  # -0.4 * ln(10)


# ------------------------------------------------------------ k-ary median
def _kary_order_stat_bits(mi, rank, total_bits: int, psum_axis=None,
                          iters: int | None = None):
    """Smallest bit-value v per row with (global) count(mi <= v) >= rank.

    2-bit radix rounds: the candidate interval [lo, lo + 2^shift) always has
    power-of-two width with lo's low bits zero, so the three quartile
    thresholds ``lo + k*2^(shift-2) - 1`` partition it EXACTLY — after
    ceil(total_bits/2) rounds the interval has width 1 and the result equals
    a one-bit bisection's bit for bit, in half the passes over the data /
    half the psum latency rounds.

    ``iters`` (None/>=total_bits = exact) is the FAST-MEDIAN dial in
    single-bit units: resolve at least ``iters`` bits (ceil(iters/2) 2-bit rounds) and return the
    MIDPOINT of the remaining 2^(total_bits - 2*ceil(iters/2))-wide
    interval — the same worst-case bit-interval width as ``iters``
    bisection passes, so the alpha^2 tempering bound (0.027 sigma at
    iters=14, renorm path only) applies unchanged.  Each round is one
    pass over the data, so iters=14 costs 7 passes where the exact search
    costs 16.

    ``mi``: [B, nd_local] int bit patterns of non-negative floats;
    ``rank``: [B, 1] 1-based; ``psum_axis``: spec-mesh axis name for the
    distributed form (counts are additive over shards — the fast mode is
    bit-identical sharded vs single-chip, like the exact one).
    """
    itype = mi.dtype
    B = mi.shape[0]
    lo = jnp.zeros((B, 1), itype)
    one = jnp.asarray(1, itype)
    exact = iters is None or iters >= total_bits
    # lowest shift the round loop is allowed to touch (0 = run to width 1)
    stop = 0 if exact else total_bits - 2 * ((iters + 1) // 2)

    def count_le(v):
        c = jnp.sum((mi <= v).astype(jnp.int32), axis=1, keepdims=True)
        return jax.lax.psum(c, psum_axis) if psum_axis is not None else c

    def round2(shift, lo):
        # quartile thresholds of [lo, lo + 2^(shift)) — XLA fuses the three
        # sibling count reductions into one pass over mi, and the counts
        # travel as ONE [B, 3] psum (not three launches — the collective
        # census in bench_suite.py `spshard` pins the per-eval count)
        q = one << jnp.asarray(shift - 2, itype)
        m1 = lo + q - one
        m2 = lo + (q + q) - one
        m3 = lo + (q + q + q) - one
        c = jnp.concatenate([
            jnp.sum((mi <= m).astype(jnp.int32), axis=1, keepdims=True)
            for m in (m1, m2, m3)], axis=1)
        if psum_axis is not None:
            c = jax.lax.psum(c, psum_axis)
        d = ((c[:, 0:1] < rank).astype(itype) + (c[:, 1:2] < rank).astype(itype)
             + (c[:, 2:3] < rank).astype(itype))
        return lo + d * q

    shift = total_bits
    while shift >= 2 and shift > stop:
        lo = round2(shift, lo)
        shift -= 2
    if not exact:
        # fast mode: bracket midpoint of [lo, lo + 2^shift), no final count
        return lo + (one << jnp.asarray(shift - 1, itype))
    if shift == 1:
        m = lo  # [lo, lo+1]: is lo itself enough?
        c = count_le(m)
        lo = jnp.where(c >= rank, lo, lo + one)
    return lo


def median_nonneg_xla(model, n_true, psum_axis=None, iters: int | None = None):
    """np.median over (globally) non-negative rows, count-based.

    The large-nd / distributed median: same semantics as the sorted-rank
    median (``batched._spec_chi2_xla``), without a sort.  ``n_true`` is the global
    count of REAL points (padding carries the 1e30 sentinel).  Non-negative
    precondition as in ``parallel.spec_shard._dist_median_nonneg``.

    ``iters`` (None/0/31 = exact) is the fast-median dial: iters < 31 returns the
    bit-interval midpoint after ceil(iters/2) 2-bit rounds and SKIPS the
    even-rank upper-middle refinement (2 further full passes over the
    data, plus a pmin when distributed) — valid only on the renorm scoring
    path, whose alpha^2 factorization bounds the posterior shift (0.027
    sigma at 14; scripts/median_tempering_bound_cpu.py).  Exact mode is bit-identical to
    the sorted-rank median; both modes are bit-identical sharded vs
    single-chip (counts are psum-additive).

    The dial is in the pack-time f32 convention (``utils.flags``: 8..31,
    31 = exact) for EVERY dtype: on the x64 test lane 31 still means
    exact, and a fast setting resolves iters+3 of the 63 bit-positions —
    11-bit exponent vs f32's 8 plus the same mantissa depth, so the
    RELATIVE bracket width (the eps the alpha^2 bound tempers) matches
    the f32 contract bit-position for bit-position.
    """
    if model.dtype == jnp.float64:
        itype, total_bits = jnp.int64, 63
    else:
        itype, total_bits = jnp.int32, 31
    exact = iters is None or iters == 0 or iters >= 31
    eff_iters = None if exact else (iters if total_bits == 31 else iters + 3)
    mi = jax.lax.bitcast_convert_type(model, itype)
    n_true = jnp.asarray(n_true, jnp.int32)
    r1 = ((n_true + 1) // 2).astype(jnp.int32).reshape(-1)
    r1 = jnp.broadcast_to(r1, (model.shape[0],))[:, None]

    v1 = _kary_order_stat_bits(mi, r1, total_bits, psum_axis,
                               iters=eff_iters)
    x1 = jax.lax.bitcast_convert_type(v1, model.dtype)
    if not exact:
        # bracket midpoint; no upper-middle refinement
        return x1[:, 0]

    # upper middle (even n_true): x1 again if it repeats past rank r1, else
    # the (globally) next-larger element
    cnt1 = jnp.sum((mi <= v1).astype(jnp.int32), axis=1, keepdims=True)
    if psum_axis is not None:
        cnt1 = jax.lax.psum(cnt1, psum_axis)
    bigger = jnp.where(mi > v1, model, jnp.inf)
    x2 = jnp.min(bigger, axis=1, keepdims=True)
    if psum_axis is not None:
        x2 = jax.lax.pmin(x2, psum_axis)
    x2 = jnp.where(cnt1 >= r1 + 1, x1, x2)
    med = jnp.where(n_true % 2 == 1, x1, 0.5 * (x1 + x2))
    return med[:, 0]


# ------------------------------------------------------------- composition
@functools.partial(jax.jit, static_argnames=("iters", "renorm"))
def spectrum_chi2_segmented(
    Wcomb, av, D_flat, ext_k_data, data_flux, data_err, V, Vpinv, med_data,
    n_data_true, *, iters: int, renorm: bool = True,
):
    """Mean spectrum chi^2 through the count median — the large-nd lane.

    Same semantics as ``batched._spec_chi2_xla`` (renorm=True) /
    ``_spec_chi2_xla_median_only`` (renorm=False): rank median over the
    real (unpadded) points, scaled by med_data, deg-2 continuum renorm of
    the data, mean residual over n_data_true.  ``iters`` is the pack-time
    fast-median dial: the count median re-reads the ``[NW, nd]`` model once
    per round (16 rounds + 2 even-rank scans exact), and iters=14 (7
    rounds, bracket midpoint, no even-rank scans) holds to the 14-pass
    accuracy contract (alpha^2 bound, 0.027 sigma).  The renorm=False (annealer) convention has no such protection
    and always gets the exact median, same policy as
    ``batched.optimizer_chi2_batch``.
    """
    if not 0 <= iters <= 31:
        raise ValueError(f"iters={iters}: need 0..31 (0 and 31 are exact)")
    model = jnp.matmul(Wcomb, D_flat, precision=_HI)
    trans = jnp.where((av > 0)[:, None],
                      jnp.exp(LN10_04 * av[:, None] * ext_k_data[None, :]), 1.0)
    model = model * trans
    med = median_nonneg_xla(model, n_data_true, iters=iters if renorm else 31)
    model = model * (med_data / med)[:, None]
    if renorm:
        coeffs = jnp.matmul(data_flux[None, :] / model, Vpinv.T, precision=_HI)
        data_ref = data_flux[None, :] / jnp.matmul(coeffs, V.T, precision=_HI)
    else:
        data_ref = data_flux[None, :]
    resid2 = ((model - data_ref) / data_err) ** 2
    resid2 = jnp.where(jnp.isfinite(resid2), resid2, 0.0)  # padded: err=inf
    return jnp.sum(resid2, axis=1) / jnp.asarray(n_data_true, model.dtype)
