"""Explicitly-batched posterior: the production hot path.

Semantics are identical to :mod:`mcmc_spec_tpu.inference.posterior` (the
per-walker reference implementation, golden-tested against the reference
emulator); this module re-expresses the computation for a whole walker batch
``[nw, ndim]`` at once:

* **No gathers, no searchsorted.**  All interpolations are branchless
  tent-basis weightings (:func:`tent_weights`), which vectorize over the
  walker batch.
* **Bilinear grid blending as a matmul.**  The (Teff, logg) bilinear
  weights are the outer product of two tent bases, giving a per-walker weight
  row over the ``nT*nG`` grid points; the batch's model spectra are then one
  ``[nw, nT*nG] @ [nT*nG, nd]`` matmul (and the filter fluxes tiny ones).
* Everything else (extinction, median match, continuum renorm, chi^2) is
  fused elementwise/reduction work on ``[nw, nd]``.

One intentional edge difference from the scalar path: tent weights clamp at
the grid edges instead of linearly extrapolating beyond them.  Inside the
prior support (temperatures within the grid, MIST logg within its table) the
two paths agree to float tolerance; out-of-support walkers are -inf either way.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp

from mcmc_spec_tpu.inference.target import PC_CM, RSUN_CM, PackedTarget
from mcmc_spec_tpu.models.mist import LSUN, RSUN, SIGMA_SB
from mcmc_spec_tpu.ops.interp import tent_weights

# A GPU may run an f32 matmul in TF32 (~1e-3 relative error), far too coarse
# for chi^2 against ~1%-error data: every contraction in the hot path asks
# for full f32.
_HI = jax.lax.Precision.HIGHEST


def _unpack_batch(p, tgt: PackedTarget):
    n = tgt.nspec
    teffs = p[:, :n]
    av = p[:, n]
    if tgt.fit_plx:
        r1 = p[:, n + 1]
        ratios = p[:, n + 2 : 2 * n + 1]
        plx = p[:, 2 * n + 1]
    else:
        r1 = jnp.ones_like(av)
        ratios = p[:, n + 1 : 2 * n]
        plx = jnp.zeros_like(av)
    return teffs, av, r1, ratios, plx


def _scales_batch(tgt, r1, ratios, plx):
    if tgt.fit_plx:
        base = (r1 * RSUN_CM * plx / PC_CM) ** 2
        return jnp.concatenate([base[:, None], base[:, None] * ratios**2], axis=1)
    return jnp.concatenate([jnp.ones_like(r1)[:, None], ratios**2], axis=1)


def mist_logg_batch(tgt, teffs):
    return jnp.matmul(tent_weights(tgt.mist_teff_nodes, teffs), tgt.mist_logg_nodes,
                      precision=_HI)


def mist_radius_batch(tgt, teffs):
    lum = jnp.matmul(tent_weights(tgt.mist_teff_nodes, teffs), tgt.mist_lum_nodes,
                     precision=_HI)
    return jnp.sqrt(lum * LSUN / (4.0 * jnp.pi * SIGMA_SB * teffs**4)) / RSUN


def _forward_small(p, tgt: PackedTarget):
    """Everything except the model-spectrum matmul: weights + band fluxes."""
    n = tgt.nspec
    teffs, av, r1, ratios, plx = _unpack_batch(p, tgt)
    scales = _scales_batch(tgt, r1, ratios, plx)  # [nw, nspec]
    loggs = mist_logg_batch(tgt, teffs)  # [nw, nspec]

    Wt = tent_weights(tgt.temps, teffs)  # [nw, nspec, nT]
    Wg = tent_weights(tgt.loggs, loggs)  # [nw, nspec, nG]
    Wk = jnp.einsum("wst,wsg->wstg", Wt, Wg)
    nw = p.shape[0]
    nT, nG, nd = tgt.D.shape
    Wk = Wk.reshape(nw, n, nT * nG)  # per-component grid weights
    Wcomb = jnp.einsum("ws,wso->wo", scales, Wk, precision=_HI)  # [nw, nT*nG]

    tiny = jnp.asarray(jnp.finfo(p.dtype).tiny, dtype=p.dtype)
    cflux = jnp.einsum("wso,oc->wsc", Wk, tgt.Fc.reshape(nT * nG, -1), precision=_HI)
    cflux = cflux * scales[..., None]
    mags = -2.5 * jnp.log10(jnp.maximum(cflux, tiny))  # [nw, nspec, nc]
    if n == 1:
        contrasts = jnp.zeros((p.shape[0], tgt.n_contrast), dtype=p.dtype)
    elif n == 2:
        contrasts = mags[:, 1, :] - mags[:, 0, :]
    else:
        nc = tgt.n_contrast
        idx = jnp.arange(nc)
        contrasts = jnp.where(idx[None, :] < nc // 2,
                              mags[:, 1, :] - mags[:, 0, :],
                              mags[:, 2, :] - mags[:, 0, :])

    pflux = jnp.matmul(Wcomb, tgt.Fp.reshape(nT * nG, -1), precision=_HI)  # [nw, npf]
    phot = -2.5 * jnp.log10(jnp.maximum(pflux / tgt.phot_zp, tiny))
    return contrasts, phot, scales, Wk, Wcomb


def forward_batch(p, tgt: PackedTarget):
    """(model [nw,nd], contrasts [nw,nc], phot [nw,npf], scales, Wk)."""
    contrasts, phot, scales, Wk, Wcomb = _forward_small(p, tgt)
    nT, nG, nd = tgt.D.shape
    model = jnp.matmul(Wcomb, tgt.D.reshape(nT * nG, nd), precision=_HI)
    return model, contrasts, phot, scales, Wk


def _spec_chi2_xla(Wcomb, av, tgt: PackedTarget):
    """Sort-lane spectrum chi^2 (mean over data points): rank median by a row sort."""
    nT, nG, nd = tgt.D.shape
    model_raw = jnp.matmul(Wcomb, tgt.D.reshape(nT * nG, nd), precision=_HI)
    apply_ext = (av > 0)[:, None]
    trans = jnp.where(
        apply_ext,
        jnp.exp((-0.4 * jnp.log(10.0)) * av[:, None] * tgt.ext_k_data[None, :]),
        1.0,
    )
    model = model_raw * trans
    # rank-based median so fleet padding (sentinel 1e30 entries) is ignored
    srt = jnp.sort(model, axis=1)
    i0 = (tgt.n_data_true - 1) // 2
    i1 = tgt.n_data_true // 2
    med = 0.5 * (jnp.take(srt, i0, axis=1) + jnp.take(srt, i1, axis=1))
    model = model * (tgt.med_data / med)[:, None]
    frac = tgt.data_flux[None, :] / model
    coeffs = jnp.matmul(frac, tgt.Vpinv.T, precision=_HI)  # [nw, 3]
    data_renorm = tgt.data_flux[None, :] / jnp.matmul(coeffs, tgt.V.T, precision=_HI)
    resid2 = ((model - data_renorm) / tgt.data_err) ** 2
    # padded points have err=inf -> exact zero contribution
    resid2 = jnp.where(jnp.isfinite(resid2), resid2, 0.0)
    return jnp.sum(resid2, axis=1) / tgt.n_data_true.astype(model.dtype)


def _spec_chi2_xla_median_only(Wcomb, av, tgt: PackedTarget):
    """ANNEALER spectrum chi^2: median match, NO continuum renorm.

    ``fit_spec`` scores the median-matched model against the RAW data
    (mft6.py:1007-1014); the deg-2 renorm of the data is an emcee-stage
    refinement (mft6.py:1172-1174) the reference's stage 1 never applies.
    """
    nT, nG, nd = tgt.D.shape
    model_raw = jnp.matmul(Wcomb, tgt.D.reshape(nT * nG, nd), precision=_HI)
    apply_ext = (av > 0)[:, None]
    trans = jnp.where(
        apply_ext,
        jnp.exp((-0.4 * jnp.log(10.0)) * av[:, None] * tgt.ext_k_data[None, :]),
        1.0,
    )
    model = model_raw * trans
    srt = jnp.sort(model, axis=1)
    i0 = (tgt.n_data_true - 1) // 2
    i1 = tgt.n_data_true // 2
    med = 0.5 * (jnp.take(srt, i0, axis=1) + jnp.take(srt, i1, axis=1))
    model = model * (tgt.med_data / med)[:, None]
    resid2 = ((model - tgt.data_flux[None, :]) / tgt.data_err) ** 2
    resid2 = jnp.where(jnp.isfinite(resid2), resid2, 0.0)  # padded: err=inf
    return jnp.sum(resid2, axis=1) / tgt.n_data_true.astype(model.dtype)


def _spec_chi2(Wcomb, av, tgt: PackedTarget, renorm: bool):
    """Mean spectrum chi^2 through the lane ``flags.spectrum_lane`` picks.

    Both lanes carry both scoring conventions: ``renorm=True`` is the
    emcee-stage likelihood, ``renorm=False`` the annealer's median-only chi^2.
    """
    from mcmc_spec_tpu.utils.flags import spectrum_lane

    nT, nG, nd = tgt.D.shape
    if spectrum_lane(nd) == "xla":
        return (_spec_chi2_xla if renorm else _spec_chi2_xla_median_only)(Wcomb, av, tgt)
    from mcmc_spec_tpu.ops.spec_segmented import spectrum_chi2_segmented

    return spectrum_chi2_segmented(
        Wcomb, av, tgt.D.reshape(nT * nG, nd), tgt.ext_k_data, tgt.data_flux,
        tgt.data_err, tgt.V, tgt.Vpinv, tgt.med_data, tgt.n_data_true,
        iters=tgt.median_iters, renorm=renorm)


def _chi2_terms_batch(p, tgt: PackedTarget, spec_mult, chi_spec=None,
                      renorm=True):
    n = tgt.nspec
    av = p[:, n]
    contrasts, phot_raw, _, _, Wcomb = _forward_small(p, tgt)

    if chi_spec is not None:
        pass  # precomputed (the spectral-sharded path)
    elif tgt.spectrum_weight == 0.0:
        # nospec mode: the spectrum term is dropped entirely (mft6_nospec.py)
        chi_spec = jnp.zeros(p.shape[0], dtype=p.dtype)
    else:
        with jax.named_scope("spectrum_chi2"):
            chi_spec = _spec_chi2(Wcomb, av, tgt, renorm).astype(p.dtype)

    apply_ext = (av > 0)[:, None]
    phot = jnp.where(apply_ext, phot_raw + av[:, None] * tgt.ext_k_cwl[None, :], phot_raw)
    chi_c = jnp.sum(((contrasts - tgt.cmag) / tgt.cerr) ** 2, axis=1)
    chi_p = jnp.sum(((phot - tgt.pmag) / tgt.perr) ** 2, axis=1)

    nc_t = tgt.n_contrast_true.astype(chi_c.dtype)
    np_t = tgt.n_phot_true.astype(chi_c.dtype)
    if tgt.fit_plx:
        weight = spec_mult * (nc_t + np_t)
    else:
        weight = spec_mult * nc_t
        chi_p = jnp.zeros_like(chi_p)
    return tgt.spectrum_weight * weight * chi_spec, chi_c, chi_p


def chi2_total_batch(p, tgt: PackedTarget, spec_mult=1.0, chi_spec=None,
                     renorm=True):
    a, b, c = _chi2_terms_batch(p, tgt, spec_mult, chi_spec=chi_spec,
                                renorm=renorm)
    return a + b + c


def log_likelihood_batch(p, tgt: PackedTarget, chi_spec=None):
    cs = chi2_total_batch(p, tgt, spec_mult=1.0, chi_spec=chi_spec)
    return jnp.where(jnp.isnan(cs), -jnp.inf, -0.5 * cs)


def _bounds_ok_batch(p, tgt: PackedTarget):
    n = tgt.nspec
    teffs, av, r1, ratios, plx = _unpack_batch(p, tgt)
    ok = jnp.all(teffs <= tgt.tmax, axis=1) & jnp.all(teffs >= tgt.tmin, axis=1) & (av >= 0)
    ok &= jnp.all(ratios >= 0.05, axis=1)
    if tgt.fit_plx:
        ok &= r1 >= 0.05
        if tgt.dist_fit:
            # nospec mode tightens the parallax upper bound to 1/100
            # (mft6_nospec.py:1228 vs mft6.py:1227)
            plx_hi = 0.01 if tgt.spectrum_weight == 0.0 else 0.25
            if n <= 2:
                ok &= (r1 <= 1.5) & (plx >= 1.0 / 3000.0) & (plx <= plx_hi)
            else:
                ok &= (plx >= 1.0 / 1000.0) & (plx <= plx_hi)
    return ok


def log_prior_batch(p, tgt: PackedTarget):
    n = tgt.nspec
    teffs, av, r1, ratios, plx = _unpack_batch(p, tgt)
    lp = jnp.zeros(p.shape[0], dtype=p.dtype)

    if tgt.fit_plx:
        dist_pc = 1.0 / jnp.maximum(plx, 1e-12)
        logd = jnp.log(jnp.maximum(dist_pc, 1e-3))
        w = tent_weights(tgt.av_logd_nodes, logd)
        mu = jnp.matmul(w, tgt.av_mu_nodes, precision=_HI)
        sig = jnp.matmul(w, tgt.av_sig_nodes, precision=_HI)
        lp += -0.5 * ((av - mu) / sig) ** 2

    active = (tgt.prior_mu != 0)[None, :]
    lp += jnp.sum(
        jnp.where(active, -0.5 * ((p - tgt.prior_mu[None, :]) / tgt.prior_sig[None, :]) ** 2, 0.0),
        axis=1,
    )

    if tgt.rad_prior:
        mrad = mist_radius_batch(tgt, teffs)  # [nw, nspec]
        m1 = mrad[:, 0]
        model_vals = jnp.concatenate([m1[:, None], mrad[:, 1:] / m1[:, None]], axis=1)
        if tgt.fit_plx:
            rvals = jnp.concatenate([r1[:, None], ratios], axis=1)
        else:
            rvals = ratios
            model_vals = model_vals[:, 1:]
        lp += jnp.sum(-0.5 * ((rvals - model_vals) / (tgt.rad_sigma_frac * model_vals)) ** 2, axis=1)

    ok = _bounds_ok_batch(p, tgt)
    return jnp.where(ok, lp, -jnp.inf)


def log_posterior_batch(p, tgt: PackedTarget, chi_spec=None):
    """Batched ``logposterior``: the sampler hot path.

    ``chi_spec``: optionally precomputed mean spectrum chi^2.
    """
    lp = log_prior_batch(p, tgt)
    ll = log_likelihood_batch(p, tgt, chi_spec=chi_spec)
    return jnp.where(jnp.isfinite(lp), lp + ll, -jnp.inf)


def optimizer_chi2_batch(p, tgt: PackedTarget, rad_sigma=None, chi_spec=None):
    """Batched ``fit_spec`` chi^2 (x3 spectrum weight + chi^2-convention priors).

    ``rad_sigma``: [nw, n_rad] step-size sigmas from the annealer (mft6.py:1042).
    ``chi_spec``: optionally precomputed mean spectrum chi^2 in the annealer's
    median-only convention (the spectral-sharded path computes it with psums
    and an exact distributed median — ``parallel.spec_shard``).
    """
    n = tgt.nspec
    teffs, av, r1, ratios, plx = _unpack_batch(p, tgt)
    # fit_spec scores the median-matched model vs RAW data (no continuum
    # renorm, mft6.py:1007-1014) with the x3 spectrum weight.  That scoring
    # has NO alpha^2 protection — a k-pass median error perturbs the
    # residual directly (measured std 0.40 / max 1.27 weighted-chi units at
    # k=16 over an equilibrated ensemble,
    # scripts/median_tempering_bound_cpu.py) — so stage 1 always scores
    # with the EXACT median regardless of the production dial; only the
    # emcee-stage (renorm) path, where the tempering bound applies, keeps
    # it.  Static meta swap: no runtime cost beyond the extra count rounds
    # of the count-median lane in a stage that is ~1 s total.
    if chi_spec is None and tgt.median_iters not in (0, 31):
        import dataclasses

        tgt = dataclasses.replace(tgt, median_iters=31)
    cs = chi2_total_batch(p, tgt, spec_mult=3.0, chi_spec=chi_spec, renorm=False)

    if tgt.fit_plx:
        dist_pc = 1.0 / jnp.maximum(plx, 1e-12)
        logd = jnp.log(jnp.maximum(dist_pc, 1e-3))
        w = tent_weights(tgt.av_logd_nodes, logd)
        mu = jnp.matmul(w, tgt.av_mu_nodes, precision=_HI)
        sig = jnp.matmul(w, tgt.av_sig_nodes, precision=_HI)
        cs += ((av - mu) / sig) ** 2
        if tgt.dist_fit:
            active = tgt.prior_mu[-1] != 0
            cs += jnp.where(active, ((plx - tgt.prior_mu[-1]) / tgt.prior_sig[-1]) ** 2, 0.0)

    if tgt.rad_prior:
        mrad = mist_radius_batch(tgt, teffs)
        m1 = mrad[:, 0]
        model_vals = jnp.concatenate([m1[:, None], mrad[:, 1:] / m1[:, None]], axis=1)
        rvals = jnp.concatenate([r1[:, None], ratios], axis=1) if tgt.fit_plx else ratios
        if not tgt.fit_plx:
            model_vals = model_vals[:, 1:]
        if rad_sigma is None:
            rad_sigma = 0.05 * rvals
        cs += jnp.sum(((rvals - model_vals) / rad_sigma) ** 2, axis=1)
    return cs
