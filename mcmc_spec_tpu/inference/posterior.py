"""Fused forward model, likelihood, priors, and posterior (all jit/vmap-safe).

Reproduces the reference's scoring semantics exactly (see file:line cites
inline), as a single traced computation per walker:

    p -> bilinear grid blends -> scales -> extinction -> continuum renorm
      -> chi^2(spectrum) * (n_contrast + n_phot)   [mft6.py:1178-1191]
      +  chi^2(contrasts) + chi^2(photometry)
      +  priors                                     [mft6.py:1207-1457]

Two weighting conventions are provided:

* :func:`log_posterior` — the emcee-stage convention (``loglikelihood`` with
  ``optimize=False`` + ``logprior``): returns ``-0.5*chi2 + logprior``.
* :func:`optimizer_chi2` — the stage-1 convention (``fit_spec``): spectrum
  chi^2 additionally weighted x3 (``mft6.py:893,1015``) and priors added as
  chi^2 penalties via ``opt_prior`` (``mft6.py:833-854``).

Parameter vector layouts (static per target):

* ``fit_plx`` (ndim = 2*nspec+2): ``[T_1..T_n, Av, R1, R2/R1(,R3/R1), plx]``
  (``mft6.py:1145-1158``) with plx in arcsec, distance = 1/plx pc.
* no-plx (ndim = nspec+2): ``[T_1..T_n, Av, R2/R1(,R3/R1)]`` — the radius-ratio
  mode (reference corner ndim==4 branch; its likelihood weighting follows
  ``mft6.py:1193-1195``).
"""
from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

from mcmc_spec_tpu.inference.target import PC_CM, RSUN_CM, PackedTarget
from mcmc_spec_tpu.models.mist import LSUN, RSUN, SIGMA_SB
from mcmc_spec_tpu.ops.continuum import continuum_renorm
from mcmc_spec_tpu.ops.interp import bilinear_bracket, bilinear_gather_blend, pwl_interp, tent_weights

# full-f32 contractions on a GPU, which may otherwise run them in TF32
_HI = jax.lax.Precision.HIGHEST


def mist_logg(tgt: PackedTarget, teff):
    """MIST 1-Gyr logg(Teff) lookup (reference ``get_logg``, mft6.py:87-98)."""
    return pwl_interp(tgt.mist_teff_nodes, tgt.mist_logg_nodes, teff)


def mist_radius(tgt: PackedTarget, teff):
    """MIST 1-Gyr radius(Teff) lookup (reference ``get_radius``, mft6.py:66-85):
    interpolate L(Teff), then Stefan-Boltzmann at the query Teff."""
    lum = pwl_interp(tgt.mist_teff_nodes, tgt.mist_lum_nodes, teff)
    return jnp.sqrt(lum * LSUN / (4.0 * jnp.pi * SIGMA_SB * teff**4)) / RSUN


def av_prior_mu_sig(tgt: PackedTarget, dist_pc):
    """Precomputed Bayestar LOS prior at a distance (replaces mft6.py:1233-1239)."""
    logd = jnp.log(jnp.maximum(dist_pc, 1e-3))
    w = tent_weights(tgt.av_logd_nodes, logd)
    return (jnp.matmul(w, tgt.av_mu_nodes, precision=_HI),
            jnp.matmul(w, tgt.av_sig_nodes, precision=_HI))


class ForwardOut(NamedTuple):
    model_data: jnp.ndarray  # [nd] composite on the data grid, unextincted
    contrasts: jnp.ndarray  # [nc]
    phot_mags: jnp.ndarray  # [npf] unextincted
    scales: jnp.ndarray  # [nspec]
    loggs: jnp.ndarray  # [nspec]


def _unpack(p, tgt: PackedTarget):
    n = tgt.nspec
    teffs = p[:n]
    av = p[n]
    if tgt.fit_plx:
        r1 = p[n + 1]
        ratios = p[n + 2 : 2 * n + 1]  # [n-1] radius ratios R_k/R_1
        plx = p[2 * n + 1]
    else:
        r1 = jnp.asarray(1.0, dtype=p.dtype)
        ratios = p[n + 1 : 2 * n]
        plx = jnp.asarray(0.0, dtype=p.dtype)
    return teffs, av, r1, ratios, plx


def _component_scales(tgt: PackedTarget, r1, ratios, plx):
    """Flux scale per component (mft6.py:689-703).

    With a distance: ``(R_k * RSUN / (d * PC))^2`` with ``d = 1/plx``;
    without: primary unscaled, companions ``(R_k/R_1)^2``.
    """
    if tgt.fit_plx:
        base = (r1 * RSUN_CM * plx / PC_CM) ** 2  # d = 1/plx  =>  1/d = plx
        comps = [base] + [base * ratios[k] ** 2 for k in range(tgt.nspec - 1)]
    else:
        one = jnp.asarray(1.0, dtype=ratios.dtype)
        comps = [one] + [ratios[k] ** 2 for k in range(tgt.nspec - 1)]
    return jnp.stack(comps)


def forward(p, tgt: PackedTarget) -> ForwardOut:
    """Composite spectrum on the data grid + contrasts + photometry.

    Equivalent to ``make_composite`` (mft6.py:651-831) composed with the
    model->data interp1d (mft6.py:1169-1170), via the precomputed projections.
    """
    teffs, av, r1, ratios, plx = _unpack(p, tgt)
    scales = _component_scales(tgt, r1, ratios, plx)

    loggs = mist_logg(tgt, teffs)  # [nspec]  (mft6.py:1149)

    ds, fcs, fps = [], [], []
    for k in range(tgt.nspec):
        ti, tw = bilinear_bracket(tgt.temps, teffs[k])
        gi, gw = bilinear_bracket(tgt.loggs, loggs[k])
        ds.append(bilinear_gather_blend(tgt.D, ti, tw, gi, gw))
        fcs.append(bilinear_gather_blend(tgt.Fc, ti, tw, gi, gw))
        fps.append(bilinear_gather_blend(tgt.Fp, ti, tw, gi, gw))
    ds = jnp.stack(ds)  # [nspec, nd]
    fcs = jnp.stack(fcs)  # [nspec, nc]
    fps = jnp.stack(fps)  # [nspec, npf]

    model_data = jnp.einsum("k,kd->d", scales, ds, precision=_HI)

    # contrast magnitudes (mft6.py:713-749): mag_k = -2.5 log10(flux_k);
    # binary: c = mag_2 - mag_1; triple: first half vs comp 2, rest vs comp 3.
    cflux = fcs * scales[:, None]  # [nspec, nc]
    mags = -2.5 * jnp.log10(jnp.maximum(cflux, 1e-300))
    if tgt.nspec == 1:
        contrasts = jnp.zeros((tgt.n_contrast,), dtype=p.dtype)
    elif tgt.nspec == 2:
        contrasts = mags[1] - mags[0]
    else:
        nc = tgt.n_contrast
        idx = jnp.arange(nc)
        c1 = mags[1] - mags[0]
        c2 = mags[2] - mags[0]
        contrasts = jnp.where(idx < nc // 2, c1, c2)

    # unresolved photometry (mft6.py:771-783): composite flux through each
    # photon-weighted filter over its zero flux.
    pflux = jnp.einsum("k,kf->f", scales, fps, precision=_HI)
    phot_mags = -2.5 * jnp.log10(jnp.maximum(pflux / tgt.phot_zp, 1e-300))

    return ForwardOut(model_data, contrasts, phot_mags, scales, loggs)


def _chi2_terms(p, tgt: PackedTarget, spec_mult, renorm=True):
    """(weighted spectrum chi2, contrast chi2, photometry chi2).

    Follows ``loglikelihood`` (mft6.py:1139-1205): extinction applied to the
    spectrum on the wavelength grid and to the photometry at filter central
    wavelengths (both exactly linear in Av via precomputed CCM89 slopes);
    model median-matched to the data; data renormalised by a deg-2 polynomial
    fit of data/model; spectrum chi2 reduced to its mean then weighted by
    ``spec_mult * (n_contrast + n_phot)`` (or ``* n_contrast`` without
    photometry).

    ``renorm=False`` reproduces the ANNEALER's scoring (``fit_spec``,
    mft6.py:1007-1014): median match only, chi2 against the RAW data — the
    deg-2 continuum renorm is an emcee-stage refinement the reference's
    stage 1 does not perform.
    """
    out = forward(p, tgt)
    n = tgt.nspec
    av = p[n]

    # extinct spectrum + photometry only when Av > 0 (mft6.py:1161-1166)
    apply_ext = av > 0
    trans = jnp.where(apply_ext, jnp.power(10.0, -0.4 * av * tgt.ext_k_data), 1.0)
    model = out.model_data * trans
    phot = jnp.where(apply_ext, out.phot_mags + av * tgt.ext_k_cwl, out.phot_mags)

    # median normalisation + polynomial renorm of the data (mft6.py:1172-1174)
    srt = jnp.sort(model)
    i0 = (tgt.n_data_true - 1) // 2
    i1 = tgt.n_data_true // 2
    med = 0.5 * (srt[i0] + srt[i1])
    model = model * (tgt.med_data / med)
    if renorm:
        data_renorm = continuum_renorm(tgt.data_flux, model, tgt.V, tgt.Vpinv)
    else:
        data_renorm = tgt.data_flux

    resid2 = ((model - data_renorm) / tgt.data_err) ** 2
    resid2 = jnp.where(jnp.isfinite(resid2), resid2, 0.0)
    chi_spec = jnp.sum(resid2) / tgt.n_data_true.astype(model.dtype)
    chi_c = jnp.sum(((out.contrasts - tgt.cmag) / tgt.cerr) ** 2)
    chi_p = jnp.sum(((phot - tgt.pmag) / tgt.perr) ** 2)

    nc_t = tgt.n_contrast_true.astype(chi_c.dtype)
    np_t = tgt.n_phot_true.astype(chi_c.dtype)
    if tgt.fit_plx:
        weight = spec_mult * (nc_t + np_t)
    else:
        weight = spec_mult * nc_t  # mft6.py:1193-1195
        chi_p = jnp.zeros_like(chi_p)
    chi_spec_w = tgt.spectrum_weight * weight * chi_spec
    return chi_spec_w, chi_c, chi_p


def chi2_total(p, tgt: PackedTarget, spec_mult=1.0, renorm=True):
    a, b, c = _chi2_terms(p, tgt, spec_mult, renorm=renorm)
    return a + b + c


def log_likelihood(p, tgt: PackedTarget):
    """``loglikelihood(optimize=False)``: -0.5*chi2, NaN -> -inf (mft6.py:1197-1205)."""
    cs = chi2_total(p, tgt, spec_mult=1.0)
    return jnp.where(jnp.isnan(cs), -jnp.inf, -0.5 * cs)


def _bounds_ok(p, tgt: PackedTarget):
    """Hard prior bounds (mft6.py:1227-1230, triple: 1347; nospec plx cap differs)."""
    n = tgt.nspec
    teffs, av, r1, ratios, plx = _unpack(p, tgt)
    ok = jnp.all(teffs <= tgt.tmax) & jnp.all(teffs >= tgt.tmin) & (av >= 0)
    ok &= jnp.all(ratios >= 0.05)
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


def log_prior(p, tgt: PackedTarget):
    """``logprior`` (mft6.py:1207-1457), branchless.

    Includes: hard bounds -> -inf; Bayestar Av(d) Gaussian; optional
    user Gaussian priors (nonzero ``prior_mu`` entries); optional MIST radius
    prior (sigma = 2% of the model value, mft6.py:1262-1269).
    """
    n = tgt.nspec
    teffs, av, r1, ratios, plx = _unpack(p, tgt)
    lp = jnp.asarray(0.0, dtype=p.dtype)

    if tgt.fit_plx:
        dist_pc = 1.0 / jnp.maximum(plx, 1e-12)
        mu, sig = av_prior_mu_sig(tgt, dist_pc)
        lp += -0.5 * ((av - mu) / sig) ** 2

    # user Gaussian priors on raw p entries (mft6.py:1241-1260)
    active = tgt.prior_mu != 0
    lp += jnp.sum(jnp.where(active, -0.5 * ((p - tgt.prior_mu) / tgt.prior_sig) ** 2, 0.0))

    if tgt.rad_prior:
        m1 = mist_radius(tgt, teffs[0])
        model_vals = [m1] + [mist_radius(tgt, teffs[k]) / m1 for k in range(1, n)]
        if tgt.fit_plx:
            rvals = jnp.concatenate([jnp.reshape(r1, (1,)), ratios])
        else:
            rvals = ratios
            model_vals = model_vals[1:]
        for rv, mv in zip(rvals, jnp.stack(model_vals)):
            lp += -0.5 * ((rv - mv) / (tgt.rad_sigma_frac * mv)) ** 2

    ok = _bounds_ok(p, tgt)
    return jnp.where(ok, lp, -jnp.inf)


def log_posterior(p, tgt: PackedTarget):
    """``logposterior`` (mft6.py:1459-1470): prior gate then likelihood."""
    lp = log_prior(p, tgt)
    # evaluate the likelihood unconditionally (branchless); gate via where
    ll = log_likelihood(p, tgt)
    return jnp.where(jnp.isfinite(lp), lp + ll, -jnp.inf)


def optimizer_chi2(p, tgt: PackedTarget, rad_sigma=None):
    """Stage-1 chi^2 (``fit_spec``): x3 spectrum weight + chi^2-style priors.

    ``rad_sigma`` is the radius-prior sigma vector; the reference uses the
    annealer's current *step sizes* there (mft6.py:1042,1050), not 2%% of the
    model — pass them in from the annealer.
    """
    n = tgt.nspec
    teffs, av, r1, ratios, plx = _unpack(p, tgt)
    # fit_spec scores median-matched model vs RAW data (no continuum renorm,
    # mft6.py:1007-1014) with the x3 spectrum weight (mft6.py:1015)
    cs = chi2_total(p, tgt, spec_mult=3.0, renorm=False)

    if tgt.fit_plx:
        dist_pc = 1.0 / jnp.maximum(plx, 1e-12)
        mu, sig = av_prior_mu_sig(tgt, dist_pc)
        cs += ((av - mu) / sig) ** 2  # opt_prior convention (mft6.py:929,1030)
        if tgt.dist_fit:
            # distance prior vs the measured parallax (mft6.py:1034-1035)
            active = tgt.prior_mu[-1] != 0
            cs += jnp.where(active, ((plx - tgt.prior_mu[-1]) / tgt.prior_sig[-1]) ** 2, 0.0)

    if tgt.rad_prior:
        m1 = mist_radius(tgt, teffs[0])
        model_vals = [m1] + [mist_radius(tgt, teffs[k]) / m1 for k in range(1, n)]
        rvals = jnp.concatenate([jnp.reshape(r1, (1,)), ratios]) if tgt.fit_plx else ratios
        if not tgt.fit_plx:
            model_vals = model_vals[1:]
        if rad_sigma is None:
            rad_sigma = 0.05 * rvals  # initial-guess convention (mft6.py:918)
        for i, mv in enumerate(jnp.stack(model_vals)):
            cs += ((rvals[i] - mv) / rad_sigma[i]) ** 2
    return cs


def forward_summary(p, tgt: PackedTarget):
    """Extincted model pieces for diagnostics/plots (host-friendly dict)."""
    out = forward(p, tgt)
    n = tgt.nspec
    av = p[n]
    apply_ext = av > 0
    trans = jnp.where(apply_ext, jnp.power(10.0, -0.4 * av * tgt.ext_k_data), 1.0)
    model = out.model_data * trans
    model = model * (tgt.med_data / jnp.median(model))
    phot = jnp.where(apply_ext, out.phot_mags + av * tgt.ext_k_cwl, out.phot_mags)
    return {
        "model_data": model,
        "contrasts": out.contrasts,
        "phot_mags": phot,
        "scales": out.scales,
        "loggs": out.loggs,
        "data_renorm": continuum_renorm(tgt.data_flux, model, tgt.V, tgt.Vpinv),
    }
