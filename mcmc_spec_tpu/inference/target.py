"""PackedTarget: everything one fit target needs, as device tensors.

The key design move of this framework.  In the reference, every
posterior evaluation re-discovers the model grid with ``glob``
(``mft6.py:399-436``), rebuilds ``interp1d`` objects (``mft6.py:1169``),
re-runs per-filter ``trapz`` integrals (``mft6.py:713-783``), and queries the
Bayestar dust map on host (``mft6.py:1233-1239``).  All of those are linear or
smooth in quantities that never change during a fit, so we precompute:

* ``D [nT, nG, nd]``  — the grid projected onto the *data* wavelength grid
  (exact: linear wavelength interpolation commutes with the bilinear (T, logg)
  blend, component scaling, and summation).
* ``Fc [nT, nG, nc]`` — per-gridpoint contrast-filter instrumental fluxes
  (the reference's ``trapz(spec*T)``, linear in the spectrum).
* ``Fp [nT, nG, npf]`` — per-gridpoint pyphot-convention photometric fluxes.
* ``ext_k_*``         — CCM89 ``A(lambda)/Av`` at data wavelengths and filter
  central wavelengths (CCM89 is exactly linear in Av).
* MIST ``logg(T)``/``radius(T)`` and Bayestar ``Av(d)`` on uniform lookup
  grids.

A log-posterior evaluation then costs a few 4-point gathers over tiny tensors
plus fused vector math over ~2k data points, for every walker of a batch at
once on the accelerator.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Optional, Sequence

import jax
import jax.numpy as jnp
import numpy as np

from mcmc_spec_tpu.models.dust import AvProfile
from mcmc_spec_tpu.models.grid import SpectralGrid
from mcmc_spec_tpu.models.mist import MistTable
from mcmc_spec_tpu.ops.continuum import polyfit_renorm_matrix
from mcmc_spec_tpu.ops.extinction import ccm89
from mcmc_spec_tpu.ops.interp import interp1d_weights
from mcmc_spec_tpu.ops.photometry import (
    FilterCurve,
    contrast_weights,
    photon_flux_weights,
)

RSUN_CM = 6.957e10  # mft6.py:691
PC_CM = 3.086e18  # mft6.py:691


@dataclasses.dataclass
class PackedTarget:
    """Device-resident fit target (registered as a JAX pytree).

    Static (hashable) configuration lives in meta fields so the object can be
    passed straight through ``jit``/``vmap``/``shard_map``.
    """

    # --- static config
    nspec: int
    dist_fit: bool
    rad_prior: bool
    fit_plx: bool  # p0 carries a parallax entry (ndim = 2*nspec+2)
    spectrum_weight: float  # 1.0 reference, 0.0 reproduces mft6_nospec.py

    # --- grid axes
    temps: Any  # [nT]
    loggs: Any  # [nG]

    # --- spectrum block
    D: Any  # [nT, nG, nd] grid on the data wavelength grid
    data_flux: Any  # [nd] (masked, windowed, median-normalised)
    data_err: Any  # [nd]
    ext_k_data: Any  # [nd] CCM89 A/Av at data wavelengths
    V: Any  # [nd, 3] scaled-domain Vandermonde (continuum renorm)
    Vpinv: Any  # [3, nd]

    # --- contrast block
    Fc: Any  # [nT, nG, nc]
    cmag: Any  # [nc]
    cerr: Any  # [nc]

    # --- photometry block
    Fp: Any  # [nT, nG, npf]
    phot_zp: Any  # [npf] zero fluxes
    ext_k_cwl: Any  # [npf] CCM89 A/Av at filter central wavelengths
    pmag: Any  # [npf]
    perr: Any  # [npf]

    # --- lookup tables (original interpolation nodes; tent-basis interp on
    # device is gather-free and matches host np.interp exactly)
    mist_teff_nodes: Any  # [nm]
    mist_logg_nodes: Any  # [nm]
    mist_lum_nodes: Any  # [nm]
    av_logd_nodes: Any  # [nav]
    av_mu_nodes: Any  # [nav]
    av_sig_nodes: Any  # [nav]

    # --- prior scalars
    tmin: Any
    tmax: Any
    prior_mu: Any  # [ndim] gaussian prior means (0 = disabled), mft6.py:1241-1260
    prior_sig: Any  # [ndim]

    # --- padding-aware statistics (fleet mode pads nd/nc to common shapes;
    # the *_true counts and the data median always refer to the real points)
    med_data: Any  # scalar median of the unpadded data flux
    n_data_true: Any  # scalar int
    n_contrast_true: Any  # scalar int
    n_phot_true: Any  # scalar int

    # --- fast-median pass count, resolved ONCE at pack time from
    # ``MCMC_SPEC_FAST_MEDIAN`` (utils.flags.median_iters) and threaded to
    # the count-median lane as a static argument (31 = exact; 0 = unset,
    # which the lane also treats as exact)
    median_iters: int = 0

    # fractional sigma of the MIST radius prior (mft6.py:1268 uses 0.02
    # against the genuine isochrone; the builtin substitute table widens it —
    # see MistTable.rad_prior_sigma_frac)
    rad_sigma_frac: float = 0.02

    @property
    def ndim(self) -> int:
        # fit_plx: [T_1..n, Av, R1, ratios(n-1), plx]; else [T_1..n, Av, ratios(n-1)]
        return 2 * self.nspec + 2 if self.fit_plx else 2 * self.nspec

    @property
    def n_contrast(self) -> int:
        return self.cmag.shape[-1]

    @property
    def n_phot(self) -> int:
        return self.pmag.shape[-1]

    @property
    def n_data(self) -> int:
        return self.data_flux.shape[-1]


jax.tree_util.register_dataclass(
    PackedTarget,
    data_fields=[
        "temps", "loggs", "D", "data_flux", "data_err", "ext_k_data", "V", "Vpinv",
        "Fc", "cmag", "cerr", "Fp", "phot_zp", "ext_k_cwl", "pmag", "perr",
        "mist_teff_nodes", "mist_logg_nodes", "mist_lum_nodes",
        "av_logd_nodes", "av_mu_nodes", "av_sig_nodes",
        "tmin", "tmax", "prior_mu", "prior_sig",
        "med_data", "n_data_true", "n_contrast_true", "n_phot_true",
    ],
    meta_fields=["nspec", "dist_fit", "rad_prior", "fit_plx", "spectrum_weight",
                 "median_iters", "rad_sigma_frac"],
)


def pad_nd_arrays(D, data_flux, data_err, ext_k_data, V, Vpinv, extra: int):
    """Inert sentinel padding of the data-wavelength axis (host numpy).

    The single sentinel scheme behind pack-time ``pad_nd`` and post-pack
    ``parallel.spec_shard.pad_packed_target_nd``: padded points carry
    ``err=inf`` / zero data / zero ``Vpinv`` columns / ``V`` rows [1,0,0] /
    model sentinel 1e30, so medians (rank-based over real points), the
    renorm fit (padded rows contribute nothing; padded ``data_renorm`` is
    0/c0 = 0), and the residual sum (0/inf = 0) are unchanged.  Pads are
    built in each array's own dtype — pure numpy: staging a padded
    full-size D on one device would defeat spectral sharding's
    larger-than-HBM purpose.
    """
    nT, nG, _ = D.shape
    D = np.concatenate([D, np.full((nT, nG, extra), 1e30, dtype=D.dtype)], axis=2)
    data_flux = np.concatenate([data_flux, np.zeros(extra, dtype=data_flux.dtype)])
    data_err = np.concatenate(
        [data_err, np.full(extra, np.inf, dtype=data_err.dtype)])
    ext_k_data = np.concatenate(
        [ext_k_data, np.zeros(extra, dtype=ext_k_data.dtype)])
    V = np.concatenate(
        [V, np.tile(np.asarray([[1.0, 0.0, 0.0]], dtype=V.dtype), (extra, 1))],
        axis=0)
    Vpinv = np.concatenate([Vpinv, np.zeros((3, extra), dtype=Vpinv.dtype)], axis=1)
    return D, data_flux, data_err, ext_k_data, V, Vpinv


def pack_target(
    grid: SpectralGrid,
    data_wl_um: np.ndarray,
    data_flux: np.ndarray,
    data_err: np.ndarray,
    contrast_filters: Sequence[FilterCurve],
    cmag: Sequence[float],
    cerr: Sequence[float],
    phot_filters: Sequence[FilterCurve],
    phot_zero_flux: Sequence[float],
    pmag: Sequence[float],
    perr: Sequence[float],
    mist: MistTable,
    av_profile: AvProfile,
    nspec: int = 2,
    dist_fit: bool = True,
    rad_prior: bool = False,
    fit_plx: bool = True,
    spectrum_weight: float = 1.0,
    prior_mu: Optional[np.ndarray] = None,
    prior_sig: Optional[np.ndarray] = None,
    dtype=jnp.float32,
    pad_nd: Optional[int] = None,
    pad_nc: Optional[int] = None,
    rad_sigma_frac: Optional[float] = None,
    stage_on_device: bool = True,
) -> PackedTarget:
    """Precompute every linear projection and lookup table for one target.

    ``data_*`` must already be masked/windowed/median-normalised (io layer).
    ``phot_zero_flux`` pairs with ``phot_filters`` (AB or Vega zero flux per
    filter, see :mod:`mcmc_spec_tpu.io.filters`).

    ``pad_nd``/``pad_nc`` pad the data/contrast axes to common fleet shapes:
    padded data points carry infinite error + zero renorm weight and a large
    sentinel model flux (so rank-based medians ignore them); padded contrast
    filters carry unit flux and infinite error.

    ``stage_on_device=False`` keeps every data field as HOST numpy (cast to
    ``dtype``): the spectral-sharding (WxS) path must pass this, so that
    ``parallel.spec_shard.shard_target_over_spec`` performs the ONLY device
    placement and each chip receives just its wavelength shard of ``D`` —
    the default ``jnp.asarray`` staging would commit the full ``[nT,nG,nd]``
    grid projection to one device first, which defeats sharding's
    larger-than-HBM purpose (it OOMs at pack time before the sharded path
    ever runs).  Host targets still work everywhere else (jnp auto-uploads
    on first use), but per-eval re-upload makes them wrong for the
    single-device hot paths — only the sharded pipeline should request this.
    """
    data_wl_aa = np.asarray(data_wl_um, dtype=np.float64) * 1e4

    # grid -> data-wavelength projection (exact piecewise-linear interp)
    idx, w = interp1d_weights(grid.wl, data_wl_aa)
    D = grid.flux[:, :, idx] * (1.0 - w) + grid.flux[:, :, idx + 1] * w

    # per-gridpoint filter fluxes
    nT, nG, _ = grid.flux.shape
    flat = grid.flux.reshape(nT * nG, -1)
    Fc_cols = []
    for fc in contrast_filters:
        Wc = contrast_weights(grid.wl, fc.wl, fc.tr)
        Fc_cols.append(flat @ Wc)
    Fc = np.stack(Fc_cols, axis=-1).reshape(nT, nG, -1) if Fc_cols else np.zeros((nT, nG, 0))

    Fp_cols, cwls = [], []
    for fp in phot_filters:
        Wp, _ = photon_flux_weights(grid.wl, fp.wl, fp.tr)
        Fp_cols.append(flat @ Wp)
        cwls.append(fp.cwl)
    Fp = np.stack(Fp_cols, axis=-1).reshape(nT, nG, -1) if Fp_cols else np.zeros((nT, nG, 0))

    V, Vpinv = polyfit_renorm_matrix(data_wl_aa, deg=2)

    mist_teff, mist_logg, mist_lum = mist.device_nodes(dtype)
    av_logd, av_mu, av_sig = av_profile.device_nodes(dtype)

    ndim = 2 * nspec + 2 if fit_plx else 2 * nspec
    if prior_mu is None:
        prior_mu = np.zeros(ndim)
    if prior_sig is None:
        prior_sig = np.ones(ndim)

    n_data_true = len(np.asarray(data_flux))
    n_contrast_true = len(contrast_filters)
    n_phot_true = len(phot_filters)
    med_data = float(np.median(np.asarray(data_flux)))
    data_flux = np.asarray(data_flux, dtype=np.float64)
    data_err = np.asarray(data_err, dtype=np.float64)
    ext_k_data = np.asarray(ccm89(data_wl_aa, 1.0), dtype=np.float64)
    cmag = np.asarray(cmag, dtype=np.float64)
    cerr = np.asarray(cerr, dtype=np.float64)

    if pad_nd is not None and pad_nd > n_data_true:
        D, data_flux, data_err, ext_k_data, V, Vpinv = pad_nd_arrays(
            D, data_flux, data_err, ext_k_data, V, Vpinv, pad_nd - n_data_true
        )
    if pad_nc is not None and pad_nc > n_contrast_true:
        extra = pad_nc - n_contrast_true
        Fc = np.concatenate([Fc, np.ones((nT, nG, extra))], axis=2)
        cmag = np.concatenate([cmag, np.zeros(extra)])
        cerr = np.concatenate([cerr, np.full(extra, np.inf)])

    from mcmc_spec_tpu.utils import flags

    if stage_on_device:
        as_dev = lambda x: jnp.asarray(np.asarray(x), dtype=dtype)
        as_int = lambda x: jnp.asarray(x, jnp.int32)
    else:
        np_dtype = np.dtype(dtype)
        as_dev = lambda x: np.asarray(np.asarray(x), dtype=np_dtype)
        as_int = lambda x: np.asarray(x, np.int32)
        # lookup-table nodes come back from device_nodes() as jnp arrays;
        # mirror them to host so no field of the returned target holds a
        # device buffer
        mist_teff, mist_logg, mist_lum = (
            np.asarray(a) for a in (mist_teff, mist_logg, mist_lum))
        av_logd, av_mu, av_sig = (np.asarray(a) for a in (av_logd, av_mu, av_sig))
    return PackedTarget(
        nspec=int(nspec),
        dist_fit=bool(dist_fit),
        rad_prior=bool(rad_prior),
        fit_plx=bool(fit_plx),
        spectrum_weight=float(spectrum_weight),
        median_iters=flags.median_iters(),
        # default 0.02 = the reference's exact width (tests/parity); the
        # production pipeline passes MistTable.rad_prior_sigma_frac, which
        # widens it when only the builtin substitute table is available
        rad_sigma_frac=float(rad_sigma_frac) if rad_sigma_frac is not None else 0.02,
        temps=as_dev(grid.temps),
        loggs=as_dev(grid.loggs),
        D=as_dev(D),
        data_flux=as_dev(data_flux),
        data_err=as_dev(data_err),
        ext_k_data=as_dev(ext_k_data),
        V=as_dev(V),
        Vpinv=as_dev(Vpinv),
        Fc=as_dev(Fc),
        cmag=as_dev(cmag),
        cerr=as_dev(cerr),
        Fp=as_dev(Fp),
        phot_zp=as_dev(phot_zero_flux),
        ext_k_cwl=as_dev(np.asarray(ccm89(np.asarray(cwls, dtype=np.float64), 1.0)))
        if cwls
        else as_dev(np.zeros(0)),
        pmag=as_dev(pmag),
        perr=as_dev(perr),
        mist_teff_nodes=mist_teff,
        mist_logg_nodes=mist_logg,
        mist_lum_nodes=mist_lum,
        av_logd_nodes=av_logd,
        av_mu_nodes=av_mu,
        av_sig_nodes=av_sig,
        tmin=as_dev(float(grid.temps.min())),
        tmax=as_dev(float(grid.temps.max())),
        prior_mu=as_dev(prior_mu),
        prior_sig=as_dev(prior_sig),
        med_data=as_dev(med_data),
        n_data_true=as_int(n_data_true),
        n_contrast_true=as_int(n_contrast_true),
        n_phot_true=as_int(n_phot_true),
    )
