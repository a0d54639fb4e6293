"""Self-contained benchmark target: koi2298-scale workload, no external data.

Mirrors the shape of benchmark config 2 in BASELINE.md: a binary fit with
~1.8k data wavelengths (HET/LRS2-like), 2 contrast filters, 6 photometric
filters, a 14x4 (Teff, logg) grid — the same tensor shapes the real koi2298
fit produces, built from the synthetic model family so it runs anywhere.

``write_filter_dir`` and ``write_fit_inputs`` write the same workload as
files the CLI reads (a filter-curve directory in the reference's formats, a
data spectrum and a param file), so the end-to-end path needs no external
data either.
"""
from __future__ import annotations

import os

import numpy as np

from mcmc_spec_tpu.inference.target import PC_CM, RSUN_CM, pack_target
from mcmc_spec_tpu.models.dust import AvProfile
from mcmc_spec_tpu.models.mist import MistTable
from mcmc_spec_tpu.models.synthetic import synthetic_grid
from mcmc_spec_tpu.ops.photometry import FilterCurve, ab_zero_flux, photon_flux_weights

TRUTH = np.array([4600.0, 3400.0, 0.12, 0.72, 0.45, 2.0e-3])

# Gaussian stand-ins for the koi2298 filter set: (centre, width) in Angstrom
FILTERS = {
    "lp600": (6000.0, 150.0), "Kp": (21000.0, 400.0),
    "sdss,r": (6250.0, 300.0), "sdss,i": (7700.0, 350.0), "sdss,z": (9100.0, 400.0),
    "2mass,j": (12350.0, 500.0), "2mass,h": (16620.0, 600.0), "2mass,ks": (21590.0, 700.0),
    # read by the report (Kepler and Gaia G contrasts)
    "kepler": (6400.0, 1100.0), "gaia,g": (6730.0, 1400.0),
}
CFILT = ["lp600", "Kp"]
PFILT = ["sdss,r", "sdss,i", "sdss,z", "j", "h", "k"]


def _gaussian_filter(name, center, width, n=256):
    wl = np.linspace(center - 4 * width, center + 4 * width, n)
    return FilterCurve(name=name, wl=wl, tr=np.exp(-0.5 * ((wl - center) / width) ** 2))


def filter_curve(key: str) -> FilterCurve:
    """The Gaussian stand-in for filter ``key`` of :data:`FILTERS`."""
    return _gaussian_filter(key, *FILTERS[key])


def build_bench_target(dtype, nd=1792, grid_step=1.0, nspec=2, seed=0,
                       pad_nd=None, pad_nc=None, stage_on_device=True):
    """(PackedTarget, truth params). Deterministic.

    ``pad_nd``/``pad_nc`` thread through to ``pack_target`` (inert fleet
    padding) so on-device checks can build padded fleet members without
    the test fixtures (chip_smoke.py).
    ``stage_on_device=False`` returns a host-numpy target (the WxS staging
    mode; observed cmag/pmag are mirrored back to host too)."""
    import jax.numpy as jnp  # noqa: F401

    rng = np.random.RandomState(seed)
    specrange = (3000.0, 26000.0)
    window = (6450.0, 8400.0)
    grid = synthetic_grid(
        specrange=specrange,
        data_window=window,
        resolution=1700,
        temps=np.arange(3000.0, 5601.0, 200.0),
        loggs=np.array([4.0, 4.5, 5.0, 5.5]),
        step=grid_step,
    )
    mist = MistTable.builtin()

    data_wl_um = np.linspace(0.652, 0.838, nd)
    p = TRUTH.copy()
    if nspec == 3:
        p = np.array([4600.0, 3800.0, 3300.0, 0.12, 0.72, 0.55, 0.3, 2.0e-3])

    # composite at truth on the data grid
    d_pc = 1.0 / p[-1]
    teffs = p[:nspec]
    r1 = p[nspec + 1]
    ratios = np.concatenate([[1.0], p[nspec + 2 : 2 * nspec + 1]])
    comp = np.zeros(len(grid.wl))
    for k in range(nspec):
        scale = (r1 * ratios[k] * RSUN_CM / (d_pc * PC_CM)) ** 2
        comp += scale * grid.interp_spectrum(teffs[k], float(mist.get_logg(teffs[k])))
    flux = np.interp(data_wl_um * 1e4, grid.wl, comp)
    err = 0.01 * np.abs(flux)
    flux = flux + rng.normal(0, err)
    med = np.median(flux)
    flux, err = flux / med, err / med

    cfilts = [filter_curve(k) for k in CFILT]
    pfilts = [filter_curve(k) for k in ("sdss,r", "sdss,i", "sdss,z",
                                        "2mass,j", "2mass,h", "2mass,ks")]
    zps = []
    for f in pfilts:
        _, lp = photon_flux_weights(f.wl, f.wl, f.tr)
        zps.append(ab_zero_flux(lp))

    ndim = 2 * nspec + 2
    prior_mu = np.zeros(ndim)
    prior_sig = np.ones(ndim)
    prior_mu[-1] = p[-1]
    prior_sig[-1] = 0.05e-3

    tgt = pack_target(
        grid, data_wl_um, flux, err,
        cfilts, np.array([2.0, 1.3][: len(cfilts)]), np.full(len(cfilts), 0.05),
        pfilts, zps,
        # placeholder observations; replaced below with model-at-truth + noise
        pmag=np.zeros(len(pfilts)), perr=np.full(len(pfilts), 0.05),
        mist=mist, av_profile=AvProfile.constant(0.12, 0.05),
        nspec=nspec, dist_fit=True, rad_prior=False,
        prior_mu=prior_mu, prior_sig=prior_sig, dtype=dtype,
        pad_nd=pad_nd, pad_nc=pad_nc, stage_on_device=stage_on_device,
    )
    # fill observed contrasts/photometry from the packed forward at truth
    import jax
    import jax.numpy as jnp
    from mcmc_spec_tpu.inference.posterior import forward

    out = forward(jnp.asarray(p, dtype=dtype), tgt)
    import dataclasses

    # noise draws are sized by the TRUE filter counts (not the padded
    # forward-output shapes) so a pad_nc/pad_nd build consumes the same RNG
    # stream as its unpadded twin — padding-inertness comparisons on these
    # fixtures must see identical true observations, not an RNG shift
    cnoise = np.zeros(out.contrasts.shape[-1])
    cnoise[: len(cfilts)] = rng.normal(0, 0.02, len(cfilts))
    cmag = out.contrasts + jnp.asarray(cnoise, dtype=dtype)
    pmag = out.phot_mags + jnp.asarray(rng.normal(0, 0.02, len(pfilts)), dtype=dtype)
    if not stage_on_device:
        cmag, pmag = np.asarray(cmag), np.asarray(pmag)
    tgt = dataclasses.replace(tgt, cmag=cmag, pmag=pmag)
    return tgt, p


def init_walker_batch(tgt, truth, nwalk, dtype, seed=1):
    """Truth-centred walker cloud for benchmarking/sampling."""
    import jax

    key = jax.random.PRNGKey(seed)
    import jax.numpy as jnp

    scale = jnp.asarray(
        np.concatenate([np.full(tgt.nspec, 50.0), [0.02],
                        np.full(tgt.nspec, 0.02), [0.02e-3]]), dtype=dtype
    )
    noise = jax.random.normal(key, (nwalk, len(truth)), dtype=dtype)
    return jnp.asarray(truth, dtype=dtype) + noise * scale


def write_filter_dir(path: str) -> str:
    """Write the :data:`FILTERS` curves as a ``bps/`` directory.

    One file per filter in the format ``io.filters.load_transmission``
    reads for it: ``lp600.csv`` (nm, comma-separated), ``keck_kp.txt``
    (micron), ``gaia_g_pb.txt`` (nm), ``SLOAN_SDSS.{r,i,z}prime_filter.dat``,
    ``2MASS_2MASS.Ks.dat`` and ``Kepler_Kepler.K.dat`` (Angstrom columns),
    and ``2mass_{j,h}_001_syn.fits`` (FITS BINTABLEs).  Returns ``path``.
    """
    from mcmc_spec_tpu.io.fits import write_bintable

    os.makedirs(path, exist_ok=True)
    out = lambda name: os.path.join(path, name)
    cols = lambda c, scale=1.0: np.column_stack([c.wl * scale, c.tr])
    np.savetxt(out("lp600.csv"), cols(filter_curve("lp600"), 0.1), delimiter=",")
    np.savetxt(out("keck_kp.txt"), cols(filter_curve("Kp"), 1e-4))
    for b in "riz":
        np.savetxt(out(f"SLOAN_SDSS.{b}prime_filter.dat"), cols(filter_curve(f"sdss,{b}")))
    for b in "jh":
        c = filter_curve(f"2mass,{b}")
        write_bintable(out(f"2mass_{b}_001_syn.fits"),
                       {"WAVELENGTH": c.wl, "THROUGHPUT": c.tr})
    np.savetxt(out("2MASS_2MASS.Ks.dat"), cols(filter_curve("2mass,ks")))
    np.savetxt(out("Kepler_Kepler.K.dat"), cols(filter_curve("kepler")))
    np.savetxt(out("gaia_g_pb.txt"), cols(filter_curve("gaia,g"), 0.1))
    return path


def _param_text(dirname, datafile, bps_dir, cmag, pmag, nwalk, nstep, nburn,
                nsteps, seed):
    fmt = lambda xs: ",".join(f"{x:.6f}" for x in xs)
    names = lambda xs: "[" + ",".join(f"'{x}'" for x in xs) + "]"
    return f"""### synthetic koi2298-shaped binary fit
models synthetic
dirname {dirname}
fname synth
res 1700
tmin 3000
tmax 5600
specmin 3000
specmax 30000
mask True
rad_prior False
filename {datafile}
spmin 0.645
spmax 0.84
cmag [{fmt(cmag)}]
cerr [0.05,0.05]
cfilt {names(CFILT)}
pmag [{fmt(pmag)}]
perr [0.05,0.05,0.05,0.05,0.05,0.05]
pfilt {names(PFILT)}
plx {TRUTH[5]}
plx_err 0.05e-3
dist_fit True
av {TRUTH[2]}
av_err 0.01
ra 288.456118
dec 45.802226
nwalk {nwalk}
nstep {nstep}
nspec 2
ndust 0
nburn {nburn}
nsteps {nsteps}
seed {seed}
real_values [{fmt(TRUTH)}]
bps_dir {bps_dir}
"""


def write_fit_inputs(path: str, nwalk: int = 150, nstep: int = 400,
                     nburn: int = 301, nsteps: int = 15001, nd: int = 1792,
                     seed: int = 0) -> str:
    """Write a synthetic koi2298-shaped binary fit under ``path``.

    A filter directory (:func:`write_filter_dir`), a data spectrum of the
    composite at :data:`TRUTH` with 1% noise at ``nd`` wavelengths that the
    telluric mask keeps, and a param file whose contrasts and
    photometry are the packed forward model at truth.  Results go to
    ``path/run``; the grid cache goes to the current directory.  Returns
    the param file's path (its name contains ``synth``, so the pipeline
    skips the KIC->SDSS recalibration).
    """
    import jax.numpy as jnp

    from mcmc_spec_tpu.inference.posterior import forward_summary
    from mcmc_spec_tpu.io.spectra import apply_telluric_mask
    from mcmc_spec_tpu.ops.extinction import ccm89
    from mcmc_spec_tpu.pipeline import setup_context
    from mcmc_spec_tpu.report.composite import composite_full
    from mcmc_spec_tpu.utils.config import FitConfig

    bps = write_filter_dir(os.path.join(path, "bps"))
    # the telluric mask removes points: sample nd of the kept ones
    wl_um = np.linspace(0.652, 0.838, 2 * nd)
    wl_um = wl_um[apply_telluric_mask(wl_um)]
    wl_um = wl_um[np.round(np.linspace(0, len(wl_um) - 1, nd)).astype(int)]
    datafile = os.path.join(path, "synth_obs.txt")
    np.savetxt(datafile, np.column_stack([wl_um, np.ones_like(wl_um),
                                          0.01 * np.ones_like(wl_um)]))
    paramfile = os.path.join(path, "param_synth.txt")
    args = (os.path.join(path, "run"), datafile, bps)
    counts = (nwalk, nstep, nburn, nsteps, seed)
    with open(paramfile, "w") as f:
        f.write(_param_text(*args, [1.0, 1.0], [14.0] * 6, *counts))
    ctx = setup_context(FitConfig.from_file(paramfile), dtype=jnp.float32)
    if ctx.target.n_data != nd:
        raise RuntimeError(f"masked window holds {ctx.target.n_data} points, not {nd}")

    rng = np.random.RandomState(seed)
    w, comp, _ = composite_full(ctx.grid, ctx.mist, TRUTH, 2)
    comp = comp * 10 ** (-0.4 * np.asarray(ccm89(w, TRUTH[2])))
    flux = np.interp(wl_um * 1e4, w, comp)
    err = 0.01 * flux
    np.savetxt(datafile, np.column_stack([wl_um, flux + rng.normal(0, err), err]))
    summ = forward_summary(jnp.asarray(TRUTH, jnp.float32), ctx.target)
    with open(paramfile, "w") as f:
        f.write(_param_text(*args, np.asarray(summ["contrasts"]),
                            np.asarray(summ["phot_mags"]), *counts))
    return paramfile
