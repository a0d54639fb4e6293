#!/usr/bin/env python
"""End-to-end BT-Settl-scale bench: grid load -> pack -> sample on the GPU.

The headline bench uses a prebuilt synthetic target; this benchmark walks the FULL production startup path at real grid scale —
write a 56-file BT-Settl-format directory (135k rows each, the reference's
0.2 A common grid over 3000-30000 A), load it through
``SpectralGrid.from_btsettl_dir`` (native C++ windowed reader + instrumental
broadening inside the data window, mft6.py:255-385 semantics), ``pack_target``,
then run a koi2298-shaped chain — and reports each stage's wall clock.

Usage: python benchmarks/bench_e2e_grid.py [--keep DIR]
"""
import json
import os
import shutil
import sys
import tempfile
import time

import numpy as np

sys.path.insert(0, ".")

import jax
import jax.numpy as jnp

from mcmc_spec_tpu.bench_target import _gaussian_filter
from mcmc_spec_tpu.inference.stretch import init_ensemble, run_ensemble
from mcmc_spec_tpu.inference.batched import log_posterior_batch
from mcmc_spec_tpu.inference.target import PC_CM, RSUN_CM, pack_target
from mcmc_spec_tpu.models.dust import AvProfile
from mcmc_spec_tpu.models.grid import SpectralGrid
from mcmc_spec_tpu.models.mist import MistTable
from mcmc_spec_tpu.ops.photometry import ab_zero_flux, photon_flux_weights

TEMPS = np.arange(3000.0, 5601.0, 200.0)  # 14
LOGGS = np.array([4.0, 4.5, 5.0, 5.5])  # 4
SPECRANGE = (3000.0, 26000.0)
WINDOW = (6450.0, 8400.0)


def write_btsettl_dir(dirname):
    """56 files in the BT-Settl ASCII layout at the real row count."""
    wl = np.arange(2800.0, 30000.0, 0.2)  # 136k rows
    rng = np.random.RandomState(0)
    for t in TEMPS:
        for g in LOGGS:
            # smooth Planck-ish continuum + pseudo absorption lines, positive
            x = wl * 1e-4
            cont = (x ** -4) * np.exp(-1.44e4 / (x * t)) * 1e6
            lines = 1.0 - 0.3 * np.abs(np.sin(wl / (2.0 + g)))
            flux = cont * lines * (1 + 0.01 * rng.rand(len(wl)))
            name = f"lte{t/100:.0f}-{g:.1f}-0.0a+0.0.BT-Settl.spec.7.txt"
            np.savetxt(os.path.join(dirname, name),
                       np.column_stack([wl, flux]), fmt="%.4f %.6e")


def main():
    keep = None
    if "--keep" in sys.argv:
        keep = sys.argv[sys.argv.index("--keep") + 1]
    tmp = keep or tempfile.mkdtemp(prefix="btsettl_bench_")
    os.makedirs(tmp, exist_ok=True)

    if not any(f.startswith("lte") for f in os.listdir(tmp)):
        t0 = time.perf_counter()
        write_btsettl_dir(tmp)
        print(f"[gen] wrote 56x136k-row BT-Settl files in "
              f"{time.perf_counter()-t0:.1f}s", file=sys.stderr)

    t0 = time.perf_counter()
    grid = SpectralGrid.from_btsettl_dir(
        tmp, trange=(min(TEMPS), max(TEMPS)), lgrange=(4.0, 5.5),
        specrange=SPECRANGE, data_window=WINDOW, resolution=1700,
    )
    t_load = time.perf_counter() - t0

    # observed data: composite at a truth vector on a HET-like grid
    mist = MistTable.builtin()
    truth = np.array([4600.0, 3400.0, 0.12, 0.72, 0.45, 2.0e-3])
    data_wl_um = np.linspace(0.652, 0.838, 1792)
    d_pc = 1.0 / truth[-1]
    comp = np.zeros(len(grid.wl))
    for k, (tk, rk) in enumerate([(truth[0], truth[3]),
                                  (truth[1], truth[3] * truth[4])]):
        scale = (rk * RSUN_CM / (d_pc * PC_CM)) ** 2
        comp += scale * grid.interp_spectrum(tk, float(mist.get_logg(tk)))
    rng = np.random.RandomState(1)
    flux = np.interp(data_wl_um * 1e4, grid.wl, comp)
    err = 0.01 * np.abs(flux)
    flux = flux + rng.normal(0, err)
    med = np.median(flux)
    flux, err = flux / med, err / med

    cfilts = [_gaussian_filter("lp600ish", 6000.0, 150.0),
              _gaussian_filter("Kpish", 21000.0, 400.0)]
    pfilts = [_gaussian_filter(n, c, w) for n, c, w in [
        ("r", 6250.0, 300.0), ("i", 7700.0, 350.0), ("z", 9100.0, 400.0),
        ("J", 12350.0, 500.0), ("H", 16620.0, 600.0), ("K", 21590.0, 700.0)]]
    zps = [ab_zero_flux(photon_flux_weights(f.wl, f.wl, f.tr)[1]) for f in pfilts]

    t0 = time.perf_counter()
    tgt = pack_target(
        grid, data_wl_um, flux, err,
        cfilts, np.array([2.0, 1.3]), np.full(2, 0.05), pfilts, zps,
        pmag=np.zeros(6), perr=np.full(6, 0.05),
        mist=mist, av_profile=AvProfile.constant(0.12, 0.05),
        nspec=2, dist_fit=True,
        prior_mu=np.array([0, 0, 0, 0, 0, truth[-1]]),
        prior_sig=np.array([1, 1, 1, 1, 1, 0.05e-3]),
        dtype=jnp.float32,
    )
    t_pack = time.perf_counter() - t0

    # observations from the packed forward at truth (synthetic-benchmark
    # bookkeeping, NOT a production stage: real runs read cmag/pmag from the
    # param file; the scalar-forward jit compile lands here, outside t_pack)
    import dataclasses

    from mcmc_spec_tpu.inference.posterior import forward

    out = forward(jnp.asarray(truth, jnp.float32), tgt)
    tgt = dataclasses.replace(
        tgt, cmag=out.contrasts, pmag=out.phot_mags)

    # koi2298-shaped chain: 50 walkers x (301 + 15,001) steps
    scale = jnp.asarray([50.0, 50.0, 0.02, 0.02, 0.02, 0.02e-3], jnp.float32)
    p0 = jnp.asarray(truth, jnp.float32) + scale * jax.random.normal(
        jax.random.PRNGKey(2), (50, 6), jnp.float32)
    logp = lambda b: log_posterior_batch(b, tgt)
    state = init_ensemble(p0, logp, jax.random.PRNGKey(3))
    st, chain, _ = run_ensemble(state, logp, n_steps=301, thin=301)  # compile+burn
    chain.block_until_ready()
    t0 = time.perf_counter()
    st, chain, _ = run_ensemble(st, logp, n_steps=15001, thin=100)
    chain.block_until_ready()
    t_chain = time.perf_counter() - t0

    med_t1 = float(jnp.median(chain[-50:, :, 0]))
    ok = bool(abs(med_t1 - truth[0]) < 200.0)
    print(json.dumps({
        "metric": "e2e_btsettl_chain_wall_clock",
        "value": round(t_load + t_pack + t_chain, 3),
        "unit": "s (56-file BT-Settl load + pack + 15k-step chain)",
        "load_s": round(t_load, 3),
        "pack_s": round(t_pack, 3),
        "chain_s": round(t_chain, 3),
        "t1_recovered": ok,
    }))
    if keep is None:
        shutil.rmtree(tmp)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
