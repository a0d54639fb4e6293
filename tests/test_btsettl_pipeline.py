"""Pipeline over a BT-Settl-format grid directory (native loader path)."""
import os

import numpy as np
import jax.numpy as jnp
import pytest

from mcmc_spec_tpu.models.synthetic import synthetic_spectrum


def _write_btsettl_grid(dirname, temps, loggs, specrange=(2900.0, 26100.0), step=2.0):
    os.makedirs(dirname, exist_ok=True)
    wl = np.arange(*specrange, step)
    for t in temps:
        for g in loggs:
            flux = synthetic_spectrum(wl, t, g)
            name = f"lte{str(int(t / 100)).zfill(3)}-{g}-0.0a+0.0.BT-Settl.spec.7.txt"
            np.savetxt(os.path.join(dirname, name), np.column_stack([wl, flux]),
                       fmt="%.4f %.6e")
    return dirname


def test_btsettl_pipeline(tmp_path, bps_dir):
    os.chdir(tmp_path)
    grid_dir = _write_btsettl_grid(
        str(tmp_path / "BT-Settl_M-0.0a+0.0"),
        temps=np.arange(3000.0, 5601.0, 400.0), loggs=[4.5, 5.0],
    )

    from mcmc_spec_tpu.pipeline import setup_context, run_optimize_stage
    from mcmc_spec_tpu.report.composite import composite_full
    from mcmc_spec_tpu.utils.config import FitConfig

    # observation from the same family
    wl_um = np.linspace(0.652, 0.838, 500)
    rng = np.random.RandomState(0)
    base = synthetic_spectrum(wl_um * 1e4, 4600.0, 4.6) * 1e-21
    base += synthetic_spectrum(wl_um * 1e4, 3400.0, 5.0) * 2e-22
    err = 0.01 * base
    datafile = tmp_path / "obs.txt"
    np.savetxt(datafile, np.column_stack([wl_um, base + rng.normal(0, err), err]))

    param = tmp_path / "param_bt.txt"
    param.write_text(f"""models btsettl
dirname {tmp_path}/run
fname bt
res 1700
tmin 3000
tmax 5600
specmin 3000
specmax 26000
mask True
filename {datafile}
spmin 0.645
spmax 0.84
cmag [2.0,1.3]
cerr [0.1,0.1]
cfilt ['lp600','Kp']
pmag [14.0,13.5,13.2,12.2,11.7,11.6]
perr [0.1,0.1,0.1,0.1,0.1,0.1]
pfilt ['sdss,r','sdss,i','sdss,z','j','h','k']
plx 2.0e-3
plx_err 0.1e-3
dist_fit True
av 0.1
av_err 0.05
ra 288.0
dec 45.0
nwalk 8
nstep 15
nspec 2
ndust 0
nburn 10
nsteps 30
real_values [0,0,0,0,0,0]
bps_dir {bps_dir}
grid_dir {grid_dir}
""")
    cfg = FitConfig.from_file(str(param))
    assert cfg.grid_dir == grid_dir
    ctx = setup_context(cfg, dtype=jnp.float64)
    # grid discovered from the BT-Settl directory naming convention
    assert list(ctx.grid.temps) == [3000.0, 3400.0, 3800.0, 4200.0, 4600.0, 5000.0, 5400.0]
    assert list(ctx.grid.loggs) == [4.5, 5.0]
    # hybrid-resolution grid on the 0.2 A common lattice (mft6.py:343)
    assert abs((ctx.grid.wl[1] - ctx.grid.wl[0]) - 0.2) < 1e-9

    run_optimize_stage(ctx, record_thin=0)
    chis = np.genfromtxt(os.path.join(cfg.dirname, "optimize_cs.txt"))
    assert np.all(np.isfinite(chis)) and len(chis) == 8

    # grid cache round-trip
    ctx2 = setup_context(cfg, dtype=jnp.float64)
    np.testing.assert_array_equal(ctx2.grid.flux, ctx.grid.flux)
