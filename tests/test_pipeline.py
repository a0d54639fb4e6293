"""End-to-end pipeline test: param file -> optimize -> MCMC -> artifacts.

Uses the self-contained synthetic model family plus a synthetic filter-curve
directory in the reference's file formats (the ``bps_dir`` fixture).
"""
import os

import numpy as np
import jax.numpy as jnp
import pytest

TRUTH = dict(t1=4600.0, t2=3400.0, av=0.12, r1=0.72, rr2=0.45, plx=2.0e-3)


def _write_param_file(tmp_path, datafile, cmag, pmag, dirname, bps_dir):
    content = f"""### synthetic end-to-end fixture
models synthetic
dirname {dirname}
fname synthfit
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
cmag [{cmag[0]:.4f},{cmag[1]:.4f}]
cerr [0.05,0.05]
cfilt ['lp600','Kp']
pmag [{','.join(f'{m:.4f}' for m in pmag)}]
perr [0.05,0.05,0.05,0.05,0.05,0.05]
pfilt ['sdss,r','sdss,i','sdss,z','j','h','k']
plx {TRUTH['plx']}
plx_err 0.05e-3
dist_fit True
av {TRUTH['av']}
av_err 0.01
ra 288.456118
dec 45.802226
nwalk 24
nstep 40
nspec 2
ndust 0
nburn 40
nsteps 200
real_values [{TRUTH['t1']},{TRUTH['t2']},{TRUTH['av']},{TRUTH['r1']},{TRUTH['rr2']},{TRUTH['plx']}]
bps_dir {bps_dir}
"""
    path = tmp_path / "param_synth_e2e.txt"
    path.write_text(content)
    return str(path)


@pytest.fixture(scope="module")
def e2e(tmp_path_factory, bps_dir):
    """Generate a synthetic observation, run both stages, return the context."""
    tmp_path = tmp_path_factory.mktemp("e2e")
    os.chdir(tmp_path)  # pipeline writes results under cwd/dirname

    from mcmc_spec_tpu.pipeline import setup_context, run_optimize_stage, run_mcmc_stage
    from mcmc_spec_tpu.utils.config import FitConfig
    from mcmc_spec_tpu.report.composite import composite_full
    from mcmc_spec_tpu.ops.extinction import ccm89
    from mcmc_spec_tpu.inference.posterior import forward_summary

    # a first pass with placeholder observations to get a context for truth-mags
    rng = np.random.RandomState(42)
    wl_um = np.linspace(0.650, 0.838, 1200)
    datafile = str(tmp_path / "synth_obs.txt")
    np.savetxt(datafile, np.column_stack([wl_um, np.ones_like(wl_um), 0.01 * np.ones_like(wl_um)]))

    param0 = _write_param_file(tmp_path, datafile, [1.0, 1.0], [14.0, 13.5, 13.2, 12.2, 11.7, 11.6],
                               dirname="run0", bps_dir=bps_dir)
    cfg0 = FitConfig.from_dict(
        {**{k: v for k, v in _parse(param0).items()}}
    )
    ctx0 = setup_context(FitConfig.from_file(param0), dtype=jnp.float64)

    p_truth = np.array([TRUTH["t1"], TRUTH["t2"], TRUTH["av"], TRUTH["r1"],
                        TRUTH["rr2"], TRUTH["plx"]])

    # synth observation: full composite at truth, extincted, on the data grid
    w, comp, _ = composite_full(ctx0.grid, ctx0.mist, p_truth, 2)
    comp = comp * 10 ** (-0.4 * np.asarray(ccm89(w, TRUTH["av"])))
    flux = np.interp(wl_um * 1e4, w, comp)
    err = 0.01 * flux
    flux = flux + rng.normal(0, err)
    np.savetxt(datafile, np.column_stack([wl_um, flux, err]))

    # truth-consistent contrasts/photometry from the packed forward
    summ = forward_summary(jnp.asarray(p_truth), ctx0.target)
    cmag = np.asarray(summ["contrasts"])
    pmag = np.asarray(summ["phot_mags"])

    paramfile = _write_param_file(tmp_path, datafile, cmag, pmag, dirname="run1",
                                  bps_dir=bps_dir)
    # the synth branch keys off the file name containing 'synth'
    cfg = FitConfig.from_file(paramfile)
    assert cfg.synth
    cfg.nsteps = 200
    ctx = setup_context(cfg, dtype=jnp.float64)

    run_optimize_stage(ctx, record_thin=200)
    samples = run_mcmc_stage(ctx, nthin=50, check_convergence=False)
    return dict(ctx=ctx, samples=samples, tmp_path=tmp_path, p_truth=p_truth)


def _parse(path):
    from mcmc_spec_tpu.utils.config import parse_param_file

    return parse_param_file(path)


class TestPipeline:
    def test_optimize_artifacts(self, e2e):
        d = e2e["ctx"].cfg.dirname
        assert os.path.exists(os.path.join(d, "optimize_res.txt"))
        assert os.path.exists(os.path.join(d, "optimize_cs.txt"))
        chis = np.genfromtxt(os.path.join(d, "optimize_cs.txt"))
        assert len(chis) == 24

    def test_samples_artifact(self, e2e):
        d = e2e["ctx"].cfg.dirname
        samples = np.genfromtxt(os.path.join(d, "samples.txt"))
        assert samples.shape[1] == 6
        assert samples.shape[0] >= 200

    def test_posterior_brackets_truth(self, e2e):
        samples = e2e["samples"]
        truth = e2e["p_truth"]
        med = np.median(samples, axis=0)
        sig = samples.std(axis=0) + 1e-12
        for i in range(6):
            assert abs(med[i] - truth[i]) < 5 * sig[i], (i, med[i], truth[i], sig[i])

    def test_report_artifacts(self, e2e):
        from mcmc_spec_tpu.report.plots import plot_corner, plot_results, plot_fit

        ctx, samples = e2e["ctx"], e2e["samples"]
        plot_fit(ctx)
        plot_corner(ctx, samples)
        plot_results(ctx, samples, n_spec_draws=10, n_kep_draws=100)
        d = ctx.cfg.dirname
        for art in [
            "plots/synthfit_corner.pdf", "plots/bestfit_spec.pdf",
            "plots/synthfit_phot_scatter.pdf", "plots/synthfit_all_spec.pdf",
            "plots/bestfit_spec_post_mcmc.pdf", "plots/synthfit_delta_kep.pdf",
            "plots/synthfit_pri_corr.pdf", "plots/synthfit_sec_corr.pdf",
            "plots/synthfit_isochrone.pdf", "plots/primary_mass_posterior.pdf",
            "params.txt", "kep_contrast.txt", "pri_corr.txt", "sec_corr.txt",
            "gaia_pri.txt", "gaia_sec.txt", "primary_mass_posterior.txt",
        ]:
            assert os.path.exists(os.path.join(d, art)), art

    def test_kep_contrast_consistency(self, e2e):
        """Kepler contrast should be positive (secondary fainter) and O(1)."""
        d = e2e["ctx"].cfg.dirname
        kc = np.genfromtxt(os.path.join(d, "kep_contrast.txt"))
        assert np.median(kc) > 0.5  # 4600K vs 3400K companion is much fainter
        assert np.median(kc) < 10


class TestSharedGridCache:
    def test_grid_cache_shared_across_dirnames(self, tmp_path, monkeypatch):
        """Identical grid specs pack ONCE per run directory, not once per
        target dirname (a 9-target fleet measured 18 ~20 s synthetic-grid
        builds before the shared .grid_cache/)."""
        import time as _time

        from mcmc_spec_tpu.pipeline import build_grid
        from mcmc_spec_tpu.utils.config import FitConfig

        monkeypatch.chdir(tmp_path)
        cfg = FitConfig()
        cfg.models = "synthetic"
        cfg.tmin, cfg.tmax = 3000, 3800
        cfg.specmin, cfg.specmax = 6000, 9000
        cfg.res = 1700
        cfg.dirname = "tgt_a"
        g1 = build_grid(cfg, (6450.0, 8400.0))
        assert os.path.isdir(".grid_cache")
        cfg.dirname = "tgt_b"  # different target, same grid spec
        t0 = _time.time()
        g2 = build_grid(cfg, (6450.0, 8400.0))
        assert _time.time() - t0 < 2.0  # cache hit, no rebuild
        np.testing.assert_array_equal(g1.flux, g2.flux)
        # a different data window is a different packed grid (hybrid-res
        # broadening bakes it into the fluxes) -> distinct cache entry
        g3 = build_grid(cfg, (6500.0, 8300.0))
        assert not np.array_equal(g1.flux, g3.flux)

    def test_grid_cache_keys_on_grid_dir(self, tmp_path, monkeypatch):
        """Two runs against DIFFERENT model directories (--grid-dir) must
        not reuse each other's cached fluxes."""
        from mcmc_spec_tpu.models.synthetic import synthetic_spectrum
        from mcmc_spec_tpu.pipeline import build_grid
        from mcmc_spec_tpu.utils.config import FitConfig

        monkeypatch.chdir(tmp_path)
        wl = np.arange(5900.0, 9100.0, 1.0)
        for name, scale in (("gridA", 1.0), ("gridB", 2.0)):
            d = tmp_path / name
            d.mkdir()
            for t in (30, 34):
                for g in ("4.5", "5.0"):
                    flux = scale * synthetic_spectrum(wl, t * 100.0, float(g))
                    np.savetxt(d / f"lte0{t}-{g}-0.0a+0.0.BT-Settl.spec.7.txt",
                               np.column_stack([wl, flux]))

        cfg = FitConfig()
        cfg.models = "btsettl"
        cfg.tmin, cfg.tmax = 2000, 6000
        cfg.specmin, cfg.specmax = 6000, 9000
        cfg.res = 1700
        cfg.dirname = "tgt_a"
        cfg.grid_dir = str(tmp_path / "gridA")
        gA = build_grid(cfg, (6450.0, 8400.0))
        cfg.grid_dir = str(tmp_path / "gridB")
        gB = build_grid(cfg, (6450.0, 8400.0))
        assert not np.array_equal(gA.flux, gB.flux)
        np.testing.assert_allclose(gB.flux, 2.0 * gA.flux, rtol=1e-6)


class TestAclGateSchedule:
    """The geometric autocorrelation-gate cadence (VERDICT r3 weak #5)."""

    def test_schedule_prefix_and_config5_count(self):
        from mcmc_spec_tpu.pipeline import next_acl_gate

        gates, g = [], 1
        while g <= 150:
            gates.append(g)
            g = next_acl_gate(g)
        # the documented schedule (banker's rounding at 6*1.3 = 7.8 -> 8
        # via round(7.8); round(6.5) would be 6 — pin the emergent values)
        assert gates[:11] == [1, 2, 3, 4, 5, 6, 8, 10, 13, 17, 22]
        # 18 gates across the 150-chunk config-5 schedule (matches the
        # measured receipt in scripts/acl_gate_cost.py)
        assert len(gates) == 18
        # strictly increasing, never stalls
        assert all(b > a for a, b in zip(gates, gates[1:]))

    def test_total_traffic_is_linear(self):
        """Sum of chain lengths re-scanned across all gates is O(n): the
        geometric cadence pays ~4.0x the final chain length at n=150
        (the per-chunk cadence pays n/2 = 75x)."""
        from mcmc_spec_tpu.pipeline import next_acl_gate

        total, g = 0, 1
        while g <= 150:
            total += g
            g = next_acl_gate(g)
        assert total < 5 * 150  # exact: 602 chunk-lengths ~= 4.0x
