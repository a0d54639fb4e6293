"""Edge-case hardening: degenerate grids, tent-weight properties, odd shapes."""
import numpy as np
import jax
import jax.numpy as jnp
import pytest

from mcmc_spec_tpu.ops.interp import pwl_interp, tent_weights
from mcmc_spec_tpu.ops.photometry import contrast_weights, photon_flux_weights


class TestTentWeightProperties:
    def test_random_grids_match_np_interp(self):
        rng = np.random.RandomState(0)
        for trial in range(25):
            n = rng.randint(2, 40)
            xs = np.sort(rng.uniform(-5, 5, n))
            while np.any(np.diff(xs) < 1e-9):  # ensure strictly increasing
                xs = np.sort(rng.uniform(-5, 5, n))
            ys = rng.randn(n)
            q = rng.uniform(-7, 7, 64)
            got = np.asarray(pwl_interp(jnp.asarray(xs), jnp.asarray(ys), jnp.asarray(q)))
            np.testing.assert_allclose(got, np.interp(q, xs, ys), rtol=1e-9, atol=1e-9,
                                       err_msg=f"trial {trial}, n={n}")

    def test_exact_at_nodes(self):
        xs = jnp.asarray([0.0, 0.3, 1.7, 2.0])
        ys = jnp.asarray([1.0, -2.0, 5.0, 0.5])
        got = np.asarray(pwl_interp(xs, ys, xs))
        np.testing.assert_allclose(got, np.asarray(ys), rtol=1e-12)

    def test_weights_nonneg_and_local(self):
        xs = jnp.asarray(np.linspace(0, 1, 11))
        w = np.asarray(tent_weights(xs, jnp.asarray([0.34])))[0]
        assert np.all(w >= 0)
        assert (w > 0).sum() <= 2  # at most two supporting nodes

    def test_batched_shapes(self):
        xs = jnp.asarray(np.linspace(0, 1, 7))
        q = jnp.asarray(np.random.RandomState(0).rand(4, 3, 5))
        w = tent_weights(xs, q)
        assert w.shape == (4, 3, 5, 7)
        np.testing.assert_allclose(np.asarray(w.sum(-1)), 1.0, rtol=1e-6)


class TestFilterWeightEdges:
    def test_filter_wider_than_grid(self):
        # filter support extends beyond the model grid: weights cover overlap
        wl = np.arange(5000.0, 6000.0, 1.0)
        fwl = np.linspace(4000.0, 7000.0, 50)
        ftr = np.ones(50)
        W = contrast_weights(wl, fwl, ftr)
        spec = np.ones_like(wl)
        # trapz of 1 over the full grid span
        assert abs(W @ spec - (wl[-1] - wl[0])) < 1.0

    def test_unsorted_filter_curve(self):
        wl = np.arange(5000.0, 6000.0, 1.0)
        fwl = np.array([5500.0, 5300.0, 5700.0, 5400.0, 5600.0])
        ftr = np.array([1.0, 0.5, 0.5, 0.8, 0.8])
        W, lp = photon_flux_weights(wl, fwl, ftr)  # sorts internally
        assert np.isfinite(lp) and 5300 < lp < 5700
        assert np.all(np.isfinite(W))

    def test_narrow_filter_raises(self):
        wl = np.arange(5000.0, 6000.0, 100.0)
        fwl = np.linspace(5510.0, 5520.0, 10)  # covers <2 grid points
        with pytest.raises(ValueError):
            contrast_weights(wl, fwl, np.ones(10))


class TestDegenerateGrids:
    def test_two_point_grid_axes(self):
        """Smallest legal grid: 2 temps x 2 loggs."""
        from mcmc_spec_tpu.models.synthetic import synthetic_grid
        from mcmc_spec_tpu.ops.interp import bilinear_bracket, bilinear_gather_blend

        g = synthetic_grid(specrange=(6000.0, 7000.0), data_window=(6400.0, 6600.0),
                           resolution=1000, temps=np.array([3000.0, 4000.0]),
                           loggs=np.array([4.5, 5.0]), step=2.0)
        ti, tw = bilinear_bracket(jnp.asarray(g.temps), 3500.0)
        gi, gw = bilinear_bracket(jnp.asarray(g.loggs), 4.75)
        out = bilinear_gather_blend(jnp.asarray(g.flux), ti, tw, gi, gw)
        manual = g.flux.mean(axis=(0, 1))
        np.testing.assert_allclose(np.asarray(out), manual, rtol=1e-10)

    def test_walker_count_not_multiple_of_block(self):
        """Odd ensemble sizes (e.g. top-1/3 of 150 = 50) work end to end."""
        from mcmc_spec_tpu.bench_target import build_bench_target, init_walker_batch
        from mcmc_spec_tpu.inference.batched import log_posterior_batch
        from mcmc_spec_tpu.inference.stretch import init_ensemble, run_ensemble

        tgt, truth = build_bench_target(jnp.float64, nd=200, grid_step=16.0)
        logp = lambda b: log_posterior_batch(b, tgt)
        for nw in (50, 21, 7):
            coords = init_walker_batch(tgt, truth, nw, jnp.float64)
            state = init_ensemble(coords, logp, jax.random.PRNGKey(0))
            state, chain, logps = run_ensemble(state, logp, n_steps=10, thin=10)
            assert np.all(np.isfinite(np.asarray(logps)))


class TestConfigEdges:
    def test_nan_pmag_parsing(self, tmp_path):
        from mcmc_spec_tpu.utils.config import FitConfig

        pf = tmp_path / "p.txt"
        pf.write_text("pmag [13.0,np.nan,11.0]\npfilt ['j','h','k']\n")
        cfg = FitConfig.from_file(str(pf))
        assert np.isnan(cfg.pmag[1]) and cfg.pmag[0] == 13.0

    def test_synth_keyed_on_filename(self, tmp_path):
        from mcmc_spec_tpu.utils.config import FitConfig

        pf = tmp_path / "param_synth_x.txt"
        pf.write_text("models synthetic\n")
        assert FitConfig.from_file(str(pf)).synth
        pf2 = tmp_path / "param_koi1.txt"
        pf2.write_text("models synthetic\n")
        assert not FitConfig.from_file(str(pf2)).synth

    def test_tab_and_comment_tolerance(self, tmp_path):
        from mcmc_spec_tpu.utils.config import FitConfig

        pf = tmp_path / "p.txt"
        pf.write_text("res 1700\t\t#resolution comment\ntmin 3000 \n# full comment\n\n")
        cfg = FitConfig.from_file(str(pf))
        assert cfg.res == 1700 and cfg.tmin == 3000


class TestTelluricMaskBoundaries:
    def test_reference_boundary_semantics(self):
        """Kept/dropped sets match mft6.py:3496-3499 exactly at band edges."""
        from mcmc_spec_tpu.io.spectra import apply_telluric_mask

        wl = np.array([0.6860, 0.6870, 0.6880, 0.7600, 0.7630, 0.7660,
                       0.8210, 0.8230, 0.8240, 0.8241])
        keep = apply_telluric_mask(wl)
        # reference keeps: <=0.6860 | [0.6880,0.7600] | [0.7660,0.8210] | >0.8240
        ref_keep = ((wl <= 0.6860) | ((wl >= 0.6880) & (wl <= 0.7600))
                    | ((wl >= 0.7660) & (wl <= 0.8210)) | (wl > 0.8240))
        np.testing.assert_array_equal(keep, ref_keep)


class TestFleetGaussianStats:
    def test_fleet_sampler_recovers_independent_targets(self):
        """Each fleet lane samples its own Gaussian correctly."""
        import jax
        import jax.numpy as jnp
        import dataclasses
        from mcmc_spec_tpu.inference import fleet as F
        from mcmc_spec_tpu.inference.stretch import EnsembleState

        # stub "fleet": monkeypatch log_posterior_fleet via a tiny shim object
        mus = jnp.asarray([[0.0, 1.0], [3.0, -2.0], [-1.0, 5.0]])

        def logp_fleet(params, fleet_unused):
            d = params - mus[:, None, :]
            return -0.5 * jnp.sum(d * d, axis=-1)

        orig = F.log_posterior_fleet
        F.log_posterior_fleet = logp_fleet
        try:
            coords = mus[:, None, :] + 0.1 * jax.random.normal(
                jax.random.PRNGKey(0), (3, 32, 2))
            state = EnsembleState(coords, logp_fleet(coords, None),
                                  jax.random.PRNGKey(1), jnp.zeros((), jnp.int32))
            state, chain, _ = F.run_fleet_ensemble(state, None, n_steps=1500, thin=1)
            samples = np.asarray(chain[300:])  # [n, 3, 32, 2]
            for t in range(3):
                flat = samples[:, t].reshape(-1, 2)
                np.testing.assert_allclose(flat.mean(axis=0), np.asarray(mus[t]),
                                           atol=0.15)
                np.testing.assert_allclose(flat.std(axis=0), 1.0, atol=0.2)
        finally:
            F.log_posterior_fleet = orig


class TestBimodalDecompose:
    def test_picks_dominant_mode(self):
        from mcmc_spec_tpu.report.corner_stats import bimodal_decompose

        rng = np.random.RandomState(0)
        x = np.concatenate([rng.normal(4000, 50, 8000), rng.normal(4600, 60, 2000)])
        mu, sigma, diag = bimodal_decompose(x)
        assert abs(mu - 4000) < 40  # dominant mode
        assert 20 < sigma < 100
        assert diag["dominant_fraction"] > 0.6

    def test_unimodal_fallback(self):
        from mcmc_spec_tpu.report.corner_stats import bimodal_decompose

        x = np.random.RandomState(1).normal(5000, 30, 3000)
        mu, sigma, diag = bimodal_decompose(x)
        # either a successful (degenerate) fit or the median fallback
        assert abs(mu - 5000) < 50


class TestDegenerateAxes:
    def test_near_duplicate_nodes(self):
        """Nodes closer than float spacing of queries still sum to 1."""
        xs = jnp.asarray([0.0, 0.5, 0.5 + 1e-6, 1.0])
        q = jnp.asarray([0.25, 0.5, 0.75])
        w = np.asarray(tent_weights(xs, q))
        np.testing.assert_allclose(w.sum(-1), 1.0, rtol=1e-4)
        assert np.all(w >= 0)

    def test_single_interval_interp(self):
        xs = jnp.asarray([2.0, 3.0])
        ys = jnp.asarray([10.0, 20.0])
        q = jnp.asarray([1.0, 2.0, 2.5, 3.0, 9.0])
        got = np.asarray(pwl_interp(xs, ys, q))
        np.testing.assert_allclose(got, np.interp(np.asarray(q), np.asarray(xs),
                                                  np.asarray(ys)), rtol=1e-9)
