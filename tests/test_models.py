"""SpectralGrid packing, hybrid-resolution contract, MIST, dust, native loader."""
import os

import numpy as np
import pytest

from mcmc_spec_tpu.models.grid import SpectralGrid, _read_two_columns_py
from mcmc_spec_tpu.models.synthetic import synthetic_grid, synthetic_spectrum
from mcmc_spec_tpu.models.mist import MistTable
from mcmc_spec_tpu.models.dust import AvProfile
from mcmc_spec_tpu.ops.broaden import instrumental_broaden


class TestSpectralGrid:
    def test_pack_shapes_and_axes_sorted(self):
        g = synthetic_grid(
            specrange=(6000.0, 9000.0),
            data_window=(6450.0, 8400.0),
            resolution=1700,
            temps=np.array([3600.0, 3000.0, 3300.0]),
            loggs=np.array([5.0, 4.5]),
            step=0.5,
        )
        assert np.all(np.diff(g.temps) > 0)
        assert np.all(np.diff(g.loggs) > 0)
        assert g.flux.shape == (3, 2, len(g.wl))
        assert abs((g.wl[1] - g.wl[0]) - 0.5) < 1e-9

    def test_hybrid_resolution_contract(self):
        """Broadened inside the data window, native outside (mft6.py:366-383)."""
        specrange = (6000.0, 9000.0)
        window = (6450.0, 8400.0)
        wl = np.arange(*specrange, 0.5)
        native = synthetic_spectrum(wl, 3800.0, 5.0)

        def entries():
            yield 3800.0, 5.0, wl, native

        g = SpectralGrid.from_spectra(entries(), specrange, window, 1700, step=0.5)
        packed = g.flux[0, 0]
        out_mask = (g.wl < window[0] - 5) | (g.wl > window[1] + 5)
        in_mask = (g.wl > window[0] + 20) & (g.wl < window[1] - 20)
        # outside: native resolution preserved exactly
        np.testing.assert_allclose(packed[out_mask], native[out_mask], rtol=1e-12)
        # inside: smoothed (less small-scale variance)
        dn = np.diff(native[in_mask])
        dp = np.diff(packed[in_mask])
        assert dp.std() < 0.98 * dn.std()
        assert not np.allclose(packed[in_mask], native[in_mask])

    def test_npz_roundtrip(self, tmp_path):
        g = synthetic_grid(
            specrange=(6000.0, 7000.0), data_window=(6400.0, 6800.0), resolution=1000,
            temps=np.array([3000.0, 3400.0]), loggs=np.array([4.5, 5.0]), step=1.0,
        )
        path = str(tmp_path / "grid.npz")
        g.save_npz(path)
        g2 = SpectralGrid.from_npz(path)
        np.testing.assert_array_equal(g.flux, g2.flux)
        np.testing.assert_array_equal(g.wl, g2.wl)

    def test_interp_spectrum_between_gridpoints(self):
        g = synthetic_grid(
            specrange=(6000.0, 7000.0), data_window=(6400.0, 6800.0), resolution=1000,
            temps=np.array([3000.0, 3400.0]), loggs=np.array([4.5, 5.0]), step=1.0,
        )
        mid = g.interp_spectrum(3200.0, 4.75)
        manual = 0.25 * (g.flux[0, 0] + g.flux[0, 1] + g.flux[1, 0] + g.flux[1, 1])
        np.testing.assert_allclose(mid, manual, rtol=1e-10)

    def test_interp_spectrum_matches_jax_helpers(self):
        """interp_spectrum is a pure-numpy mirror of ops.interp's
        bilinear_bracket/bilinear_gather_blend BY DESIGN (a jnp version
        re-uploads the whole flux cube per call, once most of a production
        fit's report loop); this pins the two implementations to each other, including edge
        clamping and beyond-range extrapolation."""
        import jax.numpy as jnp

        from mcmc_spec_tpu.ops.interp import bilinear_bracket, bilinear_gather_blend

        g = synthetic_grid(
            specrange=(6000.0, 7000.0), data_window=(6400.0, 6800.0), resolution=1000,
            temps=np.array([3000.0, 3400.0, 3800.0]), loggs=np.array([4.0, 4.5, 5.0]),
            step=1.0,
        )
        for teff, logg in [(3200.0, 4.75), (3000.0, 4.0), (3800.0, 5.0),
                           (2900.0, 3.8), (3950.0, 5.2), (3400.0, 4.5)]:
            ti, tw = bilinear_bracket(jnp.asarray(g.temps, jnp.float64), teff)
            gi, gw = bilinear_bracket(jnp.asarray(g.loggs, jnp.float64), logg)
            want = np.asarray(bilinear_gather_blend(
                jnp.asarray(g.flux, jnp.float64), ti, tw, gi, gw))
            got = g.interp_spectrum(teff, logg)
            np.testing.assert_allclose(got, want, rtol=1e-12, atol=0)


class TestBtsettlLoader:
    def _write_btsettl(self, tmp_path):
        d = tmp_path / "BT-Settl_M-0.0a+0.0"
        d.mkdir()
        wl = np.arange(5900.0, 9100.0, 1.0)
        for t in (30, 34):
            for g in ("4.5", "5.0"):
                flux = synthetic_spectrum(wl, t * 100.0, float(g))
                path = d / f"lte0{t}-{g}-0.0a+0.0.BT-Settl.spec.7.txt"
                np.savetxt(path, np.column_stack([wl, flux]))
        return str(d)

    def test_directory_load(self, tmp_path):
        d = self._write_btsettl(tmp_path)
        g = SpectralGrid.from_btsettl_dir(
            d, (2000, 6000), (4.0, 5.5), (6000, 9000), (6450, 8400), 1700,
            use_native=False,
        )
        assert list(g.temps) == [3000.0, 3400.0]
        assert list(g.loggs) == [4.5, 5.0]

    def test_native_loader_matches_python(self, tmp_path):
        from mcmc_spec_tpu.runtime import native_loader

        reader = native_loader.maybe_reader()
        if reader is None:
            pytest.skip("native toolchain unavailable")
        d = self._write_btsettl(tmp_path)
        path = os.path.join(d, os.listdir(d)[0])
        wl_n, fx_n = reader.read_two_columns(path, 6000.0, 9000.0)
        wl_p, fx_p = _read_two_columns_py(path, 6000.0, 9000.0)
        np.testing.assert_allclose(wl_n, wl_p, rtol=1e-15)
        np.testing.assert_allclose(fx_n, fx_p, rtol=1e-15)

    def test_native_read_many(self, tmp_path):
        from mcmc_spec_tpu.runtime import native_loader

        reader = native_loader.maybe_reader()
        if reader is None:
            pytest.skip("native toolchain unavailable")
        d = self._write_btsettl(tmp_path)
        paths = [os.path.join(d, f) for f in sorted(os.listdir(d))]
        out = reader.read_many(paths, 6000.0, 9000.0)
        assert len(out) == len(paths)
        for path, (wl, fx) in zip(paths, out):
            wl_p, fx_p = _read_two_columns_py(path, 6000.0, 9000.0)
            np.testing.assert_allclose(wl, wl_p)
            np.testing.assert_allclose(fx, fx_p)


class TestMist:
    def test_builtin_monotone(self):
        m = MistTable.builtin()
        t = np.linspace(2800, 7000, 50)
        r = m.get_radius(t)
        assert np.all(np.diff(r) > 0)  # radius grows with Teff on the MS
        g = m.get_logg(t)
        assert np.all(np.diff(g) < 0.01)  # logg decreases (roughly monotone)

    def test_solar_point(self):
        m = MistTable.builtin()
        assert abs(m.get_radius(5772.0) - 1.0) < 0.05
        assert abs(m.get_logg(5772.0) - 4.438) < 0.1

    def test_cmd_file_roundtrip(self, tmp_path):
        from mcmc_spec_tpu.models.mist import _builtin_track

        mat = _builtin_track()
        path = str(tmp_path / "mist.cmd")
        np.savetxt(path, mat)
        m = MistTable.from_cmd_file(path)
        b = MistTable.builtin()
        np.testing.assert_allclose(m.get_radius(4000.0), b.get_radius(4000.0), rtol=1e-8)

    def test_builtin_density_and_order(self):
        """>=220 age-9 rows ascending in Teff (reference truncation mft6.py:76,95)."""
        from mcmc_spec_tpu.models.mist import _builtin_track

        mat = _builtin_track()
        age9 = mat[mat[:, 1] == 9.0]
        assert len(age9) >= 220
        assert np.all(np.diff(age9[:, 4]) > 0)  # EEP rows ascend in Teff
        # anchors are reproduced exactly (PCHIP interpolates through nodes)
        from mcmc_spec_tpu.models.mist import _ANCHORS, GM_SUN_OVER_RSUN2

        m = MistTable.builtin()
        # anchors within the 220-row truncation window (the reference's own
        # truncation also discards the hottest rows)
        in_range = _ANCHORS[(_ANCHORS[:, 0] >= 2700) & (_ANCHORS[:, 0] <= 7000)]
        assert len(in_range) >= 25
        for teff, rad, mass, _, _ in in_range:
            np.testing.assert_allclose(m.get_radius(teff), rad, rtol=2e-3)
            np.testing.assert_allclose(
                m.get_logg(teff), np.log10(GM_SUN_OVER_RSUN2 * mass / rad**2),
                atol=2e-3)

    def test_realistic_cmd_fixture(self, tmp_path):
        """Genuine .cmd shape: '#' headers, multi-age blocks, 220-row truncation."""
        from mcmc_spec_tpu.models.mist import _builtin_track

        age9 = _builtin_track(260)
        age8 = age9.copy()
        age8[:, 1] = 8.0
        age8[:, 6] -= 0.05  # slightly different younger track
        age95 = age9.copy()
        age95[:, 1] = 9.5
        mat = np.concatenate([age8, age9, age95], axis=0)
        path = str(tmp_path / "mist_2mass_old.cmd")
        with open(path, "w") as f:
            f.write("# MIST version number  = 1.2\n")
            f.write("# photometric system   = 2MASS\n")
            f.write("# EEP log10_isochrone_age_yr star_mass ... (25 cols)\n")
            np.savetxt(f, mat)
        m = MistTable.from_cmd_file(path)

        # only the age-9 block, truncated to its first 220 rows, is consumed
        sel = age9[:220]
        teff_nodes = 10.0 ** sel[:, 4]
        for q in (3200.0, 4000.0, 5500.0):
            exp_logg = np.interp(q, teff_nodes, sel[:, 5])
            np.testing.assert_allclose(m.get_logg(q), exp_logg, rtol=1e-10)
            from mcmc_spec_tpu.models.mist import LSUN, RSUN, SIGMA_SB

            lum = np.interp(q, teff_nodes, 10.0 ** sel[:, 6])
            exp_rad = np.sqrt(lum * LSUN / (4 * np.pi * SIGMA_SB * q**4)) / RSUN
            np.testing.assert_allclose(m.get_radius(q), exp_rad, rtol=1e-10)
        # the other age blocks must NOT leak in: the age-8 block's logL is
        # 0.05 dex lower, which would shift the radius by ~6%
        lum8 = np.interp(4000.0, teff_nodes, 10.0 ** (sel[:, 6] - 0.05))
        from mcmc_spec_tpu.models.mist import LSUN, RSUN, SIGMA_SB

        rad8 = np.sqrt(lum8 * LSUN / (4 * np.pi * SIGMA_SB * 4000.0**4)) / RSUN
        assert abs(float(m.get_radius(4000.0)) - rad8) / rad8 > 0.03

    def test_builtin_vs_mist_error_bound(self):
        """Bound the builtin's error over 2800-6500 K (VERDICT item 4).

        Internal consistency: logg == log10(G M / R^2) exactly by construction;
        externally, the dwarf sequence matches interferometric benchmarks
        (Boyajian+2012; Sun) to <=10% in radius — the level at which the
        builtin can differ from genuine MIST v1.2.
        """
        from mcmc_spec_tpu.models.mist import GM_SUN_OVER_RSUN2

        m = MistTable.builtin()
        tgrid = np.linspace(2800.0, 6500.0, 150)
        logg_tab = m.get_logg(tgrid)
        logg_mr = np.log10(GM_SUN_OVER_RSUN2 * m.get_mass(tgrid)
                           / m.get_radius(tgrid) ** 2)
        np.testing.assert_allclose(logg_tab, logg_mr, atol=0.02)

        # interferometric dwarf benchmarks (Teff K, R/Rsun)
        for teff, rad, tol in [(5772.0, 1.00, 0.05),   # Sun
                               (4600.0, 0.73, 0.10),   # early K dwarf
                               (3400.0, 0.33, 0.15)]:  # mid M dwarf
            assert abs(float(m.get_radius(teff)) - rad) / rad < tol, teff


class TestAvProfile:
    def test_constant_profile(self):
        p = AvProfile.constant(0.2, 0.0)
        assert np.all(p.av_sig == 0.05)  # sigma floor (mft6.py:1237-1238)
        lo, step, mu, sig = p.device_tables(n=16)
        np.testing.assert_allclose(np.asarray(mu), 0.2)

    def test_table_roundtrip(self, tmp_path):
        d = np.geomspace(10, 1000, 20)
        mu = 0.1 + 0.3 * np.log10(d) / 3
        sig = np.full(20, 0.08)
        path = str(tmp_path / "prof.txt")
        np.savetxt(path, np.column_stack([d, mu, sig]))
        p = AvProfile.from_table(path)
        np.testing.assert_allclose(p.av_mu, mu)

    def test_fallback_for_target_no_distance(self, capsys):
        p = AvProfile.for_target(288.45, 45.8, av_fallback=0.106, av_err_fallback=0.01)
        # dustmaps absent + no distance -> constant fallback, loudly logged
        assert np.all(p.av_sig >= 0.01)
        assert np.ptp(p.av_mu) == 0.0
        assert "CONSTANT" in capsys.readouterr().out

    def test_fallback_for_target_with_distance(self, capsys):
        """With a target distance the fallback is the analytic LOS model."""
        p = AvProfile.for_target(288.456118, 45.802226, av_fallback=0.106,
                                 av_err_fallback=0.01, dist_pc=482.0)
        out = capsys.readouterr().out
        assert "analytic thin-disk" in out
        # calibrated: Av at the target distance equals the config value
        np.testing.assert_allclose(np.interp(482.0, p.dist_pc, p.av_mu), 0.106,
                                   rtol=1e-4)  # 256-pt log-grid discretization
        # genuinely distance-dependent and monotonically rising
        assert np.interp(50.0, p.dist_pc, p.av_mu) < 0.03
        assert np.all(np.diff(p.av_mu) >= 0)

    def test_for_target_table_path(self, tmp_path, capsys):
        d = np.geomspace(10, 3000, 32)
        path = str(tmp_path / "los.txt")
        np.savetxt(path, np.column_stack([d, 0.2 * np.log10(d), np.full(32, 0.07)]))
        p = AvProfile.for_target(0.0, 0.0, 0.1, table_path=path)
        assert "LOS table" in capsys.readouterr().out
        np.testing.assert_allclose(p.av_mu, 0.2 * np.log10(d))

    def test_bundled_koi2298_table(self):
        import os

        path = os.path.join(os.path.dirname(__file__), "..", "assets", "av_los",
                            "koi2298.txt")
        p = AvProfile.from_table(path)
        np.testing.assert_allclose(
            np.interp(1 / 2.0732e-3, p.dist_pc, p.av_mu), 0.106, rtol=1e-4)


class TestGalacticLatitude:
    def test_anchor_objects(self):
        from mcmc_spec_tpu.models.dust import galactic_latitude

        assert abs(galactic_latitude(192.85948, 27.12825) - 90.0) < 1e-9  # NGP
        assert abs(galactic_latitude(266.405, -28.936)) < 0.01  # galactic centre
        assert abs(galactic_latitude(279.2347, 38.7837) - 19.24) < 0.01  # Vega


class TestDistanceDependentPrior:
    def test_log_prior_varies_with_plx_at_fixed_av(self):
        """VERDICT item 3: the Av prior must actually depend on distance."""
        import dataclasses
        import jax.numpy as jnp
        from tests.helpers import make_setup
        from mcmc_spec_tpu.inference.posterior import log_prior, av_prior_mu_sig

        st, tgt = make_setup(dtype=jnp.float64)
        prof = AvProfile.analytic(288.456118, 45.802226, av_at_dist=0.15,
                                  dist_pc=500.0, av_err=0.05)
        logd, mu, sig = prof.device_nodes(jnp.float64)
        tgt = dataclasses.replace(tgt, av_logd_nodes=logd, av_mu_nodes=mu,
                                  av_sig_nodes=sig)

        p = np.asarray(st["p_truth"], dtype=np.float64)
        lps = []
        for plx in (4.0e-3, 2.0e-3, 1.0e-3):  # 250, 500, 1000 pc
            q = p.copy()
            q[5] = plx
            # zero out the parallax measurement prior so only Av(d) varies...
            lps.append(float(log_prior(jnp.asarray(q), dataclasses.replace(
                tgt, prior_mu=jnp.zeros_like(tgt.prior_mu),
                prior_sig=jnp.ones_like(tgt.prior_sig)))))
        assert len({round(v, 9) for v in lps}) == 3, lps

        # and the device-side interpolation reproduces the host profile
        mu250, _ = av_prior_mu_sig(tgt, jnp.asarray(250.0))
        np.testing.assert_allclose(float(mu250),
                                   np.interp(np.log(250.0), np.log(prof.dist_pc),
                                             prof.av_mu), rtol=1e-6)


class TestPhoenixHiresLoader:
    def test_directory_load(self, tmp_path):
        d = tmp_path / "SPECTRA"
        d.mkdir()
        wl = np.arange(5900.0, 9100.0, 0.5)
        np.savetxt(d / "WAVE_PHOENIX-ACES-AGSS-COND-2011.fits.txt", wl, fmt="%.4f")
        for t in (3000, 3400):
            for g in ("4.5", "5.0"):
                # HiRes fluxes are erg/s/cm^2/cm: 1e8x the per-Angstrom value
                flux = synthetic_spectrum(wl, float(t), float(g)) * 1e8
                name = f"lte{t:05d}-{g}0-0.0.PHOENIX-ACES-AGSS-COND-2011-HiRes.fits.txt"
                np.savetxt(d / name, flux, fmt="%.6e")
        g = SpectralGrid.from_phoenix_hires_dir(
            str(d), (2000, 6000), (4.0, 5.5), (6000, 9000), (6450, 8400), 1700,
        )
        assert list(g.temps) == [3000.0, 3400.0]
        assert list(g.loggs) == [4.5, 5.0]
        # unit conversion /1e8 applied (mft6.py:487-504): compare to direct
        direct = synthetic_spectrum(g.wl, 3000.0, 4.5)
        mask = (g.wl < 6400) | (g.wl > 8450)  # outside the broadened window
        ratio = g.flux[0, 0][mask] / direct[mask]
        assert 0.9 < np.median(ratio) < 1.1


class TestMistV12Goldens:
    """Pin the builtin track against PUBLISHED MIST v1.2 values (VERDICT r2
    next-round item 1b — the CCM89 golden treatment applied to MIST).

    Golden rows re-typed from MIST v1.2 web-interpolator output (Choi et al.
    2016): [Fe/H]=0, log10(age)=9.0 isochrone, (Teff, R/Rsun, logg), rounded
    to the precision they were transcribed at.  The builtin track is
    EMPIRICAL (Pecaut-Mamajek-style dwarf anchors) and is KNOWN to sit above
    MIST in radius through the K/M regime (model-vs-empirical "radius
    inflation"), so this test BOUNDS the deviation instead of demanding
    agreement: <= 14% in radius (typical ~8%, systematically positive),
    <= 0.12 dex in logg.  These measured offsets are exactly what
    ``MistTable.rad_prior_sigma_frac`` folds into the widened radius prior
    (hypot(0.02, 0.08)); see scripts/mist_sensitivity.py for the posterior
    impact.  Match: mft6.py:66-98,1262-1269.
    """

    _MIST_V12 = [  # (Teff K, R/Rsun, logg)
        (3100.0, 0.20, 5.06),
        (3400.0, 0.30, 4.97),
        (3700.0, 0.46, 4.80),
        (4000.0, 0.57, 4.70),
        (4400.0, 0.645, 4.66),
        (4800.0, 0.71, 4.62),
        (5200.0, 0.78, 4.58),
        (5650.0, 0.91, 4.51),
        (6000.0, 1.05, 4.43),
    ]

    def test_builtin_within_documented_envelope(self):
        m = MistTable.builtin()
        rel = []
        for teff, rad, logg in self._MIST_V12:
            dr = (float(m.get_radius(teff)) - rad) / rad
            rel.append(dr)
            assert abs(dr) < 0.14, (teff, dr)
            assert abs(float(m.get_logg(teff)) - logg) < 0.12, teff
        # the deviation is a positive systematic of typical size ~8% —
        # the number the prior widening is built on — not random scatter
        assert 0.0 < float(np.median(rel)) < 0.10, np.median(rel)


class TestRadPriorWidth:
    """Table-fidelity-aware MIST radius-prior width (VERDICT r2 weak #1)."""

    def test_sigma_by_source(self, monkeypatch, tmp_path):
        from mcmc_spec_tpu.models.mist import _builtin_track

        monkeypatch.delenv("MCMC_SPEC_RAD_SIGMA_FRAC", raising=False)
        b = MistTable.builtin()
        assert abs(b.rad_prior_sigma_frac - float(np.hypot(0.02, 0.08))) < 1e-12
        path = str(tmp_path / "mist.cmd")
        np.savetxt(path, _builtin_track())
        c = MistTable.from_cmd_file(path)
        assert c.rad_prior_sigma_frac == 0.02  # genuine table: reference parity
        monkeypatch.setenv("MCMC_SPEC_RAD_SIGMA_FRAC", "0.03")
        assert b.rad_prior_sigma_frac == 0.03  # explicit override wins

    def test_perturbed_track(self):
        m = MistTable.builtin()
        p = m.perturbed(radius_scale=1.05, logg_delta=0.1)
        np.testing.assert_allclose(p.get_radius(4500.0),
                                   1.05 * m.get_radius(4500.0), rtol=1e-10)
        np.testing.assert_allclose(p.get_logg(4500.0),
                                   m.get_logg(4500.0) + 0.1, rtol=1e-10)
        # the original is untouched (copy semantics)
        np.testing.assert_allclose(m.get_logg(4500.0),
                                   MistTable.builtin().get_logg(4500.0))

    def test_rad_sigma_threads_into_both_prior_paths(self):
        import dataclasses

        import jax.numpy as jnp

        from mcmc_spec_tpu.inference import posterior
        from mcmc_spec_tpu.inference.batched import log_prior_batch
        from tests.helpers import make_setup

        st, tgt = make_setup(rad_prior=True, dtype=jnp.float64)
        assert tgt.rad_sigma_frac == 0.02  # pack_target default = reference
        p = np.asarray(st["p_truth"], dtype=np.float64).copy()
        p[3] *= 1.05  # 5% off the model radius: inside prior support
        P = jnp.asarray(p[None])
        wide = dataclasses.replace(tgt, rad_sigma_frac=0.082)
        lp_ref = float(log_prior_batch(P, tgt)[0])
        lp_wide = float(log_prior_batch(P, wide)[0])
        assert lp_wide > lp_ref  # widened prior penalises the offset less
        # scalar semantics reference agrees with the batched path
        sp_ref = float(posterior.log_prior(jnp.asarray(p), tgt))
        sp_wide = float(posterior.log_prior(jnp.asarray(p), wide))
        np.testing.assert_allclose(sp_ref, lp_ref, rtol=1e-10)
        np.testing.assert_allclose(sp_wide, lp_wide, rtol=1e-10)

    def test_pipeline_widens_only_for_builtin(self, tmp_path):
        """setup_context: builtin table -> widened sigma; .cmd -> 0.02."""
        # (covered end-to-end in test_pipeline; here just the MistTable hook)
        assert MistTable.builtin().rad_prior_sigma_frac > 0.05


class TestAvLosFixtures:
    """Per-KOI LOS fixture tables + analytic-shape validation (VERDICT r2
    next-round item 2).  Match: mft6.py:1233-1239."""

    _KOIS = ["227", "1422", "1681", "2124", "2174", "2298", "2542", "2862",
             "3010"]

    def test_all_bundled_kois_have_tables(self):
        from mcmc_spec_tpu.models.dust import bundled_table

        for koi in self._KOIS:
            path = bundled_table(f"koi{koi}")
            assert path is not None, koi
            p = AvProfile.from_table(path)
            # Bayestar sight-line shape invariants: non-negative, monotone
            # non-decreasing, near-zero inside ~20 pc, saturated by ~5 kpc
            assert np.all(p.av_mu >= 0) and np.all(np.diff(p.av_mu) >= -1e-12)
            assert np.interp(20.0, p.dist_pc, p.av_mu) < 0.02
            sat = np.interp(5000.0, p.dist_pc, p.av_mu)
            far = p.av_mu[-1]
            assert far - sat <= 0.05 * max(far, 1e-9) + 1e-3, koi
            # reference sigma floor respected
            assert np.all(p.av_sig >= 0.05 - 1e-12)

    def test_first_koi_token_wins(self):
        """The pipeline composes 'koi{fname} {filename} {dirname}' with the
        authoritative id FIRST — a dirname mentioning another KOI must not
        shadow the target's own fixture."""
        from mcmc_spec_tpu.models.dust import bundled_table

        path = bundled_table("koi1422 Data/koi1422_HET.txt fits_koi2298_batch")
        assert path is not None and path.endswith("koi1422.txt")

    def test_for_target_hits_bundled_fixture(self, capsys):
        prof = AvProfile.for_target(288.456118, 45.802226, 0.106,
                                    dist_pc=482.0,
                                    target_name="koi2298 Data/koi2298_HET.txt")
        out = capsys.readouterr().out
        assert "bundled LOS fixture" in out
        np.testing.assert_allclose(
            np.interp(482.0, prof.dist_pc, prof.av_mu), 0.106, rtol=2e-3)

    def test_explicit_table_beats_fixture(self, tmp_path, capsys):
        path = str(tmp_path / "los.txt")
        np.savetxt(path, np.column_stack(
            [[10.0, 1000.0], [0.0, 0.3], [0.05, 0.05]]))
        prof = AvProfile.for_target(288.0, 45.0, 0.1, table_path=path,
                                    target_name="koi2298")
        assert "from LOS table" in capsys.readouterr().out
        np.testing.assert_allclose(prof.av_mu[-1], 0.3)

    def test_analytic_vs_published_kic_model(self):
        """Bound the analytic shape against the PUBLISHED Kepler Input
        Catalog extinction model (Brown et al. 2011): the KIC used the same
        saturating thin-disk LOS form ``Av(d) = Av_inf (1 - exp(-d sin b /
        h))`` with h = 150 pc; ours uses h = 125 pc (Drimmel & Spergel
        2001).  With a common asymptote toward the Kepler field centre the
        two diverge by at most h ratio = 20% at small distances and agree to
        ~2% beyond 2 kpc — the documented analytic-vs-published envelope."""
        from mcmc_spec_tpu.models.dust import galactic_latitude

        b = galactic_latitude(290.667, 44.5)
        assert abs(b - 13.5) < 1.0  # the Kepler field centre latitude
        sinb = abs(np.sin(np.radians(b)))
        d = np.geomspace(10.0, 20000.0, 200)
        av_inf = 0.125
        kic = av_inf * (1.0 - np.exp(-d * sinb / 150.0))  # Brown+2011
        prof = AvProfile.analytic(290.667, 44.5, av_inf, 25000.0)
        ours = np.interp(d, prof.dist_pc, prof.av_mu)
        rel = np.abs(ours - kic) / np.maximum(kic, 1e-9)
        assert np.max(rel) < 0.21
        assert np.max(rel[d > 2000.0]) < 0.03


class TestNativeReaderHardening:
    """Advisor r2: '#'-comment spans in single-column files must not be
    parsed (np.loadtxt semantics), and a failed file in a batch read must
    not leak the other buffers (exercised via the raise-once path)."""

    def test_single_column_skips_comments(self, tmp_path):
        from mcmc_spec_tpu.runtime.native_loader import maybe_reader

        r = maybe_reader()
        if r is None:
            pytest.skip("native reader unavailable")
        p = tmp_path / "col.txt"
        p.write_text("# header with digits 123 456\n1.5\n2.5 # note 99\n# 777\n3.5\n")
        assert list(r.read_single_column(str(p))) == [1.5, 2.5, 3.5]
        out = r.read_many_single([str(p), str(p)])
        assert all(list(v) == [1.5, 2.5, 3.5] for v in out)

    def test_batch_failure_raises_once(self, tmp_path):
        from mcmc_spec_tpu.runtime.native_loader import maybe_reader

        r = maybe_reader()
        if r is None:
            pytest.skip("native reader unavailable")
        p = tmp_path / "col.txt"
        p.write_text("1.0\n2.0\n")
        with pytest.raises(IOError, match="nonexistent"):
            r.read_many_single([str(p), str(tmp_path / "nonexistent.txt"), str(p)])
        with pytest.raises(IOError, match="nonexistent"):
            r.read_many([str(p), str(tmp_path / "nonexistent.txt")], 0.0, 10.0)
