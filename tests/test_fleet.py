"""Fleet mode: padded stacked targets must reproduce per-target results."""
import dataclasses

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from tests.helpers import make_setup, gaussian_filter_curve
from mcmc_spec_tpu.inference import batched
from mcmc_spec_tpu.inference.fleet import (
    init_fleet_ensemble,
    log_posterior_fleet,
    run_fleet_ensemble,
    stack_targets,
)
from mcmc_spec_tpu.inference.target import pack_target
from mcmc_spec_tpu.models.dust import AvProfile
from mcmc_spec_tpu.models.mist import MistTable
from mcmc_spec_tpu.models.synthetic import synthetic_grid
from mcmc_spec_tpu.ops.photometry import ab_zero_flux, photon_flux_weights


def _make_target(nd, ncontrast, seed, pad_nd=None, pad_nc=None, dtype=jnp.float64):
    """Small target with nd data points and ncontrast contrast filters."""
    rng = np.random.RandomState(seed)
    grid = synthetic_grid(
        specrange=(3000.0, 12000.0), data_window=(6450.0, 8400.0), resolution=1700,
        temps=np.arange(3000.0, 5801.0, 400.0), loggs=np.array([4.0, 4.5, 5.0, 5.5]),
        step=4.0,
    )
    mist = MistTable.builtin()
    data_wl_um = np.linspace(0.652, 0.838, nd)
    comp = grid.interp_spectrum(4500.0, 4.6) * 1e-21 + grid.interp_spectrum(3400.0, 5.0) * 2e-22
    flux = np.interp(data_wl_um * 1e4, grid.wl, comp)
    flux *= 1 + 0.01 * rng.randn(nd)
    err = 0.01 * np.abs(flux)
    med = np.median(flux)
    flux, err = flux / med, err / med

    cfilts = [gaussian_filter_curve(f"c{i}", 6000.0 + 800.0 * i, 120.0)
              for i in range(ncontrast)]
    pfilts = [gaussian_filter_curve("p_r", 6250.0, 300.0),
              gaussian_filter_curve("p_i", 7700.0, 350.0),
              gaussian_filter_curve("p_z", 9100.0, 400.0)]
    zps = []
    for f in pfilts:
        _, lp = photon_flux_weights(grid.wl, f.wl, f.tr)
        zps.append(ab_zero_flux(lp))
    prior_mu = np.zeros(6)
    prior_sig = np.ones(6)
    prior_mu[-1] = 2e-3
    prior_sig[-1] = 0.05e-3
    return pack_target(
        grid, data_wl_um, flux, err,
        cfilts, np.full(ncontrast, 2.0), np.full(ncontrast, 0.05),
        pfilts, zps, np.array([14.0, 13.5, 13.2]), np.full(3, 0.05),
        mist, AvProfile.constant(0.12, 0.05),
        prior_mu=prior_mu, prior_sig=prior_sig,
        dtype=dtype, pad_nd=pad_nd, pad_nc=pad_nc,
    )


def _walkers(n, seed=0):
    rng = np.random.RandomState(seed)
    base = np.array([4500.0, 3400.0, 0.12, 0.7, 0.45, 2e-3])
    scale = np.array([80.0, 60.0, 0.02, 0.02, 0.02, 0.03e-3])
    return jnp.asarray(base + scale * rng.randn(n, 6))


class TestPadding:
    def test_padded_equals_unpadded(self):
        """Padding must not change the posterior value at all."""
        t_plain = _make_target(nd=300, ncontrast=2, seed=1)
        t_padded = _make_target(nd=300, ncontrast=2, seed=1, pad_nd=400, pad_nc=4)
        assert t_padded.n_data == 400 and int(t_padded.n_data_true) == 300
        P = _walkers(16)
        a = np.asarray(batched.log_posterior_batch(P, t_plain))
        b = np.asarray(batched.log_posterior_batch(P, t_padded))
        np.testing.assert_allclose(a, b, rtol=1e-10)

    def test_optimizer_chi2_padded(self):
        t_plain = _make_target(nd=300, ncontrast=2, seed=1)
        t_padded = _make_target(nd=300, ncontrast=2, seed=1, pad_nd=380, pad_nc=3)
        P = _walkers(8)
        a = np.asarray(batched.optimizer_chi2_batch(P, t_plain))
        b = np.asarray(batched.optimizer_chi2_batch(P, t_padded))
        np.testing.assert_allclose(a, b, rtol=1e-10)


class TestFleet:
    @pytest.fixture(scope="class")
    def fleet3(self):
        """Three ragged targets padded to common shapes."""
        specs = [(300, 2, 11), (360, 3, 12), (240, 1, 13)]
        nd_max = max(s[0] for s in specs)
        nc_max = max(s[1] for s in specs)
        singles = [_make_target(nd, nc, seed) for nd, nc, seed in specs]
        padded = [_make_target(nd, nc, seed, pad_nd=nd_max, pad_nc=nc_max)
                  for nd, nc, seed in specs]
        return singles, stack_targets(padded)

    def test_fleet_matches_singles(self, fleet3):
        singles, fleet = fleet3
        P = jnp.stack([_walkers(12, seed=i) for i in range(3)])  # [3, 12, 6]
        got = np.asarray(log_posterior_fleet(P, fleet))
        for i, tgt in enumerate(singles):
            exp = np.asarray(batched.log_posterior_batch(P[i], tgt))
            np.testing.assert_allclose(got[i], exp, rtol=1e-10, err_msg=f"target {i}")

    def test_fleet_sampling(self, fleet3):
        _, fleet = fleet3
        coords = jnp.stack([_walkers(16, seed=10 + i) for i in range(3)])
        state = init_fleet_ensemble(coords, fleet, jax.random.PRNGKey(0))
        state, chain, logps = run_fleet_ensemble(state, fleet, n_steps=50, thin=10)
        assert chain.shape == (5, 3, 16, 6)
        assert np.all(np.isfinite(np.asarray(logps)[-1]))
        # the ensembles actually move
        assert not np.allclose(np.asarray(chain[-1]), np.asarray(coords))
