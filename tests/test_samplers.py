"""Sampler correctness: stretch-move statistics, annealer descent, sharding."""
import numpy as np
import jax
import jax.numpy as jnp
import pytest

from mcmc_spec_tpu.inference.stretch import (
    EnsembleState,
    init_ensemble,
    run_ensemble,
    acceptance_fraction,
)
from mcmc_spec_tpu.inference.anneal import run_anneal, init_walkers
from mcmc_spec_tpu.inference.posterior import optimizer_chi2
from mcmc_spec_tpu.inference.batched import log_posterior_batch, optimizer_chi2_batch
from mcmc_spec_tpu.parallel.mesh import make_mesh
from mcmc_spec_tpu.parallel.sharding import shard_ensemble_state, run_ensemble_sharded
from tests.helpers import make_setup


class TestStretchOnGaussian:
    """The sampler must reproduce a known 3-D correlated Gaussian."""

    cov = np.array([[1.0, 0.5, 0.0], [0.5, 2.0, 0.3], [0.0, 0.3, 0.5]])
    mean = np.array([1.0, -2.0, 0.5])

    def _logp(self):
        icov = jnp.asarray(np.linalg.inv(self.cov))
        mu = jnp.asarray(self.mean)

        def logp(batch):
            d = batch - mu
            return -0.5 * jnp.einsum("ni,ij,nj->n", d, icov, d)

        return logp

    def test_recovers_moments(self):
        logp = self._logp()
        key = jax.random.PRNGKey(0)
        nw = 64
        coords = self.mean + 0.1 * jax.random.normal(key, (nw, 3))
        state = init_ensemble(coords, logp, jax.random.PRNGKey(1))
        state, chain, _ = run_ensemble(state, logp, n_steps=3000, thin=1)
        samples = np.asarray(chain[500:]).reshape(-1, 3)  # burn-in discard
        np.testing.assert_allclose(samples.mean(axis=0), self.mean, atol=0.15)
        np.testing.assert_allclose(np.cov(samples.T), self.cov, atol=0.35)

    def test_acceptance_fraction_reasonable(self):
        logp = self._logp()
        nw = 64
        coords = self.mean + jax.random.normal(jax.random.PRNGKey(2), (nw, 3))
        state = init_ensemble(coords, logp, jax.random.PRNGKey(3))
        n_steps = 500
        state, _, _ = run_ensemble(state, logp, n_steps=n_steps)
        af = float(acceptance_fraction(state, n_steps))
        assert 0.2 < af < 0.8  # healthy stretch-move range

    def test_thinning_shapes(self):
        logp = self._logp()
        coords = jnp.zeros((16, 3)) + jnp.asarray(self.mean)
        state = init_ensemble(coords, logp, jax.random.PRNGKey(4))
        _, chain, logps = run_ensemble(state, logp, n_steps=100, thin=10)
        assert chain.shape == (10, 16, 3)
        assert logps.shape == (10, 16)


class TestStretchSharded:
    def test_matches_gaussian_on_mesh(self):
        mesh = make_mesh(4, ("walkers",))
        cov = TestStretchOnGaussian.cov
        mean = TestStretchOnGaussian.mean
        icov = jnp.asarray(np.linalg.inv(cov))
        mu = jnp.asarray(mean)

        def logp(batch):
            d = batch - mu
            return -0.5 * jnp.einsum("ni,ij,nj->n", d, icov, d)

        nw = 64
        coords = mean + 0.2 * jax.random.normal(jax.random.PRNGKey(5), (nw, 3))
        state = shard_ensemble_state(coords, logp, jax.random.PRNGKey(6), mesh)
        state, chain, _ = run_ensemble_sharded(state, logp, mesh, n_steps=2000, thin=1)
        samples = np.asarray(chain[400:]).reshape(-1, 3)
        np.testing.assert_allclose(samples.mean(axis=0), mean, atol=0.2)
        np.testing.assert_allclose(np.cov(samples.T), cov, atol=0.45)


class TestAnnealer:
    @pytest.fixture(scope="class")
    def setup(self):
        return make_setup(dtype=jnp.float64)

    def test_chi2_descends(self, setup):
        st, tgt = setup
        key = jax.random.PRNGKey(7)
        p0 = init_walkers(tgt, 16, st["truth"]["plx"], 0.1e-3, key)
        chi0 = optimizer_chi2_batch(p0, tgt)
        params, chi, _ = run_anneal(tgt, p0, jax.random.PRNGKey(8), steps=60)
        assert params.shape == p0.shape
        # every walker improved (chi is monotone non-increasing by construction)
        assert np.all(np.asarray(chi) <= np.asarray(chi0) + 1e-9)
        assert np.median(np.asarray(chi)) < 0.5 * np.median(np.asarray(chi0))

    def test_best_walker_near_truth(self, setup):
        st, tgt = setup
        p0 = init_walkers(tgt, 48, st["truth"]["plx"], 0.1e-3, jax.random.PRNGKey(9))
        params, chi, _ = run_anneal(tgt, p0, jax.random.PRNGKey(10), steps=150)
        best = np.asarray(params)[np.argmin(np.asarray(chi))]
        truth = st["p_truth"]
        assert abs(best[0] - truth[0]) < 400  # T1 within 400K
        assert abs(best[1] - truth[1]) < 400  # T2

    def test_init_walkers_respects_ordering(self, setup):
        st, tgt = setup
        p0 = np.asarray(init_walkers(tgt, 200, 2e-3, 0.1e-3, jax.random.PRNGKey(11)))
        assert np.all(p0[:, 1] <= p0[:, 0])  # T2 <= T1
        assert np.all(p0[:, 2] >= 0.1) and np.all(p0[:, 2] <= 0.5)  # Av
        assert np.all(p0[:, 4] <= 1.0)  # ratio < 1
        assert np.all(p0[:, 5] > 0)  # plx positive

    def test_trace_recording(self, setup):
        st, tgt = setup
        p0 = init_walkers(tgt, 8, 2e-3, 0.1e-3, jax.random.PRNGKey(12))
        params, chi, trace = run_anneal(tgt, p0, jax.random.PRNGKey(13), steps=20,
                                        record_thin=100)
        tp, tc = trace
        assert tp.shape == (10, 8, 6)  # 50*20/100 snapshots
        assert tc.shape == (10, 8)


class TestEndToEndPosterior:
    def test_mcmc_recovers_truth(self):
        """Anneal -> seed -> stretch MCMC; medians should bracket the truth."""
        st, tgt = make_setup(dtype=jnp.float64)
        truth = st["p_truth"]
        p0 = init_walkers(tgt, 64, st["truth"]["plx"], 0.05e-3, jax.random.PRNGKey(20))
        params, chi, _ = run_anneal(tgt, p0, jax.random.PRNGKey(21), steps=100)
        # top-1/3 seeding (mft6.py:3668-3674)
        order = np.argsort(np.asarray(chi))
        seeds = np.asarray(params)[order[: len(order) // 3]]
        # jitter duplicates slightly so the ensemble is non-degenerate
        rng = np.random.RandomState(0)
        seeds = seeds * (1 + 1e-4 * rng.randn(*seeds.shape))
        logp = lambda batch: log_posterior_batch(batch, tgt)
        state = init_ensemble(jnp.asarray(seeds), logp, jax.random.PRNGKey(22))
        state, chain, _ = run_ensemble(state, logp, n_steps=1500, thin=5)
        samples = np.asarray(chain[100:]).reshape(-1, 6)
        med = np.median(samples, axis=0)
        sig = samples.std(axis=0)
        # posterior medians within 4 sigma-posterior of truth (noisy data)
        for i in range(6):
            assert abs(med[i] - truth[i]) < 4 * sig[i] + 1e-12, (i, med[i], truth[i], sig[i])


class TestAnnealerExactMedianPin:
    """Stage-1 scoring always uses the exact median (round 4): the
    renorm=False path has no alpha^2 protection, so the fast-median dial
    must never reach it (scripts/median_tempering_bound_cpu.py measured
    max 1.27 weighted-chi units of direct error at the 16-pass dial)."""

    def test_optimizer_chi2_swaps_to_exact(self, monkeypatch):
        import dataclasses

        from mcmc_spec_tpu.inference import batched
        from tests.helpers import make_setup

        st, tgt = make_setup(dtype=jnp.float64)
        seen = {}
        real = batched.chi2_total_batch

        def spy(p, t, **kw):
            seen["median_iters"] = t.median_iters
            return real(p, t, **kw)

        monkeypatch.setattr(batched, "chi2_total_batch", spy)
        p = jnp.asarray(np.stack([st["p_truth"]] * 4), jnp.float64)
        # production-dialed target: the swap must restore 31 for stage 1
        fast = dataclasses.replace(tgt, median_iters=14)
        batched.optimizer_chi2_batch(p, fast)
        assert seen["median_iters"] == 31
        # unset (0) stays unset (the lanes read 0 as exact)
        unset = dataclasses.replace(tgt, median_iters=0)
        batched.optimizer_chi2_batch(p, unset)
        assert seen["median_iters"] == 0
