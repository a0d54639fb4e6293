"""Batched (production) posterior must match the scalar reference path."""
import numpy as np
import jax
import jax.numpy as jnp
import pytest

from tests.helpers import make_setup
from mcmc_spec_tpu.inference import posterior as scalar
from mcmc_spec_tpu.inference import batched
from mcmc_spec_tpu.ops.interp import pwl_interp, tent_weights


class TestTentWeights:
    def test_matches_np_interp(self):
        rng = np.random.RandomState(0)
        xs = np.sort(rng.uniform(0, 10, 17))
        ys = rng.randn(17)
        q = rng.uniform(-2, 12, 200)  # includes out-of-range (clamped)
        got = np.asarray(pwl_interp(jnp.asarray(xs), jnp.asarray(ys), jnp.asarray(q)))
        np.testing.assert_allclose(got, np.interp(q, xs, ys), rtol=1e-12, atol=1e-12)

    def test_weights_sum_to_one(self):
        xs = jnp.asarray(np.linspace(0, 1, 9))
        q = jnp.asarray(np.linspace(-0.5, 1.5, 101))
        w = np.asarray(tent_weights(xs, q))
        np.testing.assert_allclose(w.sum(axis=-1), 1.0, rtol=1e-12)

    def test_two_node_edge_case(self):
        xs = jnp.asarray([0.0, 1.0])
        ys = jnp.asarray([2.0, 4.0])
        q = jnp.asarray([-1.0, 0.0, 0.5, 1.0, 2.0])
        got = np.asarray(pwl_interp(xs, ys, q))
        np.testing.assert_allclose(got, [2.0, 2.0, 3.0, 4.0, 4.0])


@pytest.fixture(scope="module", params=[False, True], ids=["plain", "rad_prior"])
def setup(request):
    return make_setup(rad_prior=request.param, dtype=jnp.float64)


def _batch_near_truth(st, n=32, seed=7, frac_oob=0.25):
    rng = np.random.RandomState(seed)
    p = st["p_truth"]
    out = []
    for i in range(n):
        q = p.copy()
        q[0] += rng.uniform(-300, 300)
        q[1] += rng.uniform(-250, 250)
        q[2] = q[2] + rng.uniform(-0.1, 0.1)
        q[3] *= rng.uniform(0.8, 1.2)
        q[4] *= rng.uniform(0.8, 1.2)
        q[5] *= rng.uniform(0.9, 1.1)
        if rng.rand() < frac_oob:  # deliberately out of bounds
            q[rng.randint(6)] = [9000.0, 500.0, -0.5, 0.01, 2.5, 1e-5][rng.randint(6)]
        out.append(q)
    return jnp.asarray(np.stack(out))


class TestBatchedEquivalence:
    def test_log_likelihood(self, setup):
        st, tgt = setup
        P = _batch_near_truth(st, frac_oob=0.0)
        got = np.asarray(batched.log_likelihood_batch(P, tgt))
        exp = np.asarray(jax.vmap(lambda p: scalar.log_likelihood(p, tgt))(P))
        np.testing.assert_allclose(got, exp, rtol=1e-9, atol=1e-9)

    def test_log_prior(self, setup):
        st, tgt = setup
        P = _batch_near_truth(st, frac_oob=0.4)
        got = np.asarray(batched.log_prior_batch(P, tgt))
        exp = np.asarray(jax.vmap(lambda p: scalar.log_prior(p, tgt))(P))
        finite = np.isfinite(exp)
        np.testing.assert_array_equal(np.isfinite(got), finite)
        np.testing.assert_allclose(got[finite], exp[finite], rtol=1e-9, atol=1e-9)

    def test_log_posterior(self, setup):
        st, tgt = setup
        P = _batch_near_truth(st, frac_oob=0.4)
        got = np.asarray(batched.log_posterior_batch(P, tgt))
        exp = np.asarray(jax.vmap(lambda p: scalar.log_posterior(p, tgt))(P))
        finite = np.isfinite(exp)
        np.testing.assert_array_equal(np.isfinite(got), finite)
        np.testing.assert_allclose(got[finite], exp[finite], rtol=1e-9, atol=1e-9)

    def test_optimizer_chi2(self, setup):
        st, tgt = setup
        P = _batch_near_truth(st, frac_oob=0.0)
        rad_sigma = 0.1 * np.abs(np.asarray(P[:, 3:5]))
        got = np.asarray(batched.optimizer_chi2_batch(P, tgt, jnp.asarray(rad_sigma)))
        exp = np.asarray(
            jax.vmap(lambda p, s: scalar.optimizer_chi2(p, tgt, rad_sigma=s))(
                P, jnp.asarray(rad_sigma)
            )
        )
        np.testing.assert_allclose(got, exp, rtol=1e-9)

    def test_forward_pieces(self, setup):
        st, tgt = setup
        P = _batch_near_truth(st, frac_oob=0.0)
        model, contrasts, phot, scales, _ = batched.forward_batch(P, tgt)
        for i in range(4):
            out = scalar.forward(P[i], tgt)
            np.testing.assert_allclose(np.asarray(model[i]), np.asarray(out.model_data),
                                       rtol=1e-9)
            np.testing.assert_allclose(np.asarray(contrasts[i]), np.asarray(out.contrasts),
                                       rtol=1e-9, atol=1e-12)
            np.testing.assert_allclose(np.asarray(phot[i]), np.asarray(out.phot_mags),
                                       rtol=1e-9)

    def test_nospec_mode(self):
        st, tgt = make_setup(spectrum_weight=0.0, dtype=jnp.float64)
        P = _batch_near_truth(st, n=8, frac_oob=0.0)
        got = np.asarray(batched.log_likelihood_batch(P, tgt))
        exp = np.asarray(jax.vmap(lambda p: scalar.log_likelihood(p, tgt))(P))
        np.testing.assert_allclose(got, exp, rtol=1e-9)


class TestAlphaSquaredFactorization:
    """Structural pin of the fast-median harmlessness argument (VERDICT r3
    weak #2): on the renorm path the median enters the spectrum chi^2 ONLY
    through the global per-walker scale alpha = med_data/median(model).  The
    deg-2 continuum fit is linear, so scaling alpha by c scales ``fitted`` by
    1/c, ``data_renorm`` by c, the whole residual by c, and

        chi_spec(c * alpha) = c^2 * chi_spec(alpha)        exactly.

    A relative median error eps is therefore EXACTLY a (1+eps)^-2 ~ (1-2eps)
    multiplicative reweighting (tempering) of the spectrum term — never a
    per-point bias.  With c a power of two every float op scales exactly, so
    the identity must hold BIT-FOR-BIT end to end; c=1.5 pins the algebra at
    float64 rounding.  (The annealer's renorm=False path is different: there
    the median error hits the residual directly — see
    TestMedianOnlyNoFactorization.)
    """

    def _chi(self, tgt, med_scale):
        import dataclasses

        st = self._st
        P = _batch_near_truth(st, n=8, frac_oob=0.0)
        t = dataclasses.replace(tgt, med_data=tgt.med_data * med_scale)
        _, _, _, _, Wcomb = batched._forward_small(P, t)
        return np.asarray(batched._spec_chi2_xla(Wcomb, P[:, 2], t))

    def test_xla_power_of_two_exact(self):
        self._st, tgt = make_setup(dtype=jnp.float64)
        base = self._chi(tgt, 1.0)
        np.testing.assert_array_equal(self._chi(tgt, 2.0), 4.0 * base)
        np.testing.assert_array_equal(self._chi(tgt, 0.25), 0.0625 * base)

    def test_xla_generic_scale(self):
        self._st, tgt = make_setup(dtype=jnp.float64)
        base = self._chi(tgt, 1.0)
        np.testing.assert_allclose(self._chi(tgt, 1.5), 2.25 * base, rtol=1e-12)

    def test_count_lane_power_of_two_exact_all_dials(self):
        """The count-median lane is exactly 2-homogeneous even through the
        fast bit-search median (its bracket boundaries are aligned, so an
        exponent step shifts them exactly) — at BOTH the exact and the
        production-fast pass counts."""
        from mcmc_spec_tpu.ops.spec_segmented import spectrum_chi2_segmented

        st, tgt = make_setup(dtype=jnp.float32)
        P = jnp.asarray(np.asarray(_batch_near_truth(st, n=8, frac_oob=0.0)),
                        jnp.float32)
        _, _, _, _, Wcomb = batched._forward_small(P, tgt)
        nT, nG, nd = tgt.D.shape
        args = (Wcomb, P[:, 2], tgt.D.reshape(nT * nG, nd), tgt.ext_k_data,
                tgt.data_flux, tgt.data_err, tgt.V, tgt.Vpinv)
        for iters in (31, 16, 12):
            base = np.asarray(spectrum_chi2_segmented(
                *args, tgt.med_data, tgt.n_data_true, iters=iters))
            doubled = np.asarray(spectrum_chi2_segmented(
                *args, tgt.med_data * 2.0, tgt.n_data_true, iters=iters))
            np.testing.assert_array_equal(doubled, 4.0 * base)

    def test_median_only_no_factorization(self):
        """Contrast pin: on the annealer's renorm=False path the scale error
        does NOT factor out — chi(2*med) != 4*chi(med) — so the fast-median
        accuracy budget there must be argued from the direct residual
        perturbation, not the tempering frame."""
        import dataclasses

        st, tgt = make_setup(dtype=jnp.float64)
        P = _batch_near_truth(st, n=8, frac_oob=0.0)
        t2 = dataclasses.replace(tgt, med_data=tgt.med_data * 2.0)
        _, _, _, _, Wcomb = batched._forward_small(P, tgt)
        base = np.asarray(batched._spec_chi2_xla_median_only(Wcomb, P[:, 2], tgt))
        doubled = np.asarray(batched._spec_chi2_xla_median_only(Wcomb, P[:, 2], t2))
        assert not np.allclose(doubled, 4.0 * base, rtol=1e-3)
