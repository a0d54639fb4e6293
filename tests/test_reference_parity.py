"""Posterior parity: the JAX sampler vs a pure-numpy reference-semantics MCMC.

The strongest parity check available without the reference's external
dependencies: run the *same* synthetic target through (a) this framework's
batched stretch-move sampler and (b) a from-scratch numpy stretch-move sampler
whose log-posterior is the float64 reference emulator (tests/helpers.py, a
direct transcription of mft6.py's scoring math).  The two posteriors must
agree in their medians to well within the combined Monte-Carlo error
(BASELINE acceptance bound: 0.5 sigma).
"""
import numpy as np
import jax
import jax.numpy as jnp
import pytest

from tests.helpers import make_setup
from mcmc_spec_tpu.inference.batched import log_posterior_batch
from mcmc_spec_tpu.inference.stretch import init_ensemble, run_ensemble
from mcmc_spec_tpu.utils.health import check_ensemble_health


def numpy_stretch_mcmc(logpost, p0, n_steps, rng, a=2.0):
    """Minimal numpy affine-invariant sampler (red/black halves)."""
    coords = np.array(p0, dtype=np.float64)
    nw, ndim = coords.shape
    logp = np.array([logpost(p) for p in coords])
    nh = nw // 2
    chain = []
    for _ in range(n_steps):
        for sl, co in [(slice(0, nh), slice(nh, nw)), (slice(nh, nw), slice(0, nh))]:
            m = coords[sl].shape[0]
            z = ((a - 1.0) * rng.rand(m) + 1.0) ** 2 / a
            partners = coords[co][rng.randint(0, nw - m, m)]
            prop = partners + z[:, None] * (coords[sl] - partners)
            logp_new = np.array([logpost(p) for p in prop])
            accept = np.log(rng.rand(m)) < (ndim - 1) * np.log(z) + logp_new - logp[sl]
            coords[sl][accept] = prop[accept]
            logp[sl][accept] = logp_new[accept]
        chain.append(coords.copy())
    return np.asarray(chain)


def _run_parity(st, tgt, seed):
    emu = st["emulator"]
    truth = st["p_truth"]
    rng = np.random.RandomState(seed)

    nw = 32
    scale = np.array([60.0, 50.0, 0.02, 0.02, 0.02, 0.02e-3])
    p0 = truth + scale * rng.randn(nw, 6)

    # numpy reference-semantics chain
    ref_chain = numpy_stretch_mcmc(emu.log_posterior, p0, n_steps=400, rng=rng)
    ref_samples = ref_chain[150:].reshape(-1, 6)

    # framework chain (more steps: it is ~free)
    logp = lambda b: log_posterior_batch(b, tgt)
    state = init_ensemble(jnp.asarray(p0), logp, jax.random.PRNGKey(seed))
    state, chain, logps = run_ensemble(state, logp, n_steps=1200, thin=2)
    dev_samples = np.asarray(chain[300:]).reshape(-1, 6)

    health = check_ensemble_health(np.asarray(chain), np.asarray(logps))
    assert health["n_stuck_walkers"] == 0

    ref_med = np.median(ref_samples, axis=0)
    dev_med = np.median(dev_samples, axis=0)
    ref_sig = ref_samples.std(axis=0)
    dev_sig = dev_samples.std(axis=0)

    for i, name in enumerate(["T1", "T2", "Av", "R1", "R2/R1", "plx"]):
        sig = max(ref_sig[i], dev_sig[i])
        diff = abs(dev_med[i] - ref_med[i])
        assert diff < 0.5 * sig + 1e-12, (
            f"{name}: median diff {diff:.4g} vs 0.5*sigma {0.5 * sig:.4g} "
            f"(ref {ref_med[i]:.5g}, jax {dev_med[i]:.5g})"
        )
        # posterior widths should also agree to ~50%
        assert 0.5 < (dev_sig[i] / ref_sig[i]) < 2.0, name


@pytest.mark.parametrize("seed", [0])
def test_posterior_medians_match_reference_emulator(seed):
    st, tgt = make_setup(dtype=jnp.float64)
    _run_parity(st, tgt, seed)


def test_parity_with_mist_radius_prior():
    """Same 0.5-sigma loop with rad_prior on: exercises the MIST radius
    prior end to end against the emulator's transcription (both at the
    reference's exact 2% width — pack_target's default)."""
    st, tgt = make_setup(rad_prior=True, dtype=jnp.float64)
    assert tgt.rad_sigma_frac == 0.02
    _run_parity(st, tgt, seed=3)


def test_parity_nospec_mode():
    """Same loop in mft6_nospec.py mode (spectrum term dropped, tightened
    1/100 parallax cap): photometry+contrast-only posteriors must agree."""
    st, tgt = make_setup(spectrum_weight=0.0, dtype=jnp.float64)
    _run_parity(st, tgt, seed=5)
