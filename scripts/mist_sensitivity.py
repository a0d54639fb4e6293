"""Posterior-impact study of the builtin-MIST table systematic.

The builtin isochrone substitute deviates from
genuine MIST v1.2 by a ~+8% typical radius systematic (tests/test_models.py::
TestMistV12Goldens), while the reference's radius prior holds walkers to 2% of
the model radius (mft6.py:1268).  This script measures, on the synthetic-truth
fixture with ``rad_prior`` on, how far the posterior medians move when the
table carries that systematic — at the reference prior width (0.02) and at the
table-fidelity-widened width (hypot(0.02, 0.08) ~= 0.082) which
``MistTable.rad_prior_sigma_frac`` now applies automatically for the builtin
table.

Run: ``python scripts/mist_sensitivity.py [n_steps]`` (CPU, ~2 min).
Measured numbers are recorded in PARITY.md ("MIST radius prior" section).
"""
from __future__ import annotations

import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))
os.environ.setdefault("JAX_PLATFORMS", "cpu")

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)

from tests.helpers import make_setup  # noqa: E402

from mcmc_spec_tpu.inference.batched import log_posterior_batch  # noqa: E402
from mcmc_spec_tpu.inference.stretch import init_ensemble, run_ensemble  # noqa: E402
from mcmc_spec_tpu.inference.target import pack_target  # noqa: E402

LABELS = ["T1", "T2", "Av", "R1", "R2/R1", "plx"]


def _repack(st, mist, rad_sigma_frac):
    return pack_target(
        st["grid"], st["data_wl_um"], st["data_flux"], st["data_err"],
        st["cfilts"], st["cmag"], st["cerr"], st["pfilts"], st["zps"],
        st["pmag"], st["perr"], mist, st["av_profile"],
        nspec=2, dist_fit=True, rad_prior=True, dtype=jnp.float64,
        rad_sigma_frac=rad_sigma_frac,
    )


def _run_chain(tgt, p_truth, n_steps, n_walkers=24, seed=0):
    rng = np.random.RandomState(seed)
    p0 = jnp.asarray(
        np.stack([p_truth * (1 + 0.01 * rng.randn(6)) for _ in range(n_walkers)]),
        jnp.float64,
    )
    logp = lambda b: log_posterior_batch(b, tgt)
    state = init_ensemble(p0, logp, jax.random.PRNGKey(seed))
    state, _, _ = run_ensemble(state, logp, n_steps=n_steps // 3, thin=n_steps // 3)
    _, chain, _ = run_ensemble(state, logp, n_steps=n_steps, thin=2)
    return np.asarray(chain).reshape(-1, 6)


def main(n_steps: int = 1200):
    st, _ = make_setup(rad_prior=True, dtype=jnp.float64)
    p_truth = np.asarray(st["p_truth"], dtype=np.float64)
    mist = st["mist"]

    variants = {
        "baseline (true table, sigma=0.02)": (mist, 0.02),
        "table +8% R, sigma=0.02 (reference width)": (mist.perturbed(radius_scale=1.08), 0.02),
        "table +8% R, sigma=0.082 (widened)": (mist.perturbed(radius_scale=1.08), 0.082),
    }
    chains = {}
    for name, (m, sig) in variants.items():
        chains[name] = _run_chain(_repack(st, m, sig), p_truth, n_steps)

    base = chains["baseline (true table, sigma=0.02)"]
    med0 = np.median(base, axis=0)
    sig0 = base.std(axis=0)
    print(f"truth:   {np.array2string(p_truth, precision=4)}")
    print(f"baseline medians: {np.array2string(med0, precision=4)}  "
          f"sigma: {np.array2string(sig0, precision=4)}")
    for name, ch in chains.items():
        if ch is base:
            continue
        med = np.median(ch, axis=0)
        sig = ch.std(axis=0)
        shift = (med - med0) / sig0        # bias vs the unbiased posterior
        shift_own = (med - med0) / sig     # bias in the variant's OWN quoted
        print(f"\n{name}")                 # sigma: is the error bar honest?
        for i, lab in enumerate(LABELS):
            print(f"  {lab:>6}: median {med[i]:.5g}  shift {shift[i]:+.2f} "
                  f"baseline-sigma  ({shift_own[i]:+.2f} own-sigma)")
        print(f"  max |shift| = {np.max(np.abs(shift)):.2f} baseline-sigma, "
              f"{np.max(np.abs(shift_own)):.2f} own-sigma")


if __name__ == "__main__":
    main(int(sys.argv[1]) if len(sys.argv) > 1 else 1200)
