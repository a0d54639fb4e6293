"""End-to-end posterior impact of the fast-median dial.

The radix-select median's pass count (``MCMC_SPEC_FAST_MEDIAN`` /
``PackedTarget.median_iters``) trades spectrum-scale accuracy for sampler
throughput.  This script measures what matters — posterior median/sigma
shifts — by running the koi2298-shaped synthetic-truth fit end-to-end at
31/25/20 passes with identical RNG and diffing the marginals.

Run on a GPU:
    python scripts/fast_median_impact.py

Only the count-median lane honours the dial, and the GPU takes it beyond
``flags.LARGE_ND`` data points; the sort lane (every other case) is exact at
every setting.  So the target spans the koi2298 wavelength range at
nd = 2 x LARGE_ND.

Decision rule: if the 25-pass and
20-pass shifts are well below 0.1 of the posterior sigma on every parameter,
the fast mode is a safe default; otherwise exact stays default.
"""
from __future__ import annotations

import dataclasses
import sys
import time

import jax
import jax.numpy as jnp
import numpy as np

sys.path.insert(0, ".")

from mcmc_spec_tpu.bench_target import build_bench_target, init_walker_batch
from mcmc_spec_tpu.inference.batched import log_posterior_batch
from mcmc_spec_tpu.inference.stretch import init_ensemble, run_ensemble
from mcmc_spec_tpu.utils.flags import LARGE_ND

NWALK = 2048
NBURN = 3000
NSTEPS = 6000
LABELS = ["T1", "T2", "Av", "R1", "R2/R1", "plx"]


def run_chain(tgt, truth, iters):
    t = dataclasses.replace(tgt, median_iters=iters)
    logp = lambda b: log_posterior_batch(b, t)
    coords = init_walker_batch(t, truth, NWALK, jnp.float32)
    state = init_ensemble(coords, logp, jax.random.PRNGKey(7))
    t0 = time.perf_counter()
    state, _, _ = run_ensemble(state, logp, n_steps=NBURN, thin=NBURN)
    _, chain, _ = run_ensemble(state, logp, n_steps=NSTEPS, thin=8)
    chain = np.asarray(chain).reshape(-1, len(LABELS))
    print(f"  iters={iters}: {NWALK*(NBURN+NSTEPS)/(time.perf_counter()-t0)/1e6:.1f}M evals/s "
          f"(incl. compile)", flush=True)
    return chain


def main():
    print(f"devices: {jax.devices()}", flush=True)
    tgt, truth = build_bench_target(jnp.float32, nd=2 * LARGE_ND)
    chains = {it: run_chain(tgt, truth, it) for it in (31, 14, 12)}

    base = chains[31]
    med0, sig0 = np.median(base, axis=0), base.std(axis=0)
    print(f"\ntruth:          {np.array2string(np.asarray(truth), precision=4)}")
    print(f"exact medians:  {np.array2string(med0, precision=4)}")
    print(f"exact sigmas:   {np.array2string(sig0, precision=4)}")
    for it in (14, 12):
        med = np.median(chains[it], axis=0)
        sig = chains[it].std(axis=0)
        shift = (med - med0) / sig0
        sratio = sig / sig0
        print(f"\niters={it}:")
        for i, lab in enumerate(LABELS):
            print(f"  {lab:>6}: median shift {shift[i]:+.3f} sigma, "
                  f"sigma ratio {sratio[i]:.3f}")
        print(f"  max |shift| = {np.max(np.abs(shift)):.3f} sigma")


if __name__ == "__main__":
    main()
