#!/usr/bin/env python
"""End-to-end example: generate a synthetic binary observation and fit it.

Self-contained (no external model grids or filter files needed): builds the
analytic model grid, synthesises a noisy composite observation at known truth
parameters, runs both fit stages, and renders a posterior summary.

    python examples/fit_synthetic_binary.py [outdir]
"""
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import jax
import jax.numpy as jnp
import numpy as np

from mcmc_spec_tpu.bench_target import TRUTH, build_bench_target, init_walker_batch
from mcmc_spec_tpu.inference.anneal import init_walkers, run_anneal
from mcmc_spec_tpu.inference.batched import log_posterior_batch
from mcmc_spec_tpu.inference.sampler_api import EnsembleSampler
from mcmc_spec_tpu.report.corner_plot import corner_plot


def main(outdir="example_out"):
    os.makedirs(outdir, exist_ok=True)
    # f32 on an accelerator; f64 where the CPU runs it
    dtype = jnp.float64 if jax.default_backend() == "cpu" else jnp.float32
    print(f"building synthetic target (backend={jax.default_backend()})...")
    tgt, truth = build_bench_target(dtype, grid_step=4.0)

    print("stage 1: annealing 150 walkers...")
    p0 = init_walkers(tgt, 150, truth[-1], 0.05e-3, jax.random.PRNGKey(0))
    params, chi, _ = run_anneal(tgt, p0, jax.random.PRNGKey(1), steps=200)
    chi = np.asarray(chi)
    print(f"  best chi2: {chi.min():.2f}")

    print("stage 2: stretch-move MCMC, 50 walkers x 3000 steps...")
    seeds = np.asarray(params)[np.argsort(chi)[:50]]
    seeds = seeds * (1 + 1e-5 * np.random.RandomState(0).randn(*seeds.shape))
    sampler = EnsembleSampler(50, 6, lambda b: log_posterior_batch(b, tgt), seed=2)
    sampler.run_mcmc(seeds, 3000, thin_by=3)
    samples = sampler.get_chain(flat=True, discard=200)
    print(f"  acceptance: {sampler.acceptance_fraction[0]:.3f}")
    print(f"  autocorr times: {np.round(sampler.get_autocorr_time(), 1)}")

    names = ["T1", "T2", "Av", "R1", "R2/R1", "plx"]
    print(f"{'param':7s} {'truth':>10s} {'median':>10s} {'68% interval':>24s}")
    for i, n in enumerate(names):
        q16, q50, q84 = np.percentile(samples[:, i], [16, 50, 84])
        print(f"{n:7s} {truth[i]:10.4g} {q50:10.4g}      [{q16:9.4g},{q84:9.4g}]")

    corner_plot(
        samples,
        labels=names,
        title_fmts=[".0f", ".0f", ".3f", ".3f", ".3f", ".5f"],
        truths=truth,
        out_path=os.path.join(outdir, "corner.pdf"),
    )
    print(f"wrote {outdir}/corner.pdf")


if __name__ == "__main__":
    main(*sys.argv[1:2])
