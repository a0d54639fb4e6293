"""CPU computation of the fast-median ΔL tempering distribution (round 4).

The α² factorization (PARITY.md §"Why the fast median is structurally
harmless", pinned by ``TestAlphaSquaredFactorization``) reduces the
fast-median posterior perturbation on the renorm path to

    dL = -0.5 * w * chi_spec * ((1+eps)^-2 - 1),   w = spectrum_weight*(nc+np)

with eps the RELATIVE median error of the k-pass midpoint rank search.
Both ingredients are computable on CPU: the count median
(``spec_segmented.median_nonneg_xla``, the lane that honours the dial) is
plain JAX, and chi_spec comes from the exact XLA path.  This gives the ACCURACY half
of the pass-count decision on the CPU; the throughput half is
``bench.py`` on the GPU.

Also reports the ANNEALER path (renorm=False) directly: there the median
error perturbs the residual itself (no factorization), so its Δ(w·chi) is
measured by recomputation, not the tempering formula.

Run:  nohup python scripts/median_tempering_bound_cpu.py > /tmp/med_bound_cpu.log 2>&1 &
"""
from __future__ import annotations

import os
import sys

os.environ["JAX_PLATFORMS"] = "cpu"

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax

jax.config.update("jax_platforms", "cpu")

import dataclasses
import json

import jax.numpy as jnp

from mcmc_spec_tpu.bench_target import build_bench_target, init_walker_batch
from mcmc_spec_tpu.inference import batched
from mcmc_spec_tpu.inference.stretch import init_ensemble, run_ensemble
from mcmc_spec_tpu.ops.spec_segmented import median_nonneg_xla


def kernel_median(model, iters):
    """The count median's k-pass result over every column of ``model``."""
    return median_nonneg_xla(model, model.shape[1], iters=iters)

NWALK = 1024
NBURN = 1500


def model_and_exact(coords, tgt):
    """Per-walker extincted model spectra + the exact-XLA pieces."""
    _, _, _, _, Wcomb = batched._forward_small(coords, tgt)
    av = coords[:, tgt.nspec]
    nT, nG, nd = tgt.D.shape
    model_raw = jnp.matmul(Wcomb, tgt.D.reshape(nT * nG, nd),
                           precision=jax.lax.Precision.HIGHEST)
    trans = jnp.where((av > 0)[:, None],
                      jnp.exp((-0.4 * jnp.log(10.0)) * av[:, None]
                              * tgt.ext_k_data[None, :]), 1.0)
    return model_raw * trans


def chi_renorm_with_med(model, med, tgt):
    """The emcee-stage (renorm) chi_spec given an externally supplied
    per-walker median — transcribes batched._spec_chi2_xla from the
    median-scale step on."""
    HI = jax.lax.Precision.HIGHEST
    m = model * (tgt.med_data / med)[:, None]
    frac = tgt.data_flux[None, :] / m
    coeffs = jnp.matmul(frac, tgt.Vpinv.T, precision=HI)
    data_renorm = tgt.data_flux[None, :] / jnp.matmul(coeffs, tgt.V.T, precision=HI)
    resid2 = ((m - data_renorm) / tgt.data_err) ** 2
    resid2 = jnp.where(jnp.isfinite(resid2), resid2, 0.0)
    return jnp.sum(resid2, axis=1) / tgt.n_data_true.astype(m.dtype)


def chi_median_only_with_med(model, med, tgt):
    """The annealer (renorm=False) chi_spec given a supplied median."""
    m = model * (tgt.med_data / med)[:, None]
    resid2 = ((m - tgt.data_flux[None, :]) / tgt.data_err) ** 2
    resid2 = jnp.where(jnp.isfinite(resid2), resid2, 0.0)
    return jnp.sum(resid2, axis=1) / tgt.n_data_true.astype(m.dtype)


def main():
    tgt, truth = build_bench_target(jnp.float32)
    tgt = dataclasses.replace(tgt, median_iters=31)
    logp = jax.jit(lambda b: batched.log_posterior_batch(b, tgt))

    coords = init_walker_batch(tgt, truth, NWALK, jnp.float32)
    state = init_ensemble(coords, logp, jax.random.PRNGKey(7))
    state, _, _ = run_ensemble(state, logp, n_steps=NBURN, thin=NBURN)
    eq = state.coords
    L = np.asarray(logp(eq), np.float64)
    fin = np.isfinite(L)
    print(f"equilibrated: {int(fin.sum())}/{NWALK} finite logp", flush=True)

    model = jax.jit(lambda c: model_and_exact(c, tgt))(eq)
    med_exact = np.asarray(kernel_median(model, 31), np.float64)
    w = float(tgt.spectrum_weight) * float(
        np.asarray(tgt.n_contrast_true) + np.asarray(tgt.n_phot_true))
    chi_ex = np.asarray(chi_renorm_with_med(
        model, jnp.asarray(med_exact, jnp.float32), tgt), np.float64)
    chi_med_ex = np.asarray(chi_median_only_with_med(
        model, jnp.asarray(med_exact, jnp.float32), tgt), np.float64)
    print(f"w = {w}, equilibrium chi_spec (mean-per-point): "
          f"median {np.median(chi_ex[fin]):.3f}, "
          f"p95 {np.percentile(chi_ex[fin], 95):.3f}", flush=True)

    out = {}
    for k in (20, 16, 14, 12, 10):
        med_k = np.asarray(
            kernel_median(model, k), np.float64)
        eps = med_k[fin] / med_exact[fin] - 1.0
        # tempering formula (the structural bound's quantity)
        dL_temper = -0.5 * w * chi_ex[fin] * ((1.0 + eps) ** -2 - 1.0)
        # direct recomputation through the full renorm path (ground truth;
        # agreement with dL_temper IS the factorization, incl. f32 rounding)
        chi_k = np.asarray(chi_renorm_with_med(
            model, jnp.asarray(med_k, jnp.float32), tgt), np.float64)[fin]
        dL_direct = -0.5 * w * (chi_k - chi_ex[fin])
        # annealer path: no factorization, direct only
        chi_mk = np.asarray(chi_median_only_with_med(
            model, jnp.asarray(med_k, jnp.float32), tgt), np.float64)[fin]
        dL_anneal = -0.5 * 3.0 * w * (chi_mk - chi_med_ex[fin])  # x3 stage-1 weight
        out[k] = dict(
            eps_bound=float(np.log(2) * 2.0 ** (7 - k)),
            eps_max=float(np.max(np.abs(eps))),
            eps_std=float(np.std(eps)),
            dL_std=float(np.std(dL_temper)),
            dL_max=float(np.max(np.abs(dL_temper))),
            dL_direct_std=float(np.std(dL_direct)),
            dL_direct_max=float(np.max(np.abs(dL_direct))),
            anneal_dL_std=float(np.std(dL_anneal)),
            anneal_dL_max=float(np.max(np.abs(dL_anneal))),
        )
        r = out[k]
        print(f"k={k:2d}: |eps|max {r['eps_max']:.2e} (bound {r['eps_bound']:.2e})  "
              f"renorm dL std {r['dL_std']:.4f} max {r['dL_max']:.4f} "
              f"(direct {r['dL_direct_std']:.4f}/{r['dL_direct_max']:.4f})  "
              f"anneal dL std {r['anneal_dL_std']:.3f} max {r['anneal_dL_max']:.3f}",
              flush=True)

    print("\n" + json.dumps(out))


if __name__ == "__main__":
    main()
