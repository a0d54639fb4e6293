#!/usr/bin/env python
"""Extended benchmark suite (beyond the driver's single-metric bench.py).

Covers the BASELINE.md workload configs on the GPU:

* ``chain``  — config 2 shape: the full koi2298-style MCMC chain
  (50 walkers x 15,302 steps, the reference's nburn+nsteps) wall-clock.
* ``fleet``  — config 5: 9 targets x 4096 walkers in one program,
  aggregate evals/sec.
* ``anneal`` — stage 1: 150 walkers x 50*400 annealing schedule wall-clock
  (the reference runs this on a 15-process pool for hours).
* ``evals``  — same metric as bench.py (headline).
* ``nospec`` — config 4: the mft6_nospec.py mode (spectrum term dropped).
* ``single`` — config 1: real ``Data/GJ544B.ascii`` single-star ndim-4
  chain at the reference's 50-walker 301+15001 schedule.
* ``largend`` — the large-nd spectrum lane
  (``ops/spec_segmented.py``) at the native-resolution regime (nd=65536,
  no reference counterpart — the reference decimates, mft6.py:154-170).
* ``spshard`` — sp-mode (walkers x spec shard_map) at S=1 on one device —
  the sharding-overhead floor — plus the per-eval collective count from the
  traced program.

Usage: python benchmarks/bench_suite.py [chain|fleet|anneal|evals|nospec|single|largend|spshard|all]
"""
import json
import sys
import time

import jax
import jax.numpy as jnp
import numpy as np

sys.path.insert(0, ".")

from mcmc_spec_tpu.bench_target import build_bench_target, init_walker_batch
from mcmc_spec_tpu.inference.anneal import init_walkers, run_anneal
from mcmc_spec_tpu.inference.batched import log_posterior_batch
from mcmc_spec_tpu.inference.fleet import (
    init_fleet_ensemble,
    run_fleet_ensemble,
    stack_targets,
)
from mcmc_spec_tpu.inference.stretch import init_ensemble, run_ensemble

DTYPE = jnp.float32


def _force(x):
    """Warmup sync via a real host fetch: the warmup's last result is on
    the host before any timed region starts."""
    np.asarray(x).ravel()[:1]


def bench_chain(tgt, truth):
    """Reference koi2298 chain: 50 walkers, 301 burn + 15001 steps."""
    nw, nburn, nsteps = 50, 301, 15001
    logp = lambda b: log_posterior_batch(b, tgt)
    coords = init_walker_batch(tgt, truth, nw, DTYPE)
    state = init_ensemble(coords, logp, jax.random.PRNGKey(0))
    # compile both stage shapes first (n_steps/thin are static)
    s, c, _ = run_ensemble(state, logp, n_steps=nburn, thin=nburn)
    _force(c)
    s, c, _ = run_ensemble(state, logp, n_steps=nsteps, thin=100)
    _force(c)
    t0 = time.perf_counter()
    state, chain, _ = run_ensemble(state, logp, n_steps=nburn, thin=nburn)
    jax.block_until_ready(chain)
    t_burn = time.perf_counter() - t0
    t0 = time.perf_counter()
    state, chain, logps = run_ensemble(state, logp, n_steps=nsteps, thin=100)
    jax.block_until_ready(chain)
    t_sample = time.perf_counter() - t0
    return {
        "metric": "koi2298_chain_wall_clock",
        "value": round(t_burn + t_sample, 3),
        "unit": "s (301 burn + 15001 steps, 50 walkers)",
        "steps_per_sec": round(nsteps / t_sample, 1),
    }


def bench_fleet(tgt, truth):
    """Config 5: 9 targets x 4096 walkers.

    The aggregate rate depends on steps per dispatch (each dispatch has a
    fixed launch cost), so report a 64-step-chunk point AND a
    512-step-chunk point that approaches the device rate.  Warmup ends
    with a real host fetch.
    """
    ntgt, nw = 9, 4096
    fleet = stack_targets([tgt] * ntgt)
    coords = jnp.stack([init_walker_batch(tgt, truth, nw, DTYPE, seed=i)
                        for i in range(ntgt)])
    state = init_fleet_ensemble(coords, fleet, jax.random.PRNGKey(0))
    rates = {}
    for nsteps in (64, 512):
        state, chain, lp = run_fleet_ensemble(state, fleet, n_steps=nsteps,
                                              thin=nsteps)
        float(np.asarray(lp).sum())  # force completion (trap #4)
        best = float("inf")
        for _ in range(2):
            t0 = time.perf_counter()
            state, chain, _ = run_fleet_ensemble(state, fleet,
                                                 n_steps=nsteps, thin=nsteps)
            jax.block_until_ready((chain, state.coords))
            best = min(best, time.perf_counter() - t0)
        rates[nsteps] = ntgt * nw * nsteps / best
    return {
        "metric": "fleet_evals_per_sec",
        "value": round(rates[64], 1),
        "unit": "evals/s (9 targets x 4096 walkers, 64-step chunks)",
        "value_512chunk": round(rates[512], 1),
    }


def bench_anneal(tgt, truth):
    """Stage 1: the reference's nwalk=150, nstep=400 schedule."""
    p0 = init_walkers(tgt, 150, truth[-1], 0.05e-3, jax.random.PRNGKey(0))
    # compile with the same static schedule
    _force(run_anneal(tgt, p0, jax.random.PRNGKey(1), steps=400)[1])
    t0 = time.perf_counter()
    params, chi, _ = run_anneal(tgt, p0, jax.random.PRNGKey(1), steps=400)
    chi.block_until_ready()
    dt = time.perf_counter() - t0
    return {
        "metric": "anneal_stage_wall_clock",
        "value": round(dt, 3),
        "unit": "s (150 walkers x 50*400 schedule)",
    }


def bench_evals(tgt, truth):
    nw, nsteps = 4096, 512
    logp = lambda b: log_posterior_batch(b, tgt)
    coords = init_walker_batch(tgt, truth, nw, DTYPE)
    state = init_ensemble(coords, logp, jax.random.PRNGKey(0))
    s, c, _ = run_ensemble(state, logp, n_steps=nsteps, thin=nsteps)
    _force(c)
    t0 = time.perf_counter()
    for _ in range(3):
        s, c, _ = run_ensemble(s, logp, n_steps=nsteps, thin=nsteps)
    jax.block_until_ready(c)
    dt = time.perf_counter() - t0
    return {
        "metric": "logpost_evals_per_sec",
        "value": round(3 * nsteps * nw / dt, 1),
        "unit": "evals/s",
    }


def bench_nospec(tgt, truth):
    """Config 4: mft6_nospec.py mode — spectrum term dropped (photometry +
    contrast + priors only, the 1/100-capped plx bound).  The eval is no
    longer kernel-bound, so throughput is ensemble-mechanics-limited."""
    import dataclasses

    tgt_ns = dataclasses.replace(tgt, spectrum_weight=0.0)
    nw, nsteps = 32768, 512
    logp = lambda b: log_posterior_batch(b, tgt_ns)
    coords = init_walker_batch(tgt_ns, truth, nw, DTYPE)
    state = init_ensemble(coords, logp, jax.random.PRNGKey(0))
    s, c, _ = run_ensemble(state, logp, n_steps=nsteps, thin=nsteps)
    _force(c)
    t0 = time.perf_counter()
    for _ in range(3):
        s, c, _ = run_ensemble(s, logp, n_steps=nsteps, thin=nsteps)
    jax.block_until_ready(c)
    dt = time.perf_counter() - t0
    return {
        "metric": "nospec_evals_per_sec",
        "value": round(3 * nsteps * nw / dt, 1),
        "unit": "evals/s (spectrum_weight=0, 32k walkers)",
    }


def bench_single_gj544b(*_):
    """Config 1: single-star chi^2 fit of the real Data/GJ544B.ascii
    spectrum (windowed to the HET band) against a synthetic grid —
    ndim-4 [T, Av, R, plx] chain at production walker counts."""
    import os

    from mcmc_spec_tpu.inference.target import pack_target
    from mcmc_spec_tpu.models.dust import AvProfile
    from mcmc_spec_tpu.models.mist import MistTable
    from mcmc_spec_tpu.models.synthetic import synthetic_grid
    from mcmc_spec_tpu.ops.photometry import ab_zero_flux, photon_flux_weights

    path = os.environ.get("MCMC_SPEC_GJ544B",
                          "/root/reference/Data/GJ544B.ascii")
    if not os.path.exists(path):
        return {"metric": "single_star_chain_wall_clock", "value": None,
                "unit": "skipped: GJ544B.ascii unavailable"}
    raw = np.genfromtxt(path)
    wl_um, flux = raw[:, 0], raw[:, 1]
    sel = (wl_um > 0.645) & (wl_um < 0.84)
    wl_um, flux = wl_um[sel], np.maximum(flux[sel], 0.0)
    med = np.median(flux[flux > 0])
    flux = flux / med
    err = 0.01 * np.maximum(flux, 0.05)

    grid = synthetic_grid(
        specrange=(5000.0, 12000.0), data_window=(6450.0, 8400.0),
        resolution=1700, temps=np.arange(3000.0, 5801.0, 400.0),
        loggs=np.array([4.5, 5.0, 5.5]), step=2.0,
    )
    from tests.helpers import gaussian_filter_curve

    pfilts = [gaussian_filter_curve("p_i", 7700.0, 350.0)]
    _, lp = photon_flux_weights(grid.wl, pfilts[0].wl, pfilts[0].tr)
    prior_mu, prior_sig = np.zeros(4), np.ones(4)
    prior_mu[-1], prior_sig[-1] = 5e-2, 1e-2
    tgt = pack_target(
        grid, wl_um, flux, err, [], np.zeros(0), np.zeros(0),
        pfilts, [ab_zero_flux(lp)], np.array([10.0]), np.array([0.2]),
        MistTable.builtin(), AvProfile.constant(0.05, 0.05),
        nspec=1, prior_mu=prior_mu, prior_sig=prior_sig, dtype=DTYPE,
    )
    nw, nburn, nsteps = 50, 301, 15001  # the reference chain schedule
    logp = lambda b: log_posterior_batch(b, tgt)
    key = jax.random.PRNGKey(0)
    base = jnp.asarray([4000.0, 0.1, 0.3, 5e-2], DTYPE)
    scale = jnp.asarray([100.0, 0.02, 0.02, 1e-3], DTYPE)
    coords = base + scale * jax.random.normal(key, (nw, 4), DTYPE)
    state = init_ensemble(coords, logp, jax.random.PRNGKey(1))
    s, c, _ = run_ensemble(state, logp, n_steps=nburn, thin=nburn)
    _force(c)
    s, c, _ = run_ensemble(state, logp, n_steps=nsteps, thin=100)
    _force(c)
    t0 = time.perf_counter()
    s, c, _ = run_ensemble(state, logp, n_steps=nburn, thin=nburn)
    s, c, _ = run_ensemble(s, logp, n_steps=nsteps, thin=100)
    jax.block_until_ready(c)
    dt = time.perf_counter() - t0
    return {
        "metric": "single_star_chain_wall_clock",
        "value": round(dt, 3),
        "unit": f"s (GJ544B, {wl_um.size} px, 301 burn + 15001 steps, "
                f"50 walkers)",
    }


def _timed_eval(fn, coords, reps):
    """Per-call wall: queue ``reps`` dispatches, block once (dispatch cost
    is latency, not throughput)."""
    _force(fn(coords))  # compile + warm
    t0 = time.perf_counter()
    out = None
    for _ in range(reps):
        out = fn(coords)
    out.block_until_ready()
    return (time.perf_counter() - t0) / reps


LARGEND_ND, LARGEND_NW = 65536, 1024


def bench_largend(*_):
    """Segmented lane (the automatic dispatch at nd > 4096) at HiRes-like
    nd — the regime ``parallel/spec_shard.py`` exists for."""
    tgt, truth = build_bench_target(DTYPE, nd=LARGEND_ND, grid_step=8.0)
    coords = init_walker_batch(tgt, truth, LARGEND_NW, DTYPE)
    dt = _timed_eval(jax.jit(lambda c: log_posterior_batch(c, tgt)),
                     coords, 20)
    return {
        "metric": "largend_evals_per_sec",
        "value": round(LARGEND_NW / dt, 1),
        "unit": f"evals/s (segmented lane, nd={LARGEND_ND}, "
                f"{LARGEND_NW} walkers)",
        "ms_per_eval_batch": round(dt * 1e3, 3),
    }


def bench_spshard(*_):
    """sp-mode at S=1: shard_map + distributed-median structure on one
    chip (the overhead floor vs ``largend``), with the per-eval collective
    count read from the traced program — the collective latency-round
    budget a real multi-device step pays."""
    from jax.sharding import Mesh

    from mcmc_spec_tpu.parallel.spec_shard import (
        make_spec_logpost,
        shard_target_over_spec,
    )

    tgt, truth = build_bench_target(DTYPE, nd=LARGEND_ND, grid_step=8.0,
                                    stage_on_device=False)
    coords = init_walker_batch(tgt, truth, LARGEND_NW, DTYPE)
    mesh = Mesh(np.array(jax.devices()[:1]).reshape(1, 1),
                ("walkers", "spec"))
    tgt_sp = shard_target_over_spec(tgt, mesh)
    fsp = make_spec_logpost(tgt_sp, mesh)
    # collective census from the trace (device-count-independent): every
    # psum/pmin here crosses devices once per eval on a real spec mesh
    jaxpr = str(jax.make_jaxpr(lambda c: fsp(c, tgt_sp))(coords))
    collectives = {name: jaxpr.count(f"{name}[") for name in
                   ("psum", "pmin", "pmax", "all_gather")}
    dt = _timed_eval(lambda c: fsp(c, tgt_sp), coords, 20)
    return {
        "metric": "spshard_S1_evals_per_sec",
        "value": round(LARGEND_NW / dt, 1),
        "unit": f"evals/s (sp-mode S=1, nd={LARGEND_ND}, "
                f"{LARGEND_NW} walkers)",
        "ms_per_eval_batch": round(dt * 1e3, 3),
        "collectives_per_eval": collectives,
    }


def main():
    which = sys.argv[1] if len(sys.argv) > 1 else "all"
    tgt, truth = build_bench_target(DTYPE)
    benches = {"chain": bench_chain, "fleet": bench_fleet,
               "anneal": bench_anneal, "evals": bench_evals,
               "nospec": bench_nospec, "single": bench_single_gj544b,
               "largend": bench_largend, "spshard": bench_spshard}
    if which == "all":
        names = benches
    else:
        names = {w: benches[w] for w in sys.argv[1:]}
    for name, fn in names.items():
        print(json.dumps(fn(tgt, truth)), flush=True)


if __name__ == "__main__":
    main()
