#!/usr/bin/env python
"""Spectral-axis model parallelism: fit a target whose grid shards over devices.

Demonstrates ``mcmc_spec_tpu.parallel.spec_shard`` — the scaling axis for
model grids larger than one device's memory.  The packed target's wavelength
axis shards over the ``spec`` mesh axis (the grid projection
``D [nT, nG, nd]`` dominates device memory), walkers data-parallelize over
the ``walkers`` axis, and the log-posterior stays exact: column-parallel
model matmul, psum'd renorm/chi^2 reductions, and a distributed radix-select
median that is bit-identical to the single-device rank median.

    python examples/spec_sharded_fit.py [walkers_axis] [spec_axis] [--cpu]

The mesh maps onto the default backend's devices (for example the GPUs of
one host), which must number at least ``walkers_axis * spec_axis``.
``--cpu`` builds a virtual CPU mesh of that size instead, so the example
runs on any machine (the recipe the test suite uses).
"""
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

args = [a for a in sys.argv[1:] if a != "--cpu"]
W = int(args[0]) if len(args) > 0 else 2
S = int(args[1]) if len(args) > 1 else 4
CPU = "--cpu" in sys.argv

if CPU:
    # virtual CPU mesh: must be configured before the backend initializes
    os.environ["JAX_PLATFORMS"] = "cpu"
    os.environ["XLA_FLAGS"] = (
        os.environ.get("XLA_FLAGS", "") +
        f" --xla_force_host_platform_device_count={W * S}"
    )

import jax

if CPU:
    jax.config.update("jax_platforms", "cpu")

import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh

from mcmc_spec_tpu.bench_target import build_bench_target, init_walker_batch
from mcmc_spec_tpu.inference.batched import log_posterior_batch
from mcmc_spec_tpu.parallel.spec_shard import (
    pad_packed_target_nd,
    run_anneal_spec_sharded,
    run_ensemble_spec_sharded,
    shard_spec_ensemble_state,
    shard_target_over_spec,
)


def main():
    dtype = jnp.float32
    if len(jax.devices()) < W * S:
        raise SystemExit(f"a {W}x{S} mesh needs {W * S} devices, have "
                         f"{len(jax.devices())}; pass --cpu for a virtual CPU mesh")
    mesh = Mesh(np.array(jax.devices()[: W * S]).reshape(W, S), ("walkers", "spec"))
    print(f"mesh: {dict(zip(mesh.axis_names, mesh.devices.shape))} "
          f"on {jax.devices()[0].platform}")

    tgt, truth = build_bench_target(dtype, nd=1792, grid_step=2.0)
    nsp = mesh.shape["spec"]
    tgt_sp = shard_target_over_spec(
        pad_packed_target_nd(tgt, -(-tgt.n_data // nsp) * nsp), mesh
    )
    shard_nd = tgt_sp.D.addressable_shards[0].data.shape[2]
    print(f"grid projection D{tuple(tgt_sp.D.shape)}: "
          f"each device holds {shard_nd}/{tgt_sp.n_data} wavelength columns")

    print("stage 1: spectral-sharded annealing, 64 walkers...")
    from mcmc_spec_tpu.inference.anneal import init_walkers

    p0 = init_walkers(tgt, 64, truth[-1], 0.05e-3, jax.random.PRNGKey(0))
    params, chi, _ = run_anneal_spec_sharded(
        tgt_sp, p0, jax.random.PRNGKey(1), mesh, steps=100
    )
    chi = np.asarray(chi)
    print(f"  best chi2: {chi.min():.2f}")

    print("stage 2: spectral-sharded stretch MCMC, 64 walkers x 500 steps...")
    seeds = np.asarray(params)[np.argsort(chi)[:64]]
    seeds = seeds * (1 + 1e-5 * np.random.RandomState(0).randn(*seeds.shape))
    state = shard_spec_ensemble_state(
        jnp.asarray(seeds, dtype), tgt_sp, jax.random.PRNGKey(2), mesh
    )
    state, chain, logps = run_ensemble_spec_sharded(
        state, tgt_sp, mesh, n_steps=500, thin=10
    )
    chain = np.asarray(jax.device_get(chain)).reshape(-1, seeds.shape[1])
    print(f"  kept {chain.shape[0]} samples; "
          f"acceptance {float(state.n_accept) / (500 * 64):.2f}")

    # exactness spot-check against the single-device evaluation
    flat = np.asarray(jax.device_get(state.coords)).reshape(-1, seeds.shape[1])
    single = np.asarray(log_posterior_batch(jnp.asarray(flat, dtype), tgt))
    sharded = np.asarray(jax.device_get(state.log_prob)).reshape(-1)
    print(f"  max |sharded - single-device| log-posterior: "
          f"{np.abs(sharded - single).max():.2e}")
    med = np.median(chain, axis=0)
    print(f"  posterior medians: {np.round(med, 4)}")
    print(f"  truth:             {np.round(truth, 4)}")


if __name__ == "__main__":
    main()
