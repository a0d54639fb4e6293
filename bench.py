#!/usr/bin/env python
"""Benchmark: log-posterior evaluations/sec through the ensemble sampler.

Runs the koi2298-scale workload (BASELINE.md config 2 shapes: ~1.8k data
wavelengths, 2 contrasts, 6 photometric bands, 14x4 grid) with 32k
stretch-move walkers entirely on the GPU, and reports sustained
log-posterior evaluations per second at the packed default median setting.
Baseline north star (BASELINE.md): 100,000 evals/sec/chip.

The JSON line names the spectrum lane it measured (``flags.spectrum_lane``).
Only the count-median lane (``"segmented"``, beyond ``flags.LARGE_ND``)
honours the fast-median dial; there the line also carries the rate at the
exact 31-pass median.  The sort lane is always exact, so it is measured once.

Prints ONE json line:
    {"metric": "logpost_evals_per_sec", "value": N, "unit": "evals/s",
     "vs_baseline": N/1e5, "lane": ..., ["exact_evals_per_sec": ...,]
     "device": {"platform": ..., "kind": ..., "count": ...}, "gpu": ...}
"""
import dataclasses
import json
import subprocess
import sys
import time

import jax
import jax.numpy as jnp
import numpy as np

from mcmc_spec_tpu.bench_target import build_bench_target, init_walker_batch
from mcmc_spec_tpu.inference.batched import log_posterior_batch
from mcmc_spec_tpu.inference.stretch import init_ensemble, run_ensemble
from mcmc_spec_tpu.utils.flags import enable_persistent_compile_cache, spectrum_lane

NWALK = 32768
NSTEPS = 512
BASELINE = 1.0e5  # evals/sec north star (BASELINE.md)


def _measure(tgt, truth, dtype):
    logp = lambda batch: log_posterior_batch(batch, tgt)
    coords = init_walker_batch(tgt, truth, NWALK, dtype)
    state = init_ensemble(coords, logp, jax.random.PRNGKey(0))

    # compile + warmup, ending in a host fetch
    st, chain, _ = run_ensemble(state, logp, n_steps=NSTEPS, thin=NSTEPS)
    np.asarray(chain).ravel()[:1]

    # timed: each stretch step evaluates every walker's log-posterior once
    n_rep = 3
    t0 = time.perf_counter()
    for _ in range(n_rep):
        st, chain, _ = run_ensemble(st, logp, n_steps=NSTEPS, thin=NSTEPS)
        chain.block_until_ready()
    dt = time.perf_counter() - t0
    return n_rep * NSTEPS * NWALK / dt


def main():
    if jax.default_backend() != "gpu":
        raise SystemExit("bench.py measures the GPU; no GPU backend found")
    enable_persistent_compile_cache()
    dtype = jnp.float32
    tgt, truth = build_bench_target(dtype)
    lane = spectrum_lane(tgt.n_data)
    rate = _measure(tgt, truth, dtype)
    extra = {}
    if lane == "segmented":
        extra["exact_evals_per_sec"] = _measure(
            dataclasses.replace(tgt, median_iters=31), truth, dtype)
    gpu = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True)
    dev = jax.devices()[0]
    print(f"[bench] {gpu.stdout.strip()}", file=sys.stderr)
    print(json.dumps({
        "metric": "logpost_evals_per_sec",
        "value": rate,
        "unit": "evals/s",
        "vs_baseline": rate / BASELINE,
        "lane": lane,
        **extra,
        "device": {"platform": dev.platform, "kind": dev.device_kind,
                   "count": len(jax.devices())},
        "gpu": gpu.stdout.strip(),
    }))


if __name__ == "__main__":
    main()
