"""Autocorrelation-gate cost: geometric vs per-chunk cadence.

The round-3 gate re-concatenated the accumulated 256-walker sub-chain and
re-ran the FFT estimator from scratch EVERY chunk — O(n^2) total traffic
across a production run (the reference's emcee parent checks on a growing
interval for exactly this reason, mft6.py:1512-1524).  Round 4 gates on a
geometrically growing interval (``pipeline.ACL_GATE_GROWTH``); this script
measures both cadences over a config-5-scale sub-chain (150 chunks of
[100, 256, 6] — the ACL accumulator shape, NOT the full 4096-walker chain)
through the production ``integrated_time`` estimator.

Run on a QUIET box (host-CPU FFTs):
    python scripts/acl_gate_cost.py
"""
import os
import sys
import time

os.environ["JAX_PLATFORMS"] = "cpu"

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax

jax.config.update("jax_platforms", "cpu")

from mcmc_spec_tpu.inference.autocorr import integrated_time
from mcmc_spec_tpu.pipeline import next_acl_gate


def run(chunks, gated):
    acl_kept, next_gate, t_total, n_gates = [], 1, 0.0, 0
    for n, c in enumerate(chunks):
        acl_kept.append(c)
        if gated and n + 1 < next_gate:
            continue
        t0 = time.perf_counter()
        integrated_time(np.concatenate(acl_kept, axis=0))
        t_total += time.perf_counter() - t0
        n_gates += 1
        next_gate = next_acl_gate(n + 1)
    return t_total, n_gates


def main():
    rng = np.random.RandomState(0)
    chunks = [rng.randn(100, 256, 6).astype(np.float32) for _ in range(150)]
    t_geo, g_geo = run(chunks, gated=True)
    print(f"geometric gating:  {g_geo} gates, {t_geo:.1f}s total", flush=True)
    t_every, g_every = run(chunks, gated=False)
    print(f"per-chunk gating:  {g_every} gates, {t_every:.1f}s total "
          f"({t_every / t_geo:.1f}x more)", flush=True)


if __name__ == "__main__":
    main()
