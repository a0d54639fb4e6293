#!/usr/bin/env python
"""Per-component device timing of the bench workload.

Breaks one 8192-walker log-posterior evaluation into its pieces and times
each with ``device_loop_time`` (dispatch-free), so we know exactly where the
time outside the spectrum block goes.  Run on a GPU.
"""
import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax
import jax.numpy as jnp

from mcmc_spec_tpu.bench_target import build_bench_target, init_walker_batch
from mcmc_spec_tpu.inference import batched
from mcmc_spec_tpu.inference.stretch import init_ensemble, run_ensemble
from mcmc_spec_tpu.utils.profiling import device_loop_time

NWALK = int(sys.argv[1]) if len(sys.argv) > 1 else 8192


def main():
    dtype = jnp.float32
    tgt, truth = build_bench_target(dtype)
    p = init_walker_batch(tgt, truth, NWALK, dtype)
    nT, nG, nd = tgt.D.shape
    print(f"devices={jax.devices()} nwalk={NWALK} NO={nT*nG} nd={nd}", flush=True)

    rows = {}

    def t(name, fn, *args, rep=30):
        dt = device_loop_time(fn, *args, rep=rep)
        rows[name] = dt * 1e3
        print(f"{name:28s} {dt*1e3:8.3f} ms", flush=True)
        return dt

    # full eval
    t("log_posterior_batch", lambda q: batched.log_posterior_batch(q, tgt), p)
    t("log_prior_batch", lambda q: batched.log_prior_batch(q, tgt), p)
    t("forward_small", lambda q: batched._forward_small(q, tgt)[0], p)

    # the spectrum lanes alone (with Wcomb/av precomputed)
    from mcmc_spec_tpu.ops.spec_segmented import spectrum_chi2_segmented

    _, _, _, _, Wcomb = batched._forward_small(p, tgt)
    av = p[:, tgt.nspec]
    D_flat = tgt.D.reshape(nT * nG, nd)
    t("xla_sort_spectrum_chi2", lambda W: batched._spec_chi2_xla(W, av, tgt), Wcomb)
    t("xla_count_spectrum_chi2",
      lambda W: spectrum_chi2_segmented(W, av, D_flat, tgt.ext_k_data, tgt.data_flux,
                                        tgt.data_err, tgt.V, tgt.Vpinv, tgt.med_data,
                                        tgt.n_data_true, iters=tgt.median_iters), Wcomb)

    # pure matmul cost floor for the same shape (full f32)
    t("matmul_only_f32hi",
      lambda W: jnp.matmul(W, D_flat, precision=jax.lax.Precision.HIGHEST), Wcomb)

    # stretch step end-to-end (2 half updates = 1 eval/walker + RNG + bookkeeping)
    logp = lambda q: batched.log_posterior_batch(q, tgt)
    state = init_ensemble(p, logp, jax.random.PRNGKey(0))
    import time

    st, chain, _ = run_ensemble(state, logp, n_steps=128, thin=128)
    chain.block_until_ready()
    t0 = time.perf_counter()
    st, chain, _ = run_ensemble(st, logp, n_steps=128, thin=128)
    chain.block_until_ready()
    per_step = (time.perf_counter() - t0) / 128
    rows["stretch_step"] = per_step * 1e3
    print(f"{'stretch_step':28s} {per_step*1e3:8.3f} ms "
          f"({NWALK/per_step/1e6:.2f}M evals/s)", flush=True)

    print(json.dumps(rows))


if __name__ == "__main__":
    main()
