#!/usr/bin/env python
"""Spectrum-block device time of the plain XLA lanes on the GPU.

At the ``chip_smoke.py`` phase-d shape (koi2298 target, 56 grid points,
32,768 walkers; nd 1,792, or each ``--nd``) and phase-e shape (9 padded
targets x 4,096 walkers) this times, inside one device loop each
(``device_loop_time``):

* the sort-based composition (``batched._spec_chi2_xla``, exact), the lane
  the GPU takes up to ``flags.LARGE_ND``;
* the count-median lane (``spec_segmented.spectrum_chi2_segmented``) at 14
  and 31 passes, the lane it takes beyond.

    python scripts/spectrum_lanes.py [--nd 1792 4096 8192]

Prints one JSON line last.  Needs a GPU.
"""
import argparse
import json
import os
import subprocess
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax
import jax.numpy as jnp

from mcmc_spec_tpu.bench_target import build_bench_target, init_walker_batch
from mcmc_spec_tpu.inference import batched
from mcmc_spec_tpu.inference.fleet import stack_targets
from mcmc_spec_tpu.ops.spec_segmented import spectrum_chi2_segmented
from mcmc_spec_tpu.utils.flags import enable_persistent_compile_cache
from mcmc_spec_tpu.utils.profiling import device_loop_time

NWALK = 32768
FLEET_ND = (1792, 1700, 1600, 1792, 1500, 1750, 1650, 1792, 1550)
FLEET_NW = 4096
REP = 20


def lane_args(tgt, coords):
    *_, Wcomb = batched._forward_small(coords, tgt)
    nT, nG, nd = tgt.D.shape
    rest = (coords[:, tgt.nspec], tgt.D.reshape(nT * nG, nd), tgt.ext_k_data,
            tgt.data_flux, tgt.data_err, tgt.V, tgt.Vpinv, tgt.med_data,
            tgt.n_data_true)
    return Wcomb, rest


def ms(fn, *args):
    return 1e3 * device_loop_time(fn, *args, rep=REP)


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--nd", type=int, nargs="+", default=[1792],
                    help="data-axis widths of the single-target timing")
    nds = ap.parse_args().nd
    if jax.default_backend() != "gpu":
        raise SystemExit("spectrum_lanes.py measures the GPU; no GPU backend found")
    enable_persistent_compile_cache()
    gpu = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True)
    out = {"gpu": gpu.stdout.strip(), "device_kind": jax.devices()[0].device_kind}

    single = {}
    for nd in nds:
        tgt, truth = build_bench_target(jnp.float32, nd=nd)
        W, rest = lane_args(tgt, init_walker_batch(tgt, truth, NWALK, jnp.float32))
        row = {"xla_sort_exact": ms(lambda w: batched._spec_chi2_xla(w, rest[0], tgt), W)}
        for it in (14, 31):
            row[f"xla_count_{it}"] = ms(
                lambda w: spectrum_chi2_segmented(w, *rest, iters=it), W)
        single[nd] = row
        del tgt, W, rest
    out["single_ms"] = single

    members, coords = [], []
    for i, nd in enumerate(FLEET_ND):
        t, tr = build_bench_target(jnp.float32, nd=nd, seed=i, pad_nd=max(FLEET_ND))
        members.append(t)
        coords.append(init_walker_batch(t, tr, FLEET_NW, jnp.float32, seed=i + 1))
    fleet, coords = stack_targets(members), jnp.stack(coords)
    *_, Wf = jax.vmap(batched._forward_small)(coords, fleet)
    avf = coords[..., fleet.nspec]
    out["fleet_ms"] = {"xla_sort_exact": ms(
        lambda w: jax.vmap(batched._spec_chi2_xla)(w, avf, fleet), Wf)}
    rows = {f"nd{nd}_{k}": v for nd, row in single.items() for k, v in row.items()}
    rows.update({f"fleet_{k}": v for k, v in out["fleet_ms"].items()})
    for k, v in rows.items():
        print(f"[{out['gpu']}] {k}: {v:.4f} ms", flush=True)
    print(json.dumps(out))


if __name__ == "__main__":
    main()
