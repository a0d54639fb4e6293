"""Peak-RSS receipt for the streamed fleet samples writer.

The round-3 ``run_fleet_mcmc`` accumulated every chunk in a Python list and
``np.concatenate``-d at the end: at the full BASELINE config-5 schedule
(15,001 steps x 9 targets x 4096 walkers x 6 params, f32) that holds ~13.3 GB
*plus* a same-size transient at the concatenate, on top of the ~31 GB text
artifact set.  Round 4 streams the per-target ``samples.txt`` files straight
from the on-disk ChainStore (``fleet_pipeline.stream_fleet_samples``) so the
peak is ONE chunk.

This script measures the production writer (not a transcription) on a
synthetic store:

1. NEW path at the FULL config-5 chain shape — 150 chunks of
   [100, 9, 4096, 6] f32 (13.3 GB on disk) — peak RSS recorded.
2. NEW path at half the schedule (75 chunks) — shows RSS is flat in
   schedule length.
3. OLD pattern (hold-all + concatenate + per-target slices) at a REDUCED
   walker count (nw=512) for contrast, plus its analytic full-shape cost.

Run:  nohup python scripts/fleet_memory_receipt.py > /tmp/fleet_mem.log 2>&1 &
(The writer is pure host numpy/pandas: no accelerator; ~15-25 min on a
1-core box, dominated by the 31 GB text write of step 1.)
"""
import json
import os
import resource
import shutil
import subprocess
import sys
import tempfile
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

NTHIN, NTGT, NDIM = 100, 9, 6


def _build_store(root, n_chunks, nw, seed=0):
    from mcmc_spec_tpu.io.results import ChainStore

    store = ChainStore(root, name=f"chunks_{nw}")
    rng = np.random.RandomState(seed)
    base = rng.rand(NTHIN, NTGT, nw, NDIM).astype(np.float32)
    for i in range(n_chunks):
        store.append(i, base)  # values don't matter for the memory receipt
    return store


def _run_child(mode, root, n_chunks, nw):
    """Measure one writer run in a FRESH process (ru_maxrss is a high-water
    mark; reusing a process would carry the previous run's peak)."""
    code = f"""
import json, os, resource, sys, time
os.environ["JAX_PLATFORMS"] = "cpu"  # the writer is pure host code; do not
import jax                            # touch an accelerator backend here
jax.config.update("jax_platforms", "cpu")
import numpy as np
sys.path.insert(0, {os.path.dirname(os.path.dirname(os.path.abspath(__file__)))!r})
from mcmc_spec_tpu.io.results import ChainStore
from mcmc_spec_tpu.fleet_pipeline import stream_fleet_samples

root = {root!r}
store = ChainStore(root, name="chunks_{nw}")
dirnames = []
for t in range({NTGT}):
    d = os.path.join(root, "out_{mode}_{n_chunks}_{nw}", f"tgt{{t}}")
    os.makedirs(d, exist_ok=True)
    dirnames.append(d)
t0 = time.perf_counter()
if "{mode}" == "new":
    out = stream_fleet_samples(store, dirnames, {n_chunks}, {NDIM},
                               return_samples=False)
else:  # the round-3 pattern: hold-all + concatenate + per-target slices
    kept = [c for c in store.iter_chunks({n_chunks})]
    full = np.concatenate(kept, axis=0)
    from mcmc_spec_tpu.io.results import write_samples
    for t, d in enumerate(dirnames):
        write_samples(d, full[:, t].reshape(-1, {NDIM}))
dt = time.perf_counter() - t0
rss_gb = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 1e6
print(json.dumps(dict(mode="{mode}", n_chunks={n_chunks}, nw={nw},
                      peak_rss_gb=round(rss_gb, 2), wall_s=round(dt, 1))))
"""
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, check=True)
    rec = json.loads(out.stdout.strip().splitlines()[-1])
    return rec


def main():
    work = tempfile.mkdtemp(prefix="fleet_mem_", dir="/root")
    results = []
    try:
        # full config-5 chain shape, new path, two schedule lengths
        print("building full-shape store (13.3 GB)...", flush=True)
        _build_store(work, 150, 4096)
        for n_chunks in (75, 150):
            rec = _run_child("new", work, n_chunks, 4096)
            print(rec, flush=True)
            results.append(rec)
        shutil.rmtree(os.path.join(work, "chunks_4096"))
        for d in os.listdir(work):
            if d.startswith("out_new"):
                shutil.rmtree(os.path.join(work, d))

        # old-vs-new contrast at reduced walkers (old at full shape ~40 GB)
        print("building reduced store (nw=512, 1.7 GB)...", flush=True)
        _build_store(work, 150, 512)
        for mode in ("new", "old"):
            rec = _run_child(mode, work, 150, 512)
            print(rec, flush=True)
            results.append(rec)

        chain_gb = 150 * NTHIN * NTGT * 4096 * NDIM * 4 / 1e9
        print(json.dumps(dict(
            summary=results,
            full_shape_chain_gb=round(chain_gb, 1),
            old_path_full_shape_analytic_gb=round(2 * chain_gb, 1),
        ), indent=2))
    finally:
        shutil.rmtree(work, ignore_errors=True)


if __name__ == "__main__":
    main()
