#!/usr/bin/env python
"""Device trace of the bench stretch loop: where the step time goes on the GPU.

Traces a short window of stretch steps of the ``bench.py`` workload
(32,768 walkers, koi2298 shape) and reduces the trace to, per device:
busy time, the idle share of the window, the time spent in the spectrum
block (every op under the ``spectrum_chi2`` named scope) and outside it,
and the top operations.  A device event names its kernel, which XLA
derives from an HLO instruction (``fusion.3`` runs as ``fusion_3``, a sort
may run as ``sort_21_1``); the compiled HLO's ``op_name`` metadata, of the
instruction or of the computation it calls, maps it to its JAX name scope.

    python scripts/trace_stretch.py

Prints one JSON line last.  Needs a GPU.
"""
import glob
import json
import os
import re
import subprocess
import sys
import tempfile
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax
import jax.numpy as jnp

from mcmc_spec_tpu.bench_target import build_bench_target, init_walker_batch
from mcmc_spec_tpu.inference.batched import log_posterior_batch
from mcmc_spec_tpu.inference.stretch import init_ensemble, run_ensemble
from mcmc_spec_tpu.utils.flags import enable_persistent_compile_cache, spectrum_lane

NWALK = 32768
NSTEPS = 32
SCOPE = "spectrum_chi2"


def op_scopes(hlo_text: str) -> dict:
    """Kernel-style instruction name -> JAX name stacks, from compiled HLO.

    A fusion instruction often carries no ``op_name`` of its own; the ops
    inside the computation it calls do, so those are folded in too.
    """
    comp_scopes, cur = {}, None
    for line in hlo_text.splitlines():
        head = re.match(r"\s*(?:ENTRY )?%?([\w.\-]+) .*\{\s*$", line)
        if head and "=" not in line.split("{")[0]:
            cur = head.group(1)
            continue
        m = re.search(r'op_name="([^"]*)"', line)
        if cur and m:
            comp_scopes.setdefault(cur, set()).add(m.group(1))
    out = {}
    for line in hlo_text.splitlines():
        m = re.match(r"\s*(?:ROOT )?%?([\w.\-]+) = ", line)
        if not m:
            continue
        names = set(re.findall(r'op_name="([^"]*)"', line))
        for called in re.findall(r"calls=%?([\w.\-]+)", line):
            names |= comp_scopes.get(called, set())
        out[m.group(1).replace(".", "_").replace("-", "_")] = " ".join(sorted(names))
    return out


def _scope_of(kernel: str, scopes: dict) -> str:
    """Name scope of a device kernel (trailing ``_<n>`` suffixes stripped)."""
    name = kernel
    while True:
        if name in scopes:
            return scopes[name]
        base, _, tail = name.rpartition("_")
        if not base or not tail.isdigit():
            return ""
        name = base


def reduce_trace(path: str, scopes: dict) -> dict:
    """Busy/idle/spectrum-share summary of the device planes of one trace."""
    from jax.profiler import ProfileData

    pd = ProfileData.from_file(path)
    result = {}
    for plane in pd.planes:
        if not plane.name.startswith("/device:GPU"):
            continue
        lines = [ln for ln in plane.lines if ln.name.startswith("Stream")]
        if not lines:
            lines = list(plane.lines)
        spans, spec_ns, other_ns, by_name = [], 0, 0, {}
        for ln in lines:
            for e in ln.events:
                stats = dict(e.stats)
                op = str(stats.get("hlo_op", "")).replace(".", "_").replace("-", "_")
                scope = scopes.get(op) or _scope_of(e.name, scopes)
                start, dur = int(e.start_ns), int(e.duration_ns)
                spans.append((start, start + dur))
                if SCOPE in e.name or SCOPE in scope:
                    spec_ns += dur
                else:
                    other_ns += dur
                key = e.name[:60]
                by_name[key] = by_name.get(key, 0) + dur
        if not spans:
            continue
        spans.sort()
        busy, cur_s, cur_e = 0, spans[0][0], spans[0][1]
        for s, e in spans[1:]:
            if s > cur_e:
                busy += cur_e - cur_s
                cur_s, cur_e = s, e
            else:
                cur_e = max(cur_e, e)
        busy += cur_e - cur_s
        window = spans[-1][1] - spans[0][0]
        top = sorted(by_name.items(), key=lambda kv: -kv[1])[:12]
        result[plane.name] = {
            "lines": [ln.name for ln in lines],
            "window_ms": window / 1e6,
            "busy_ms": busy / 1e6,
            "idle_share": 1.0 - busy / window if window else None,
            "spectrum_ms": spec_ns / 1e6,
            "outside_spectrum_ms": other_ns / 1e6,
            "outside_spectrum_share": other_ns / max(spec_ns + other_ns, 1),
            "top_ms": {k: v / 1e6 for k, v in top},
        }
    return result


def main():
    if jax.default_backend() != "gpu":
        raise SystemExit("trace_stretch.py measures the GPU; no GPU backend found")
    enable_persistent_compile_cache()
    dtype = jnp.float32
    tgt, truth = build_bench_target(dtype)
    lane = spectrum_lane(tgt.n_data)
    logp = lambda batch: log_posterior_batch(batch, tgt)
    state = init_ensemble(init_walker_batch(tgt, truth, NWALK, dtype), logp,
                          jax.random.PRNGKey(0))
    st, chain, _ = run_ensemble(state, logp, n_steps=NSTEPS, thin=NSTEPS)
    chain.block_until_ready()
    hlo = run_ensemble.lower(st, logp, n_steps=NSTEPS, thin=NSTEPS).compile().as_text()

    logdir = tempfile.mkdtemp(prefix="trace_stretch_")
    t0 = time.perf_counter()
    jax.profiler.start_trace(logdir)
    st, chain, _ = run_ensemble(st, logp, n_steps=NSTEPS, thin=NSTEPS)
    chain.block_until_ready()
    jax.profiler.stop_trace()
    wall = time.perf_counter() - t0
    path = max(glob.glob(os.path.join(logdir, "**", "*.xplane.pb"), recursive=True),
               key=os.path.getmtime)
    devices = reduce_trace(path, op_scopes(hlo))
    for name, d in devices.items():
        print(f"{name}: busy {d['busy_ms']:.3f} ms of {d['window_ms']:.3f} ms "
              f"(idle {d['idle_share']:.4f}); spectrum block {d['spectrum_ms']:.3f} ms, "
              f"outside {d['outside_spectrum_ms']:.3f} ms "
              f"({100 * d['outside_spectrum_share']:.2f}%)")
        for k, v in d["top_ms"].items():
            print(f"    {v:10.3f} ms  {k}")
    gpu = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True)
    print(json.dumps({
        "lane": lane, "nwalk": NWALK, "steps": NSTEPS, "traced_wall_s": wall,
        "gpu": gpu.stdout.strip(), "device_kind": jax.devices()[0].device_kind,
        "devices": devices,
    }))


if __name__ == "__main__":
    main()
