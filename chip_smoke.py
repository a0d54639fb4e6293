#!/usr/bin/env python
"""On-GPU smoke test of the binary-star fit: the main path, end to end.

    python chip_smoke.py           # phases a-e on one GPU
    python chip_smoke.py --four    # the multi-device paths on 4 GPUs (phase f)

Phases, one after another in this one process:

a. device: JAX's default backend must be ``gpu``;
b. inputs: a koi2298-shaped binary fit (nd 1,792, 14x4 synthetic grid, 2
   contrast filters, 6 photometric bands) written from a seed into a
   temporary directory — filter curves, data spectrum, param file;
c. CLI fit: ``mcmc_spec_tpu.cli.main`` with ``-o True -e True --noplots``
   (150 annealer walkers, so 50 emcee walkers); artifacts, sample shape and
   posterior medians are checked;
d. hot-path parity: ``log_posterior_batch`` (emcee convention) and
   ``optimizer_chi2_batch`` (annealer convention) for 32,768 walkers in f32
   on the card against the same functions in float64 and against the
   scalar reference ``inference.posterior`` vmapped over the first 1,024
   walkers, at the exact median; the count-median lane (the one that
   honours the fast-median dial) at 31 passes against the float64 sort
   lane, and at the default 14 passes its implied median error against the
   bracket bound; and beyond ``flags.LARGE_ND`` (nd 8,192, 8,192 walkers)
   the composition's dispatch to the count-median lane, both conventions,
   against the float64 sort lane;
e. fleet parity: ``log_posterior_fleet`` for 9 padded targets x 4,096
   walkers against the vmapped float64 composition.

``--four`` (4 GPUs) runs only the multi-device paths: the CLI fit with
``--mesh auto`` and with ``--mesh 2x2``, then the fleet on a 2x2 (targets x
walkers) mesh; each log-posterior on identical coordinates is compared with
the single-device result at the phase-d tolerance.

Every result line names the card (``nvidia-smi`` name and power limit).
The last line of standard output is one JSON object; it is printed only
when every phase passed.  Exits non-zero otherwise, and when no GPU is
found.
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import os
import subprocess
import sys
import tempfile
import time
import traceback

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

RTOL = 5e-5  # the lane tolerance of tests/test_spectrum_lanes.py
ATOL_FRAC = 1e-4  # atol = ATOL_FRAC * max|ref| over the finite entries
NWALK_D = 32768
NSCALAR = 1024
NWALK_LARGE = 8192  # walkers of the beyond-LARGE_ND dispatch check
FLEET_ND = (1792, 1700, 1600, 1792, 1500, 1750, 1650, 1792, 1550)
FLEET_NW = 4096
GPU = ""


def say(msg: str) -> None:
    print(f"[{GPU}] {msg}", flush=True)


def gpu_name() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True)
    return out.stdout.strip().splitlines()[0]


def compare(name: str, got, ref) -> float:
    """Phase-d tolerance on finite entries; the -inf masks must match.

    Returns the worst relative error (against max(|ref|, atol))."""
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    if got.shape != ref.shape:
        raise AssertionError(f"{name}: shape {got.shape} != {ref.shape}")
    fin = np.isfinite(ref)
    if not np.array_equal(np.isfinite(got), fin):
        raise AssertionError(f"{name}: finite masks differ at "
                             f"{int((np.isfinite(got) != fin).sum())} entries")
    if not fin.any():
        raise AssertionError(f"{name}: no finite entries")
    atol = ATOL_FRAC * np.abs(ref[fin]).max()
    err = np.abs(got[fin] - ref[fin])
    np.testing.assert_allclose(got[fin], ref[fin], rtol=RTOL, atol=atol,
                               err_msg=name)
    worst = float(np.max(err / np.maximum(np.abs(ref[fin]), atol)))
    say(f"{name}: {int(fin.sum())}/{fin.size} finite, worst rel err {worst:.3e} "
        f"(rtol {RTOL}, atol {atol:.3e})")
    return worst


def to32(tree):
    import jax
    import jax.numpy as jnp

    return jax.tree.map(
        lambda x: x.astype(jnp.float32)
        if hasattr(x, "dtype") and jnp.issubdtype(x.dtype, jnp.floating) else x, tree)


@contextlib.contextmanager
def phase(name: str, results: dict):
    t0 = time.perf_counter()
    say(f"phase {name} ...")
    try:
        yield
    except Exception:
        traceback.print_exc()
        results[name] = "FAILED"
        say(f"phase {name} FAILED after {time.perf_counter() - t0:.1f} s")
    else:
        results[name] = "ok"
        say(f"phase {name} ok in {time.perf_counter() - t0:.1f} s")


# ------------------------------------------------------------------ phases
def make_inputs(path: str, nwalk: int) -> str:
    from mcmc_spec_tpu.bench_target import write_fit_inputs

    return write_fit_inputs(path, nwalk=nwalk, nstep=200, nburn=200, nsteps=1000,
                            seed=0)


def cli_fit(paramfile: str, mesh: str | None = None) -> dict:
    """Run the CLI fit and check its artifacts; returns stage wall times."""
    from mcmc_spec_tpu.cli import main as cli_main
    from mcmc_spec_tpu.utils.config import FitConfig
    from mcmc_spec_tpu.utils.runlog import read_run_log

    cfg = FitConfig.from_file(paramfile)
    argv = ["mcmc_spec_tpu.cli", "-f", paramfile, "-o", "True", "-e", "True",
            "--noplots"]
    if mesh:
        argv += ["--mesh", mesh]
    t0 = time.perf_counter()
    cli_main(argv)
    total = time.perf_counter() - t0
    for art in ("optimize_res.txt", "optimize_cs.txt", "samples.txt"):
        if not os.path.exists(os.path.join(cfg.dirname, art)):
            raise AssertionError(f"missing artifact {art}")
    samples = np.genfromtxt(os.path.join(cfg.dirname, "samples.txt"))
    if samples.ndim != 2 or samples.shape[1] != 6:
        raise AssertionError(f"samples.txt shape {samples.shape}, want (n, 6)")
    med = np.median(samples, axis=0)
    for i, name in ((0, "T1"), (1, "T2")):
        if not cfg.tmin <= med[i] <= cfg.tmax:
            raise AssertionError(f"posterior median {name}={med[i]:.1f} outside "
                                 f"[{cfg.tmin}, {cfg.tmax}]")
    opt = [e for e in read_run_log(cfg.dirname) if e["event"] == "optimize.end"]
    walls = {"cli_total_s": total,
             "optimize_s": opt[-1]["wall_s"] if opt else None}
    say(f"CLI fit (mesh={mesh or 'auto'}): {samples.shape[0]} samples, medians "
        f"T1 {med[0]:.1f} K, T2 {med[1]:.1f} K; wall {total:.1f} s "
        f"(optimize stage {walls['optimize_s']} s, the rest is setup + MCMC)")
    return walls


def bench_targets():
    """(f64 target, f32 copy, truth) at the bench.py shape."""
    import jax.numpy as jnp

    from mcmc_spec_tpu.bench_target import build_bench_target

    tgt64, truth = build_bench_target(jnp.float64)
    return tgt64, to32(tgt64), truth


def hot_path_parity():
    import jax
    import jax.numpy as jnp

    from mcmc_spec_tpu.bench_target import init_walker_batch
    from mcmc_spec_tpu.inference import batched, posterior
    from mcmc_spec_tpu.ops.spec_segmented import spectrum_chi2_segmented
    from mcmc_spec_tpu.utils.flags import spectrum_lane

    tgt64, tgt32, truth = bench_targets()
    nT, nG, nd = tgt32.D.shape
    say(f"target nd={nd}, NO={nT * nG}, walkers={NWALK_D}, lane="
        f"{spectrum_lane(nd)}; f32 on the card, references in "
        f"float64 with Precision.HIGHEST")
    c32 = init_walker_batch(tgt32, truth, NWALK_D, jnp.float32)
    c64 = c32.astype(jnp.float64)
    exact32 = dataclasses.replace(tgt32, median_iters=31)  # MCMC_SPEC_FAST_MEDIAN=exact

    fns = {
        "emcee": (batched.log_posterior_batch, posterior.log_posterior),
        "annealer": (batched.optimizer_chi2_batch, posterior.optimizer_chi2),
    }
    worst = {}
    for conv, (fb, fs) in fns.items():
        got = jax.jit(fb)(c32, exact32)
        ref = jax.jit(fb)(c64, tgt64)
        worst[f"{conv}_vs_f64"] = compare(f"{conv} f32 card vs f64 composition", got, ref)
        sref = jax.jit(jax.vmap(fs, in_axes=(0, None)))(c64[:NSCALAR], tgt64)
        worst[f"{conv}_vs_scalar"] = compare(
            f"{conv} f32 card vs f64 scalar reference", got[:NSCALAR], sref)

    # default 14 passes through the count-median lane: the chi^2 scales as
    # alpha^2 = (med_data/med)^2, so chi31/chi14 = (med14/med_exact)^2 gives
    # the lane's median error, bounded by the middle-order-statistic gap +
    # a 2^(8-14) relative bracket
    *_, W = batched._forward_small(c32, tgt32)
    av = c32[:, tgt32.nspec]
    args = (W, av, tgt32.D.reshape(nT * nG, nd), tgt32.ext_k_data, tgt32.data_flux,
            tgt32.data_err, tgt32.V, tgt32.Vpinv, tgt32.med_data, tgt32.n_data_true)
    chi14 = np.asarray(spectrum_chi2_segmented(*args, iters=14), np.float64)
    chi31 = np.asarray(spectrum_chi2_segmented(*args, iters=31), np.float64)
    *_, W64 = batched._forward_small(c64, tgt64)
    worst["count31_vs_f64"] = compare(
        "count lane (31 passes) f32 card vs f64 sort lane", chi31,
        jax.jit(batched._spec_chi2_xla)(W64, c64[:, tgt64.nspec], tgt64))
    model = W64 @ tgt64.D.reshape(nT * nG, nd)
    trans = jnp.where(c64[:, 2:3] > 0,
                      10.0 ** (-0.4 * c64[:, 2:3] * tgt64.ext_k_data[None, :]), 1.0)
    srt = np.sort(np.asarray(model * trans), axis=1)
    lo, hi = srt[:, (nd - 1) // 2], srt[:, nd // 2]
    med = 0.5 * (lo + hi)
    err = np.abs(np.sqrt(chi31 / chi14) - 1.0) * med
    bound = (hi - lo) + 2.0 ** (8 - 14) * med + 1e-5 * med  # + f32 rounding
    ratio = float(np.max(err / bound))
    if not ratio <= 1.0:
        raise AssertionError(f"14-pass median error exceeds its bound (worst ratio {ratio:.3f})")
    worst["median14_err_over_bound"] = ratio
    say(f"14-pass count median: worst implied error / bracket bound = {ratio:.4f} "
        f"(max relative median error {float(np.max(err / med)):.3e})")
    worst.update(large_nd_dispatch())
    return worst


def large_nd_dispatch():
    """Beyond LARGE_ND the composition must take the count-median lane."""
    import jax
    import jax.numpy as jnp

    from mcmc_spec_tpu.bench_target import build_bench_target, init_walker_batch
    from mcmc_spec_tpu.inference import batched
    from mcmc_spec_tpu.utils.flags import LARGE_ND, spectrum_lane

    nd = 2 * LARGE_ND
    if spectrum_lane(nd) != "segmented":
        raise AssertionError(f"nd {nd}: lane {spectrum_lane(nd)!r}, want 'segmented'")
    tgt64, truth = build_bench_target(jnp.float64, nd=nd)
    tgt32 = dataclasses.replace(to32(tgt64), median_iters=31)
    c32 = init_walker_batch(tgt32, truth, NWALK_LARGE, jnp.float32)
    c64 = c32.astype(jnp.float64)
    *_, W32 = batched._forward_small(c32, tgt32)
    *_, W64 = batched._forward_small(c64, tgt64)
    say(f"nd={nd} > LARGE_ND={LARGE_ND}, walkers={NWALK_LARGE}, lane "
        f"{spectrum_lane(nd)}; references: the float64 sort lane")
    worst = {}
    dispatch = jax.jit(batched._spec_chi2, static_argnames="renorm")
    for conv, renorm, ref_fn in (
            ("emcee", True, batched._spec_chi2_xla),
            ("annealer", False, batched._spec_chi2_xla_median_only)):
        got = dispatch(W32, c32[:, tgt32.nspec], tgt32, renorm=renorm)
        ref = jax.jit(ref_fn)(W64, c64[:, tgt64.nspec], tgt64)
        worst[f"large_nd_{conv}_vs_f64"] = compare(
            f"nd {nd} {conv} spectrum chi2 f32 card vs f64 sort lane", got, ref)
    return worst


def fleet_members(dtype, n: int | None = None):
    """(fleet, f32 coords) at the phase-e shape, packed in ``dtype``."""
    import jax.numpy as jnp

    from mcmc_spec_tpu.bench_target import build_bench_target, init_walker_batch
    from mcmc_spec_tpu.inference.fleet import stack_targets

    nds = FLEET_ND[:n] if n else FLEET_ND
    members, coords = [], []
    for i, nd in enumerate(nds):
        t, truth = build_bench_target(dtype, nd=nd, seed=i, pad_nd=max(FLEET_ND))
        members.append(dataclasses.replace(t, median_iters=31))
        coords.append(init_walker_batch(t, truth, FLEET_NW, jnp.float32, seed=i + 1))
    return stack_targets(members), jnp.stack(coords)


def fleet_parity():
    import jax

    from mcmc_spec_tpu.inference.batched import log_posterior_batch
    from mcmc_spec_tpu.inference.fleet import log_posterior_fleet

    import jax.numpy as jnp

    fleet64, c32 = fleet_members(jnp.float64)
    fleet32, c64 = to32(fleet64), c32.astype(jnp.float64)
    say(f"fleet {c32.shape[0]} targets x {c32.shape[1]} walkers, n_data_true "
        f"{np.asarray(fleet32.n_data_true).tolist()} padded to {fleet32.n_data}")
    got = jax.jit(log_posterior_fleet)(c32, fleet32)
    ref = jax.jit(jax.vmap(log_posterior_batch))(c64, fleet64)
    return {"fleet_vs_f64": compare("fleet f32 card vs f64 vmapped composition", got, ref)}


def four_device_paths(workdir: str):
    """--mesh auto, --mesh 2x2 and a 2x2 fleet mesh against one device."""
    import jax
    import jax.numpy as jnp
    from jax import shard_map
    from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

    from mcmc_spec_tpu.bench_target import TRUTH, init_walker_batch
    from mcmc_spec_tpu.inference.batched import log_posterior_batch
    from mcmc_spec_tpu.inference.fleet import init_fleet_ensemble, log_posterior_fleet
    from mcmc_spec_tpu.parallel.spec_shard import make_spec_logpost
    from mcmc_spec_tpu.pipeline import _EnsembleDriver, resolve_mesh, setup_context
    from mcmc_spec_tpu.utils.config import FitConfig

    if len(jax.devices()) < 4:
        raise AssertionError(f"--four needs 4 devices, have {len(jax.devices())}")
    worst = {}
    # 168 annealer walkers -> 56 emcee walkers: divisible by 2*4 (auto) and by
    # 2*2 (a 2x2 walkers x spec mesh), so both meshes really shard
    # one input directory per fit, so neither run sees the other's results
    paramfiles = {m: make_inputs(os.path.join(workdir, f"fit_{m}"), 168)
                  for m in ("auto", "2x2")}
    # exact median: the spec-sharded path computes it exactly at any setting
    tgt = dataclasses.replace(
        setup_context(FitConfig.from_file(paramfiles["auto"]), dtype=jnp.float32).target,
        median_iters=31)
    coords = init_walker_batch(tgt, TRUTH, 56, jnp.float32)
    single = jax.jit(log_posterior_batch)(jax.device_put(coords, jax.devices()[0]), tgt)
    logp = lambda b: log_posterior_batch(b, tgt)
    for mesh in ("auto", "2x2"):
        cli_fit(paramfiles[mesh], mesh=mesh)
        m = resolve_mesh(mesh, coords.shape[0])
        if m is None or m.devices.size != 4:
            raise AssertionError(f"--mesh {mesh} did not resolve to 4 devices: {m}")
        # the per-shard evaluation the sharded samplers run every step
        if mesh == "auto":
            f = jax.jit(shard_map(logp, mesh=m, in_specs=P("walkers"),
                                  out_specs=P("walkers"), check_vma=False))
            got = f(coords)
        else:
            tgt_sp = _EnsembleDriver(logp, m, target=tgt).tgt_sp
            got = make_spec_logpost(tgt_sp, m, walker_axis="walkers")(coords, tgt_sp)
        worst[f"mesh_{mesh}"] = compare(f"--mesh {mesh} {dict(m.shape)} vs one device",
                                        jax.device_get(got), single)

    fleet32, c32 = fleet_members(jnp.float32, 8)  # 8 targets: the 2x2 mesh divides them
    one = jax.jit(log_posterior_fleet)(jax.device_put(c32, jax.devices()[0]), fleet32)
    mesh2 = Mesh(np.asarray(jax.devices()[:4]).reshape(2, 2), ("targets", "walkers"))
    sharded = jax.device_put(c32, NamedSharding(mesh2, P("targets", "walkers")))
    state = init_fleet_ensemble(sharded, fleet32, jax.random.PRNGKey(1))
    worst["fleet_2x2"] = compare("fleet on a 2x2 (targets x walkers) mesh vs one device",
                                 jax.device_get(state.log_prob), one)
    return worst


def main():
    global GPU
    ap = argparse.ArgumentParser(description="On-GPU smoke test of the fit path.")
    ap.add_argument("--four", action="store_true",
                    help="run only the multi-device paths, on 4 GPUs")
    args = ap.parse_args()

    import jax

    from mcmc_spec_tpu.utils.flags import enable_persistent_compile_cache

    if jax.default_backend() != "gpu":
        print(f"chip_smoke: no GPU backend (JAX runs on {jax.default_backend()!r})",
              file=sys.stderr)
        return 1
    GPU = gpu_name()
    say(f"phase a: backend gpu, {len(jax.devices())} x {jax.devices()[0].device_kind}; "
        f"compile cache {enable_persistent_compile_cache()}")

    results, worst = {}, {}
    start_dir = os.getcwd()
    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as workdir:
        os.chdir(workdir)  # the pipeline keeps its grid cache in the cwd
        try:
            if args.four:
                with phase("f", results):
                    worst.update(four_device_paths(workdir))
            else:
                paramfile = None
                with phase("b", results):
                    paramfile = make_inputs(os.path.join(workdir, "fit"), 150)
                with phase("c", results):
                    if paramfile is None:
                        raise RuntimeError("no inputs from phase b")
                    worst.update(cli_fit(paramfile))
                # the float64 references need x64; the CLI fit above ran without it
                jax.config.update("jax_enable_x64", True)
                with phase("d", results):
                    worst.update(hot_path_parity())
                with phase("e", results):
                    worst.update(fleet_parity())
        finally:
            os.chdir(start_dir)
    say(f"phases {results}")
    say(f"numbers {json.dumps(worst)}")
    if any(v != "ok" for v in results.values()):
        return 1
    print(f"gpu: {GPU}")
    dev = jax.devices()[0]
    print(json.dumps({"ok": True, "device": {"platform": dev.platform,
                                             "kind": dev.device_kind,
                                             "count": len(jax.devices())}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
