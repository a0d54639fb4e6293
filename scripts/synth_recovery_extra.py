"""Triple + nospec truth-recovery lanes.

The round-4 recovery matrix (``synth_recovery_matrix.py``) covers the
binary layout only; the triple (ndim-8) and nospec (spectrum_weight=0)
configurations are fully plumbed and pipeline-tested but had no
truth-recovery lane.  This script runs ONE fixture of each through the
full two-stage production pipeline at production schedules and reports
recovered-vs-injected z-scores:

* **triple** — (T1, T2, T3) composite generated by
  ``make_synthetic_observation`` (the reference generator supports a
  third component, mft6.py:3604), radii from the MIST track, 1% spectrum
  noise + 0.02 mag observation noise.
* **nospec** — the same binary generator, fit with ``spectrum_weight=0``
  (mft6_nospec.py:1174-1196 semantics: photometry + contrasts + priors
  only, plx prior capped at 1/100).  Temperatures are constrained by
  SED colors alone, so posteriors are broad — the z-scores check
  CALIBRATION (honest widths), not precision.

Acceptance (matrix convention): per-parameter z across the independent
noise seeds must show no systematic bias (|mean z| small) and no
overconfident widths; a single |z| ~ 2.5-3 among 8 params x N seeds is an
ordinary N(0,1) tail draw, not a failure.  Run on a GPU:

    nohup python scripts/synth_recovery_extra.py > /tmp/r5/recovery_extra.log 2>&1 &
"""
from __future__ import annotations

import json
import os
import shutil
import sys
import tempfile
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

CPU_MODE = "--cpu" in sys.argv
if CPU_MODE:
    os.environ["JAX_PLATFORMS"] = "cpu"

import jax

if CPU_MODE:
    jax.config.update("jax_platforms", "cpu")

import jax.numpy as jnp
import numpy as np

REF = "/root/reference"
TRUTH_AV, TRUTH_PLX = 0.12, 2.0e-3

PARAM_TEMPLATE = """### synthetic-truth recovery fixture ({tag})
models synthetic
dirname {dirname}
fname synth_{tag}
res 1700
tmin 3000
tmax 5600
specmin 3000
specmax 30000
mask True
rad_prior False
filename {datafile}
spmin 0.645
spmax 0.84
cmag [{cmag}]
cerr [{cerr}]
cfilt ['lp600','Kp']
pmag [{pmag}]
perr [0.05,0.05,0.05,0.05,0.05,0.05]
pfilt ['sdss,r','sdss,i','sdss,z','j','h','k']
plx {plx}
plx_err 0.05e-3
dist_fit True
av {av}
av_err 0.05
ra 290.667
dec 44.5
nwalk 150
nstep 60
nspec {nspec}
ndust 0
nburn 1000
nsteps 10000
real_values [{real}]
bps_dir {bps}
data_dir {ref}
"""


def run_fixture(tag, teffs, nospec=False, seed=7):
    from mcmc_spec_tpu.inference.posterior import forward_summary
    from mcmc_spec_tpu.models.mist import MistTable
    from mcmc_spec_tpu.pipeline import (
        make_synthetic_observation,
        run_mcmc_stage,
        run_optimize_stage,
        setup_context,
    )
    from mcmc_spec_tpu.utils.config import FitConfig

    mist = MistTable.builtin()
    nspec = len(teffs)
    radii = [float(mist.get_radius(t)) for t in teffs]
    ratios = [r / radii[0] for r in radii[1:]]
    truth = np.array(list(map(float, teffs)) + [TRUTH_AV, radii[0]]
                     + ratios + [TRUTH_PLX])
    labels = ([f"T{i+1}" for i in range(nspec)] + ["Av", "R1"]
              + [f"R{i+2}/R1" for i in range(nspec - 1)] + ["plx"])

    work = os.getcwd()
    wl_template = os.path.join(REF, "koi2298_HET.txt")

    def write_param(datafile, cmag, pmag):
        path = os.path.join(work, f"param_{tag}.txt")
        cm = np.atleast_1d(cmag)
        with open(path, "w") as fh:
            fh.write(PARAM_TEMPLATE.format(
                tag=tag, dirname=f"fit_{tag}", datafile=datafile,
                cmag=",".join(f"{v:.4f}" for v in cm),
                cerr=",".join("0.05" for _ in cm),
                pmag=",".join(f"{v:.4f}" for v in np.atleast_1d(pmag)),
                plx=TRUTH_PLX, av=TRUTH_AV, nspec=nspec,
                real=",".join(f"{v:.6g}" for v in truth),
                bps=os.path.join(REF, "bps"), ref=REF,
            ))
        return path

    # phase 1: synthesize the fixture on the HET wavelength grid
    p0 = write_param(wl_template, [1.0] * (nspec - 1),
                     [14.0, 13.5, 13.2, 12.2, 11.7, 11.6])
    cfg = FitConfig.from_file(p0)
    if nospec:
        cfg.spectrum_weight = 0.0
    ctx = setup_context(cfg)
    synth_file = os.path.join(work, f"synth_spec_{tag}.txt")
    make_synthetic_observation(
        ctx, teffs, rad1=radii[0], ratios=ratios, plx=TRUTH_PLX,
        out_path=synth_file, noise_frac=0.01, seed=seed, av=TRUTH_AV)
    summ = forward_summary(
        jnp.asarray(truth, ctx.target.data_flux.dtype), ctx.target)
    rng = np.random.RandomState(seed + 100)
    cmag = np.asarray(summ["contrasts"]) + rng.normal(0, 0.02, nspec - 1)
    pmag = np.asarray(summ["phot_mags"]) + rng.normal(0, 0.02, 6)

    # phase 2: the real two-stage fit at production dials
    parfile = write_param(synth_file, cmag, pmag)
    cfg = FitConfig.from_file(parfile)
    if nospec:
        cfg.spectrum_weight = 0.0
    ctx = setup_context(cfg)
    t0 = time.perf_counter()
    run_optimize_stage(ctx)
    samples = run_mcmc_stage(ctx, nthin=100, check_convergence=True,
                             mesh=None)
    wall = time.perf_counter() - t0
    med = np.median(samples, axis=0)
    sig = samples.std(axis=0)
    shift = (med - truth) / sig
    # mode diagnostic: is the recovered mode a genuinely better fit of this
    # noise draw (landscape multi-modality — the posterior PREFERS it) or a
    # worse one (sampler failure)?  One batched eval at truth + median.
    from mcmc_spec_tpu.inference.batched import log_posterior_batch

    pts = jnp.asarray(np.stack([truth, med]), ctx.target.data_flux.dtype)
    lp_truth, lp_med = np.asarray(log_posterior_batch(pts, ctx.target))
    print(f"[{tag}] wall {wall:.0f}s  max|z| {np.max(np.abs(shift)):.3f}  "
          f"logpost(median)-logpost(truth)={lp_med - lp_truth:+.2f}  "
          + " ".join(f"{l}={s:+.2f}" for l, s in zip(labels, shift)),
          flush=True)
    return dict(tag=tag, labels=labels,
                dlogpost_med_minus_truth=round(float(lp_med - lp_truth), 3),
                truth=[float(v) for v in truth],
                median=[float(v) for v in med],
                sigma=[float(v) for v in sig],
                z=[round(float(s), 3) for s in shift],
                wall_s=round(wall, 1))


def main():
    print(f"devices: {jax.devices()}", flush=True)
    work = tempfile.mkdtemp(prefix="recovery_extra_")
    os.chdir(work)
    rows = []
    for seed in (7, 17, 27):
        rows.append(run_fixture(f"triple_4200_3625_3100_s{seed}",
                                (4200, 3625, 3100), seed=seed))
    for seed in (8, 18, 28):
        rows.append(run_fixture(f"nospec_3850_3625_s{seed}", (3850, 3625),
                                nospec=True, seed=seed))

    ok = True
    for lane in ("triple", "nospec"):
        lrows = [r for r in rows if r["tag"].startswith(lane)]
        Z = np.array([r["z"] for r in lrows])  # [nseed, nparam]
        labels = lrows[0]["labels"]
        n = len(lrows)
        print(f"\n[{lane}] per-parameter z over {n} seeds:")
        for j, lab in enumerate(labels):
            m, s = float(np.mean(Z[:, j])), float(np.std(Z[:, j]))
            # bias: |mean| within 3 standard errors of the seed scatter
            # (floored at 0.3 as the matrix does for prior-dominated params)
            bias_ok = abs(m) < 3.0 * max(s, 0.3) / np.sqrt(n)
            width_ok = float(np.max(np.abs(Z[:, j]))) < 3.5
            ok &= bias_ok and width_ok
            print(f"  {lab:>6}: mean z {m:+.3f} ({'ok' if bias_ok else 'FAIL'}),"
                  f" max |z| {np.max(np.abs(Z[:, j])):.3f}"
                  f" ({'ok' if width_ok else 'FAIL'})")
    print("\ncalibration: " + ("PASS" if ok else "FAIL"))
    print(json.dumps(rows))
    os.chdir("/")
    shutil.rmtree(work, ignore_errors=True)


if __name__ == "__main__":
    main()
