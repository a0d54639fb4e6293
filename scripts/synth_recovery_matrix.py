"""12-fixture synthetic-truth recovery matrix.

The reference's only ground truth is its bundled ``Data/synth_spec_{T1}_{T2}``
fixtures (SURVEY §4.1): composite binaries at T1 in {3850, 4200} against six
T2 values each, radii from the MIST track, 1% noise, fit with ``real_values``
truth overlays (mft6.py:3599-3642, 1558-1574).  Those fixtures were generated
from the BT-Settl grid (not shipped), so fitting the *files* is impossible
here; this script reproduces the VALIDATION they enabled — generate each
fixture's analog from our bundled synthetic model family at the same (T1, T2)
contrast range (``pipeline.make_synthetic_observation``, the reimplementation
of the reference generator), then run the REAL two-stage pipeline on each at
PRODUCTION accuracy dials and publish recovered-vs-injected in posterior-sigma
units.

Acceptance: every parameter within the 0.5 sigma north star
(BASELINE.md).  Run on a GPU:

    nohup python scripts/synth_recovery_matrix.py > /tmp/recovery.log 2>&1 &
"""
from __future__ import annotations

import json
import os
import shutil
import sys
import tempfile
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

# --cpu: run the sweep on the host (XLA path, exact-median arithmetic — the
# accuracy dials are kernel-only).  Validates the two-stage pipeline's truth
# recovery across the contrast range without a GPU; the default GPU run
# additionally exercises the production dials.  Must precede the jax import.
CPU_MODE = "--cpu" in sys.argv
if CPU_MODE:
    os.environ["JAX_PLATFORMS"] = "cpu"

import jax

if CPU_MODE:
    jax.config.update("jax_platforms", "cpu")

import jax.numpy as jnp
import numpy as np

REF = "/root/reference"
# the reference generator's two binary families (mft6.py:3599-3605); the
# 3600 fixture appears in Data/ alongside the commented list's 3625
T_PAIRS = ([(3850, t2) for t2 in (3025, 3225, 3425, 3600, 3625, 3800)]
           + [(4200, t2) for t2 in (3225, 3425, 3625, 3825, 4025, 4175)])
TRUTH_AV, TRUTH_PLX = 0.12, 2.0e-3
LABELS = ["T1", "T2", "Av", "R1", "R2/R1", "plx"]

PARAM_TEMPLATE = """### synthetic-truth recovery fixture
models synthetic
dirname {dirname}
fname synth_{t1}_{t2}
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
cerr [0.05,0.05]
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
nspec 2
ndust 0
nburn 1000
nsteps 10000
real_values [{real}]
bps_dir {bps}
data_dir {ref}
"""


def main():
    print(f"devices: {jax.devices()}", flush=True)
    from mcmc_spec_tpu.models.mist import MistTable
    from mcmc_spec_tpu.pipeline import (
        make_synthetic_observation,
        run_mcmc_stage,
        run_optimize_stage,
        setup_context,
    )
    from mcmc_spec_tpu.utils.config import FitConfig

    mist = MistTable.builtin()
    work = tempfile.mkdtemp(prefix="recovery_")
    os.chdir(work)
    wl_template = os.path.join(REF, "koi2298_HET.txt")

    def write_param(t1, t2, datafile, cmag, pmag, truth):
        path = os.path.join(work, f"param_synth_{t1}_{t2}.txt")
        with open(path, "w") as fh:
            fh.write(PARAM_TEMPLATE.format(
                dirname=f"fit_{t1}_{t2}", t1=t1, t2=t2, datafile=datafile,
                cmag=",".join(f"{v:.4f}" for v in np.atleast_1d(cmag)),
                pmag=",".join(f"{v:.4f}" for v in np.atleast_1d(pmag)),
                plx=TRUTH_PLX, av=TRUTH_AV,
                real=",".join(f"{v:.6g}" for v in truth),
                bps=os.path.join(REF, "bps"), ref=REF,
            ))
        return path

    rows = []
    t_start = time.perf_counter()
    for i, (t1, t2) in enumerate(T_PAIRS):
        r1 = float(mist.get_radius(t1))
        r2 = float(mist.get_radius(t2))
        truth = np.array([t1, t2, TRUTH_AV, r1, r2 / r1, TRUTH_PLX])

        # phase 1: context on the HET wavelength grid, synthesize the fixture
        p0 = write_param(t1, t2, wl_template, [1.0, 1.0],
                         [14.0, 13.5, 13.2, 12.2, 11.7, 11.6], truth)
        ctx = setup_context(FitConfig.from_file(p0))
        synth_file = os.path.join(work, f"synth_spec_{t1}_{t2}.txt")
        make_synthetic_observation(
            ctx, [t1, t2], rad1=r1, ratios=[r2 / r1], plx=TRUTH_PLX,
            out_path=synth_file, noise_frac=0.01, seed=100 + i, av=TRUTH_AV)
        # observed contrasts/photometry = forward at truth + obs noise
        from mcmc_spec_tpu.inference.posterior import forward_summary

        summ = forward_summary(
            jnp.asarray(truth, ctx.target.data_flux.dtype), ctx.target)
        rng = np.random.RandomState(200 + i)
        cmag = np.asarray(summ["contrasts"]) + rng.normal(0, 0.02, 2)
        pmag = np.asarray(summ["phot_mags"]) + rng.normal(0, 0.02, 6)

        # phase 2: the real fixture fit, production dials
        parfile = write_param(t1, t2, synth_file, cmag, pmag, truth)
        ctx = setup_context(FitConfig.from_file(parfile))
        run_optimize_stage(ctx)
        samples = run_mcmc_stage(ctx, nthin=100, check_convergence=True,
                                 mesh=None)
        med = np.median(samples, axis=0)
        sig = samples.std(axis=0)
        shift = (med - truth) / sig
        rows.append(dict(t1=t1, t2=t2,
                         shift=[round(float(s), 3) for s in shift],
                         sigma=[float(s) for s in sig]))
        print(f"[{i+1:2d}/12] T1={t1} T2={t2}: max|shift| "
              f"{np.max(np.abs(shift)):.3f} sigma  "
              + " ".join(f"{l}={s:+.2f}" for l, s in zip(LABELS, shift)),
              flush=True)

    print(f"\ntotal wall: {time.perf_counter()-t_start:.0f}s")
    # Acceptance is CALIBRATION, not per-draw proximity: recovered-vs-injected
    # at one noise realization scatters at ~1 posterior sigma BY CONSTRUCTION
    # (the 0.5-sigma north star is posterior-vs-REFERENCE parity, BASELINE.md
    # line 24 — a different quantity, enforced by the RefEmulator suites).
    # A calibrated pipeline shows per-parameter z = (median-truth)/sigma with
    # mean ~0 (no systematic bias; tolerance 3/sqrt(12) standard errors) and
    # std ~1 (honest error bars) across the 12 independent noise seeds.
    Z = np.array([r["shift"] for r in rows])  # [12, 6]
    worst = float(np.max(np.abs(Z)))
    print(f"worst |z| across 12 fixtures x 6 params: {worst:.3f} "
          f"(max of 72 N(0,1) draws expects ~2.5)")
    ok = True
    for j, lab in enumerate(LABELS):
        m, s = float(np.mean(Z[:, j])), float(np.std(Z[:, j]))
        bias_ok = abs(m) < 3.0 * max(s, 0.3) / np.sqrt(len(rows))
        # The failure mode that breaks science is OVERCONFIDENT error bars
        # (std z >> 1: the quoted sigma is smaller than the actual scatter).
        # std z << 1 is NOT failed: it means conservative or prior-dominated
        # widths — plx's z spread is structurally tiny by construction
        # (truth sits at the Gaia prior mean and the 2.5% prior dominates
        # the posterior), and a conservative width costs precision, not
        # correctness.  It is annotated so it can't pass silently.
        width_ok = s < 1.8
        note = " [conservative/prior-dominated width]" if s < 0.4 else ""
        ok &= bias_ok and width_ok
        print(f"  {lab:>6}: mean z {m:+.3f} (bias {'ok' if bias_ok else 'FAIL'}), "
              f"std z {s:.3f} ({'ok' if width_ok else 'FAIL'}){note}")
    print("calibration: " + ("PASS" if ok else "FAIL"))
    print(json.dumps(rows))
    shutil.rmtree(work, ignore_errors=True)


if __name__ == "__main__":
    main()
