"""BASELINE config 5 end to end: all nine bundled KOI spectra in one program.

The reference fits one KOI per process invocation (SURVEY.md parallelism
table); this benchmark drives the PRODUCTION fleet pipeline — real HET
spectra from the reference's ``Data/`` directory (telluric-masked, windowed,
median-normalised by the loader), per-target grids/packing, stage-1
annealing, a 4096-walker stretch-move fleet MCMC with per-chunk
checkpointing, and per-target ``samples.txt`` artifact sets — and reports
the wall-clock split per stage.

Observations (contrast + photometry) are synthesised from a nominal binary
forward model per target: the per-step COST is identical to a real fit and
that is what the benchmark measures; posterior values are not the point
here (see tests/test_koi2298.py and the parity suites for correctness).

Needs the reference's ``Data/`` directory (``REF`` below; it is not in
this repository).  Run on a GPU:
    python benchmarks/bench_fleet_e2e.py
"""
from __future__ import annotations

import glob
import json
import os
import shutil
import sys
import tempfile
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax
import jax.numpy as jnp
import numpy as np

REF = "/root/reference"
NWALK_MCMC = 4096
NBURN, NSTEPS, NTHIN = int(os.environ.get("E2E_NBURN", 300)), int(os.environ.get("E2E_NSTEPS", 2000)), 100

PARAM_TEMPLATE = """### config-5 fleet benchmark target
models synthetic
dirname {dirname}
fname {name}
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
plx 2.0e-3
plx_err 0.05e-3
dist_fit True
av 0.12
av_err 0.01
ra 290.667
dec 44.5
nwalk 150
nstep 40
nspec 2
ndust 0
nburn {nburn}
nsteps {nsteps}
bps_dir {bps}
data_dir {ref}
"""


def main():
    print(f"devices: {jax.devices()}", flush=True)
    spectra = sorted(glob.glob(os.path.join(REF, "Data", "koi*.txt")))
    spectra += [os.path.join(REF, "koi2298_HET.txt")]
    assert len(spectra) == 9, spectra

    work = tempfile.mkdtemp(prefix="fleet_e2e_")
    os.chdir(work)

    from mcmc_spec_tpu.fleet_pipeline import run_fleet_mcmc, run_fleet_optimize, setup_fleet
    from mcmc_spec_tpu.inference.posterior import forward_summary
    from mcmc_spec_tpu.pipeline import seed_from_optimize, setup_context
    from mcmc_spec_tpu.utils.config import FitConfig

    truth = np.array([4600.0, 3400.0, 0.12, 0.72, 0.45, 2.0e-3])

    def write_param(i, spec, cmag, pmag):
        name = os.path.basename(spec).split("_")[0].replace(".txt", "")
        path = os.path.join(work, f"param_{name}_{i}.txt")
        with open(path, "w") as fh:
            fh.write(PARAM_TEMPLATE.format(
                dirname=f"fit_{name}_{i}", name=f"{name}", datafile=spec,
                cmag=",".join(f"{v:.4f}" for v in cmag),
                pmag=",".join(f"{v:.4f}" for v in pmag),
                nburn=NBURN, nsteps=NSTEPS, bps=os.path.join(REF, "bps"), ref=REF,
            ))
        return path

    t0 = time.perf_counter()
    # synthesize per-target observations from a nominal forward eval
    parfiles = []
    for i, spec in enumerate(spectra):
        p0 = write_param(i, spec, [1.0, 1.0], [14.0, 13.5, 13.2, 12.2, 11.7, 11.6])
        ctx = setup_context(FitConfig.from_file(p0))
        summ = forward_summary(jnp.asarray(truth, ctx.target.data_flux.dtype), ctx.target)
        parfiles.append(write_param(i, spec, np.asarray(summ["contrasts"]),
                                    np.asarray(summ["phot_mags"])))
    t_obs = time.perf_counter() - t0

    t0 = time.perf_counter()
    ctxs = setup_fleet(parfiles)
    t_setup = time.perf_counter() - t0

    t0 = time.perf_counter()
    run_fleet_optimize(ctxs)
    t_opt = time.perf_counter() - t0

    # widen the stage-1 seeds to the production 4096-walker ensembles
    rng = np.random.RandomState(0)
    p0s = []
    for ctx in ctxs:
        seeds = seed_from_optimize(ctx)
        reps = -(-NWALK_MCMC // len(seeds))
        p = np.tile(seeds, (reps, 1))[:NWALK_MCMC]
        p0s.append(p * (1 + 1e-4 * rng.randn(*p.shape)))

    t0 = time.perf_counter()
    out = run_fleet_mcmc(ctxs, p0s=p0s, nthin=NTHIN, check_convergence=True,
                         mesh=None, resume=False)
    t_mcmc = time.perf_counter() - t0

    n_steps_done = out[0].shape[0] // NWALK_MCMC
    evals = 9 * NWALK_MCMC * (NBURN + n_steps_done)
    for ctx in ctxs:
        assert os.path.exists(os.path.join(ctx.cfg.dirname, "samples.txt"))
    print(json.dumps({
        "metric": "config5_fleet_end_to_end_wall_clock",
        "value": round(t_obs + t_setup + t_opt + t_mcmc, 2),
        "unit": f"s (9 real KOI spectra x {NWALK_MCMC} walkers, {NBURN} burn + "
                f"{n_steps_done} sampled steps incl. compile/IO)",
        "split": {"synth_obs": round(t_obs, 1), "setup": round(t_setup, 1),
                  "optimize": round(t_opt, 1), "mcmc": round(t_mcmc, 1)},
        "sampled_evals_per_sec": round(evals / t_mcmc, 1),
    }))
    shutil.rmtree(work, ignore_errors=True)


if __name__ == "__main__":
    main()
