"""CLI smoke test: the reference-compatible entry point, in a subprocess."""
import os
import subprocess
import sys

import numpy as np
import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _cpu_env():
    env = dict(os.environ)
    env["JAX_PLATFORMS"] = "cpu"
    return env


def test_cli_optimize_and_emcee(tmp_path, bps_dir):
    rng = np.random.RandomState(0)
    wl = np.linspace(0.652, 0.838, 400)
    # crude composite-ish data: framework only needs a well-formed file here
    flux = (1 + 0.05 * np.sin(wl * 40)) * 1e-15
    err = 0.01 * flux
    datafile = tmp_path / "obs.txt"
    np.savetxt(datafile, np.column_stack([wl, flux + rng.normal(0, err), err]))

    paramfile = tmp_path / "param_smoke.txt"
    paramfile.write_text(f"""### smoke test
models synthetic
dirname {tmp_path}/run
fname smoke
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
cmag [2.0,1.3]
cerr [0.1,0.1]
cfilt ['lp600','Kp']
pmag [14.0,13.5,13.2,12.2,11.7,11.6]
perr [0.1,0.1,0.1,0.1,0.1,0.1]
pfilt ['sdss,r','sdss,i','sdss,z','j','h','k']
plx 2.0e-3
plx_err 0.1e-3
dist_fit True
av 0.1
av_err 0.05
ra 288.0
dec 45.0
nwalk 12
nstep 20
nspec 2
ndust 0
nburn 20
nsteps 60
real_values [0,0,0,0,0,0]
bps_dir {bps_dir}
""")

    out = subprocess.run(
        [sys.executable, "-m", "mcmc_spec_tpu.cli", "-f", str(paramfile),
         "-o", "True", "-e", "True", "--noplots"],
        capture_output=True, text=True, timeout=900, env=_cpu_env(), cwd=REPO,
    )
    assert out.returncode == 0, out.stderr[-3000:]
    assert "optimization complete" in out.stdout
    assert "Mean acceptance fraction" in out.stdout

    run = tmp_path / "run"
    for art in ["optimize_res.txt", "optimize_cs.txt", "samples.txt"]:
        assert (run / art).exists(), art
    # a completed run cleans up its resume checkpoint
    assert not (run / "chain_checkpoint.npz").exists()
    samples = np.genfromtxt(run / "samples.txt")
    assert samples.shape[1] == 6


def test_cli_fleet_rejects_wxs_mesh(tmp_path):
    # fleet mode (-f a -f b) with an explicit WxS mesh must exit with the
    # clean SystemExit usage error BEFORE any compute — not surface
    # resolve_fleet_mesh's raw ValueError traceback from inside run_fleet.
    # No data files are needed: the check precedes config use.
    paramfile = tmp_path / "param_a.txt"
    paramfile.write_text("models synthetic\nfname a\ndirname x\n")
    out = subprocess.run(
        [sys.executable, "-m", "mcmc_spec_tpu.cli", "-f", str(paramfile),
         "-f", str(paramfile), "-o", "True", "--mesh", "2x2"],
        capture_output=True, text=True, timeout=300, env=_cpu_env(), cwd=REPO,
    )
    assert out.returncode != 0
    assert "single-target only" in out.stderr
    assert "Traceback" not in out.stderr
