"""Command-line driver: ``python -m mcmc_spec_tpu.cli -f paramfile -o True -e True``.

Flag-compatible with the reference CLI (``mft6.py:3450-3456``, README):
``-f`` parameter file, ``-o`` run the optimize stage, ``-e`` run the MCMC
stage.  Extensions: ``--nospec`` reproduces ``mft6_nospec.py`` as a flag
instead of a file fork (spectrum chi^2 weight -> 0), ``--noplots`` skips
report rendering, ``--dtype`` selects the device precision, ``--mesh``
controls multi-device sharding (``auto`` default / ``off`` / ``WxS`` — an
explicit 2-D walkers-by-spec mesh that also shards the wavelength axis of
the packed target, for grids larger than one chip's HBM), and repeating
``-f`` fits all the named targets as one fleet in a single jitted program
(the reference runs one process per KOI).
"""
from __future__ import annotations

import getopt
import sys

import jax.numpy as jnp

from mcmc_spec_tpu.pipeline import (
    run_mcmc_stage,
    run_optimize_stage,
    setup_context,
)
from mcmc_spec_tpu.utils.config import FitConfig


def main(argv=None):
    argv = sys.argv if argv is None else argv
    opts, _ = getopt.getopt(
        argv[1:], "f:o:e:",
        ["file=", "optimize=", "emcee=", "nospec", "noplots", "dtype=", "mesh=",
         "data-dir=", "grid-dir=", "bps-dir="],
    )
    parfiles, do_opt, do_emcee = [], "False", "False"
    nospec, noplots, dtype, mesh = False, False, jnp.float32, "auto"
    overrides = {}
    for key, val in opts:
        if key in ("-f", "--file"):
            parfiles.append(val)
        elif key in ("-o", "--optimize"):
            do_opt = val
        elif key in ("-e", "--emcee"):
            do_emcee = val
        elif key == "--nospec":
            nospec = True
        elif key == "--noplots":
            noplots = True
        elif key == "--data-dir":
            overrides["data_dir"] = val  # base dir for relative data paths
        elif key == "--grid-dir":
            overrides["grid_dir"] = val  # BT-Settl / PHOENIX model directory
        elif key == "--bps-dir":
            overrides["bps_dir"] = val  # filter transmission curves
        elif key == "--dtype":
            dtype = {"float32": jnp.float32, "float64": jnp.float64}[val]
        elif key == "--mesh":
            # auto (1-D walker mesh), off, or WxS (2-D walkers x spec mesh —
            # spectral model parallelism for grids larger than one chip's HBM)
            from mcmc_spec_tpu.parallel.mesh import parse_wxs

            low = val.lower()
            if low in ("auto", "off", "none"):
                mesh = "auto" if low == "auto" else None
            else:
                try:
                    wxs = parse_wxs(low)
                except ValueError as e:
                    raise SystemExit(f"--mesh: {e}")
                if wxs is None:
                    raise SystemExit(
                        f"--mesh must be 'auto', 'off', or WxS (e.g. 4x2), got {val!r}"
                    )
                mesh = low
    if not parfiles:
        raise SystemExit(
            "usage: -f paramfile [-f paramfile2 ...] [-o True|False] "
            "[-e True|False] [--nospec] [--mesh auto|off|WxS]"
        )

    if not noplots:
        # fail before any compute, not after the fit, when plots can't render
        from mcmc_spec_tpu.utils.extras import require

        require("matplotlib", "plots", hint="or pass --noplots")

    # before the first dispatch: repeat runs of the same config skip
    # compilation entirely
    from mcmc_spec_tpu.utils.flags import enable_persistent_compile_cache

    enable_persistent_compile_cache()

    cfgs = [FitConfig.from_file(p) for p in parfiles]
    if nospec:
        for cfg in cfgs:
            cfg.spectrum_weight = 0.0
    for attr, val in overrides.items():
        for cfg in cfgs:
            setattr(cfg, attr, val)

    from mcmc_spec_tpu.parallel.mesh import parse_wxs

    wxs_mode = isinstance(mesh, str) and parse_wxs(mesh) is not None

    if len(cfgs) > 1:
        if wxs_mode:
            # fleet mode shards (targets, walkers); composing the spec axis
            # on top is a documented scope limit (PARITY.md) — fail with the
            # same clean SystemExit as every other --mesh error instead of
            # run_fleet's raw ValueError traceback
            raise SystemExit(
                f"--mesh: {mesh!r} (walkers x spec) is single-target only; "
                "fleet mode shards (targets, walkers) — run WxS fits one "
                "target at a time (see PARITY.md, fleet x spec scope note)"
            )
        from mcmc_spec_tpu.fleet_pipeline import run_fleet

        run_fleet(
            cfgs,
            optimize=(do_opt == "True"),
            emcee=(do_emcee == "True"),
            noplots=noplots,
            dtype=dtype,
            mesh=mesh,
            # production-memory mode: the chain streams to samples.txt and
            # reports re-read per target — peak RSS is one chunk, not the
            # full fleet chain (the CLI discards the return value anyway)
            return_samples=False,
        )
        return

    # WxS mesh + bad walker counts must error NOW, not after the optimize
    # stage has run to completion (pipeline.check_wxs_stage_counts)
    from mcmc_spec_tpu.pipeline import check_wxs_stage_counts

    try:
        check_wxs_stage_counts(
            cfgs[0].nwalk, mesh, do_opt == "True", do_emcee == "True")
    except ValueError as e:
        raise SystemExit(f"--mesh: {e}")

    # WxS: keep the packed target on HOST so the full grid projection is
    # never committed to one device — shard_target_over_spec then sends each
    # chip only its wavelength shard (the whole point of spectral sharding)
    ctx = setup_context(cfgs[0], dtype=dtype, stage_on_device=not wxs_mode)

    if do_opt == "True":
        run_optimize_stage(ctx, mesh=mesh)
        if not noplots:
            from mcmc_spec_tpu.report.plots import plot_fit

            plot_fit(ctx)

    if do_emcee == "True":
        samples = run_mcmc_stage(ctx, mesh=mesh)
        if not noplots:
            from mcmc_spec_tpu.report.plots import plot_corner, plot_results

            plot_corner(ctx, samples)
            plot_results(ctx, samples)


if __name__ == "__main__":
    main()
