"""Production fleet + sharded pipeline: N param files -> per-target artifacts.

Runs on the 8-device virtual CPU mesh (conftest).  Verifies that
``run_mcmc_stage`` shards walkers over a mesh, and the fleet entry
point fits several targets in one jitted program, writing each target's
reference-format artifact set, with posterior medians matching the
single-device run within Monte-Carlo error.
"""
import os

import numpy as np
import jax
import jax.numpy as jnp
import pytest

TRUTH = dict(t1=4600.0, t2=3400.0, av=0.12, r1=0.72, rr2=0.45, plx=2.0e-3)


def _write_param_file(tmp_path, datafile, cmag, pmag, dirname, name, bps_dir):
    content = f"""### fleet fixture
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
cmag [{cmag[0]:.4f},{cmag[1]:.4f}]
cerr [0.05,0.05]
cfilt ['lp600','Kp']
pmag [{','.join(f'{m:.4f}' for m in pmag)}]
perr [0.05,0.05,0.05,0.05,0.05,0.05]
pfilt ['sdss,r','sdss,i','sdss,z','j','h','k']
plx {TRUTH['plx']}
plx_err 0.05e-3
dist_fit True
av {TRUTH['av']}
av_err 0.01
ra 288.456118
dec 45.802226
nwalk 24
nstep 30
nspec 2
ndust 0
nburn 40
nsteps 400
bps_dir {bps_dir}
"""
    path = tmp_path / f"param_synth_{name}.txt"
    path.write_text(content)
    return str(path)


@pytest.fixture(scope="module")
def fleet_fixture(tmp_path_factory, bps_dir):
    """Two synthetic targets with different data lengths (forces padding)."""
    tmp_path = tmp_path_factory.mktemp("fleet")
    os.chdir(tmp_path)

    from mcmc_spec_tpu.pipeline import setup_context, run_optimize_stage
    from mcmc_spec_tpu.utils.config import FitConfig
    from mcmc_spec_tpu.report.composite import composite_full
    from mcmc_spec_tpu.ops.extinction import ccm89
    from mcmc_spec_tpu.inference.posterior import forward_summary

    rng = np.random.RandomState(7)
    p_truth = np.array([TRUTH["t1"], TRUTH["t2"], TRUTH["av"], TRUTH["r1"],
                        TRUTH["rr2"], TRUTH["plx"]])

    parfiles = []
    for i, npts in enumerate([900, 1100]):  # ragged data lengths
        wl_um = np.linspace(0.650, 0.838, npts)
        datafile = str(tmp_path / f"synth_obs_{i}.txt")
        np.savetxt(datafile, np.column_stack(
            [wl_um, np.ones_like(wl_um), 0.01 * np.ones_like(wl_um)]))
        par0 = _write_param_file(tmp_path, datafile, [1.0, 1.0],
                                 [14.0, 13.5, 13.2, 12.2, 11.7, 11.6],
                                 dirname=f"seed{i}", name=f"t{i}", bps_dir=bps_dir)
        ctx0 = setup_context(FitConfig.from_file(par0), dtype=jnp.float64)

        w, comp, _ = composite_full(ctx0.grid, ctx0.mist, p_truth, 2)
        comp = comp * 10 ** (-0.4 * np.asarray(ccm89(w, TRUTH["av"])))
        flux = np.interp(wl_um * 1e4, w, comp)
        err = 0.01 * flux
        np.savetxt(datafile, np.column_stack([wl_um, flux + rng.normal(0, err), err]))

        summ = forward_summary(jnp.asarray(p_truth), ctx0.target)
        parfiles.append(_write_param_file(
            tmp_path, datafile, np.asarray(summ["contrasts"]),
            np.asarray(summ["phot_mags"]), dirname=f"fit{i}", name=f"t{i}",
            bps_dir=bps_dir))

    # one shared optimize stage seeds all the MCMC variants below
    cfg = FitConfig.from_file(parfiles[0])
    ctx = setup_context(cfg, dtype=jnp.float64)
    run_optimize_stage(ctx, record_thin=100)
    p0 = np.genfromtxt(os.path.join("fit0", "optimize_res.txt"))
    chis = np.genfromtxt(os.path.join("fit0", "optimize_cs.txt"))
    p0 = p0[np.argsort(chis)][:16]
    return dict(tmp_path=tmp_path, parfiles=parfiles, p_truth=p_truth, p0=p0)


class TestShardedMcmcStage:
    def test_auto_mesh_resolution(self):
        from mcmc_spec_tpu.pipeline import resolve_mesh

        assert len(jax.devices()) == 8  # conftest virtual mesh
        mesh = resolve_mesh("auto", 32)  # 32 % (2*8) == 0 -> all 8 devices
        assert mesh is not None and mesh.devices.size == 8
        mesh = resolve_mesh("auto", 24)  # 24 % 16 != 0 -> largest fit is 6
        assert mesh is not None and mesh.devices.size == 6
        assert resolve_mesh(None, 32) is None
        mesh = resolve_mesh("auto", 6)  # halves of 3 shard over 3 devices
        assert mesh is not None and mesh.devices.size == 3
        assert resolve_mesh("auto", 2) is None  # too few walkers to shard

    def test_sharded_matches_single_device(self, fleet_fixture):
        """Medians from mesh='auto' and mesh=None agree within MC error."""
        from mcmc_spec_tpu.pipeline import run_mcmc_stage, setup_context
        from mcmc_spec_tpu.utils.config import FitConfig

        truth = fleet_fixture["p_truth"]
        p0 = fleet_fixture["p0"]
        results = {}
        for tag, mesh in [("sharded", "auto"), ("single", None)]:
            cfg = FitConfig.from_file(fleet_fixture["parfiles"][0])
            cfg.dirname = f"fit0_{tag}"
            ctx = setup_context(cfg, dtype=jnp.float64)
            results[tag] = run_mcmc_stage(
                ctx, p0=p0, nthin=50, check_convergence=False,
                resume=False, mesh=mesh)
        med_m = np.median(results["sharded"], axis=0)
        med_s = np.median(results["single"], axis=0)
        sig = results["single"].std(axis=0) + 1e-12
        for i in range(6):
            assert abs(med_m[i] - truth[i]) < 5 * sig[i], (i, med_m[i], truth[i])
            assert abs(med_m[i] - med_s[i]) < 5 * sig[i], (i, med_m[i], med_s[i])
        # artifacts written by the sharded run
        assert os.path.exists("fit0_sharded/samples.txt")
        assert not os.path.isdir("fit0_sharded/chain_chunks")  # cleaned up

    def test_sharded_resume_bit_identical(self, fleet_fixture, monkeypatch):
        """Interrupt a sharded run mid-chain; the resumed chain is identical."""
        from mcmc_spec_tpu import pipeline
        from mcmc_spec_tpu.pipeline import run_mcmc_stage, setup_context
        from mcmc_spec_tpu.utils.config import FitConfig

        p0 = fleet_fixture["p0"]

        def make_ctx(dirname):
            cfg = FitConfig.from_file(fleet_fixture["parfiles"][0])
            cfg.dirname = dirname
            cfg.nsteps = 200
            ctx = setup_context(cfg, dtype=jnp.float64)
            return ctx

        s_full = run_mcmc_stage(make_ctx("fit0_uninterrupted"), p0=p0, nthin=50,
                                check_convergence=False, resume=False, mesh="auto")

        # interrupt after 2 of 4 chunks: dump_coords raises on the 3rd
        ctx = make_ctx("fit0_interrupted")
        real_dump = pipeline.results_io.dump_coords
        calls = {"n": 0}

        def exploding_dump(dirname, fname, step, coords, stage="results"):
            if stage == "results":
                calls["n"] += 1
                if calls["n"] == 3:
                    raise RuntimeError("simulated crash")
            return real_dump(dirname, fname, step, coords, stage=stage)

        monkeypatch.setattr(pipeline.results_io, "dump_coords", exploding_dump)
        with pytest.raises(RuntimeError, match="simulated crash"):
            run_mcmc_stage(ctx, p0=p0, nthin=50, check_convergence=False,
                           resume=False, mesh="auto")
        monkeypatch.setattr(pipeline.results_io, "dump_coords", real_dump)

        assert os.path.exists("fit0_interrupted/chain_checkpoint.npz")
        assert os.path.isdir("fit0_interrupted/chain_chunks")
        s_resumed = run_mcmc_stage(make_ctx("fit0_interrupted"), p0=p0, nthin=50,
                                   check_convergence=False, resume=True, mesh="auto")
        np.testing.assert_allclose(s_resumed, s_full, rtol=1e-12)
        assert not os.path.exists("fit0_interrupted/chain_checkpoint.npz")

    def test_resume_with_sparse_checkpoint_cadence(self, fleet_fixture,
                                                   monkeypatch):
        """checkpoint_every=2 must still resume bit-identically: every chunk
        reaches the store regardless of the snapshot cadence (a cadence > 1
        used to leave store gaps that a resume silently concatenated
        around, dropping half the pre-crash chain)."""
        from mcmc_spec_tpu import pipeline
        from mcmc_spec_tpu.pipeline import run_mcmc_stage, setup_context
        from mcmc_spec_tpu.utils.config import FitConfig

        p0 = fleet_fixture["p0"]

        def make_ctx(dirname):
            cfg = FitConfig.from_file(fleet_fixture["parfiles"][0])
            cfg.dirname = dirname
            cfg.nsteps = 200
            return setup_context(cfg, dtype=jnp.float64)

        s_full = run_mcmc_stage(make_ctx("fitck2_uninterrupted"), p0=p0,
                                nthin=50, check_convergence=False,
                                resume=False, checkpoint_every=2)

        # crash during chunk 4's dump: 3 chunks written, last snapshot at
        # chunk 2 (step 100) -- chunks 0..2 must ALL be in the store
        ctx = make_ctx("fitck2_interrupted")
        real_dump = pipeline.results_io.dump_coords
        calls = {"n": 0}

        def exploding_dump(dirname, fname, step, coords, stage="results"):
            if stage == "results":
                calls["n"] += 1
                if calls["n"] == 4:
                    raise RuntimeError("simulated crash")
            return real_dump(dirname, fname, step, coords, stage=stage)

        monkeypatch.setattr(pipeline.results_io, "dump_coords", exploding_dump)
        with pytest.raises(RuntimeError, match="simulated crash"):
            run_mcmc_stage(ctx, p0=p0, nthin=50, check_convergence=False,
                           resume=False, checkpoint_every=2)
        monkeypatch.setattr(pipeline.results_io, "dump_coords", real_dump)

        from mcmc_spec_tpu.io.results import ChainStore
        assert ChainStore("fitck2_interrupted").chunk_ids() == [0, 1, 2]
        s_resumed = run_mcmc_stage(make_ctx("fitck2_interrupted"), p0=p0,
                                   nthin=50, check_convergence=False,
                                   resume=True, checkpoint_every=2)
        np.testing.assert_allclose(s_resumed, s_full, rtol=1e-12)

    def test_fleet_pipeline_artifacts(self, fleet_fixture):
        """Fleet over two padded targets writes both artifact sets; medians ok."""
        from mcmc_spec_tpu.fleet_pipeline import run_fleet

        out = run_fleet(fleet_fixture["parfiles"], optimize=True, emcee=True,
                        noplots=True, dtype=jnp.float64, nthin=50)
        truth = fleet_fixture["p_truth"]
        assert len(out) == 2
        for (ctx, samples), d in zip(out, ["fit0", "fit1"]):
            assert os.path.exists(os.path.join(d, "samples.txt"))
            assert os.path.exists(os.path.join(d, "optimize_res.txt"))
            assert os.path.exists(
                os.path.join(d, f"{ctx.cfg.fname}_autocorr.txt"))
            med = np.median(samples, axis=0)
            sig = samples.std(axis=0) + 1e-12
            for i in range(6):
                assert abs(med[i] - truth[i]) < 5 * sig[i], (d, i, med[i], truth[i])
            # the streamed samples.txt round-trips bit-identically — the
            # production return_samples=False mode reports from this file
            from mcmc_spec_tpu.io.results import read_samples

            np.testing.assert_array_equal(read_samples(d), samples)

    def test_fleet_mesh_resolution(self):
        from mcmc_spec_tpu.fleet_pipeline import resolve_fleet_mesh

        mesh = resolve_fleet_mesh("auto", ntgt=2, nw=16)
        assert mesh is not None
        assert mesh.shape["targets"] == 2 and mesh.shape["walkers"] == 4
        mesh = resolve_fleet_mesh("auto", ntgt=8, nw=6)
        assert mesh is not None and mesh.shape["targets"] == 8
        assert resolve_fleet_mesh(None, 2, 16) is None

    def test_fleet_mismatch_raises(self, fleet_fixture):
        from mcmc_spec_tpu.fleet_pipeline import setup_fleet
        from mcmc_spec_tpu.utils.config import FitConfig

        cfg_a = FitConfig.from_file(fleet_fixture["parfiles"][0])
        cfg_b = FitConfig.from_file(fleet_fixture["parfiles"][1])
        cfg_b.tmax = 5200  # different grid shape
        cfg_b.dirname = "fit1_mismatch"
        with pytest.raises(ValueError, match="fleet targets must match"):
            setup_fleet([cfg_a, cfg_b], dtype=jnp.float64)


class TestOrbaxPipelineResume:
    def test_orbax_resume_bit_identical(self, fleet_fixture, monkeypatch):
        """Same interrupted-resume flow with the orbax checkpoint backend."""
        from mcmc_spec_tpu import pipeline
        from mcmc_spec_tpu.pipeline import run_mcmc_stage, setup_context
        from mcmc_spec_tpu.utils.config import FitConfig

        monkeypatch.setenv("MCMC_SPEC_CKPT_BACKEND", "orbax")
        p0 = fleet_fixture["p0"]

        def make_ctx(dirname):
            cfg = FitConfig.from_file(fleet_fixture["parfiles"][0])
            cfg.dirname = dirname
            cfg.nsteps = 200
            ctx = setup_context(cfg, dtype=jnp.float64)
            return ctx

        s_full = run_mcmc_stage(make_ctx("fito_uninterrupted"), p0=p0, nthin=50,
                                check_convergence=False, resume=False, mesh="auto")

        ctx = make_ctx("fito_interrupted")
        real_dump = pipeline.results_io.dump_coords
        calls = {"n": 0}

        def exploding_dump(dirname, fname, step, coords, stage="results"):
            if stage == "results":
                calls["n"] += 1
                if calls["n"] == 3:
                    raise RuntimeError("simulated crash")
            return real_dump(dirname, fname, step, coords, stage=stage)

        monkeypatch.setattr(pipeline.results_io, "dump_coords", exploding_dump)
        with pytest.raises(RuntimeError, match="simulated crash"):
            run_mcmc_stage(ctx, p0=p0, nthin=50, check_convergence=False,
                           resume=False, mesh="auto")
        monkeypatch.setattr(pipeline.results_io, "dump_coords", real_dump)

        assert os.path.isdir("fito_interrupted/chain_checkpoint.npz.orbax")
        s_resumed = run_mcmc_stage(make_ctx("fito_interrupted"), p0=p0, nthin=50,
                                   check_convergence=False, resume=True,
                                   mesh="auto")
        np.testing.assert_allclose(s_resumed, s_full, rtol=1e-12)
        assert not os.path.isdir("fito_interrupted/chain_checkpoint.npz.orbax")


class TestFleetResume:
    """VERDICT r2 item 3: the fleet MCMC stage gets the same ChainStore +
    config-tagged checkpoint treatment as the single-target stage, and warns
    instead of silently min()-ing mismatched schedules."""

    def test_schedule_mismatch_warning(self, fleet_fixture, capsys):
        from mcmc_spec_tpu.fleet_pipeline import _warn_fleet_schedule_mismatch
        from mcmc_spec_tpu.utils.config import FitConfig

        cfg_a = FitConfig.from_file(fleet_fixture["parfiles"][0])
        cfg_b = FitConfig.from_file(fleet_fixture["parfiles"][1])
        _warn_fleet_schedule_mismatch([cfg_a, cfg_b])
        assert "WARNING" not in capsys.readouterr().out  # identical schedules

        cfg_b.nsteps = 15000
        _warn_fleet_schedule_mismatch([cfg_a, cfg_b])
        out = capsys.readouterr().out
        assert "WARNING" in out and "nsteps" in out and "SHORTEST" in out

    def test_fleet_resume_bit_identical(self, fleet_fixture, monkeypatch):
        """Crash a fleet run mid-chain; the resumed chains are identical."""
        from mcmc_spec_tpu import fleet_pipeline
        from mcmc_spec_tpu.fleet_pipeline import run_fleet_mcmc, setup_fleet
        from mcmc_spec_tpu.utils.config import FitConfig

        p0 = fleet_fixture["p0"][:16]
        p0s = [p0, p0]

        def make_ctxs(suffix):
            cfgs = []
            for i, pf in enumerate(fleet_fixture["parfiles"]):
                cfg = FitConfig.from_file(pf)
                cfg.dirname = f"fleet{i}_{suffix}"
                cfg.nsteps = 200
                cfgs.append(cfg)
            return setup_fleet(cfgs, dtype=jnp.float64)

        full = run_fleet_mcmc(make_ctxs("full"), p0s=p0s, nthin=50,
                              check_convergence=False, mesh=None, resume=False)

        ctxs = make_ctxs("crash")
        real_dump = fleet_pipeline.results_io.dump_coords
        calls = {"n": 0}

        def exploding_dump(dirname, fname, step, coords, stage="results"):
            if stage == "results":
                calls["n"] += 1
                if calls["n"] == 5:  # 2 targets/chunk: dies in chunk 3 of 4
                    raise RuntimeError("simulated crash")
            return real_dump(dirname, fname, step, coords, stage=stage)

        monkeypatch.setattr(fleet_pipeline.results_io, "dump_coords", exploding_dump)
        with pytest.raises(RuntimeError, match="simulated crash"):
            run_fleet_mcmc(ctxs, p0s=p0s, nthin=50, check_convergence=False,
                           mesh=None, resume=False)
        monkeypatch.setattr(fleet_pipeline.results_io, "dump_coords", real_dump)

        assert os.path.exists("fleet0_crash/fleet_chain_checkpoint.npz")
        assert os.path.isdir("fleet0_crash/fleet_chain_chunks")
        resumed = run_fleet_mcmc(make_ctxs("crash"), p0s=p0s, nthin=50,
                                 check_convergence=False, mesh=None, resume=True)
        for r, f in zip(resumed, full):
            np.testing.assert_allclose(r, f, rtol=1e-12)
        # completed run cleans up its fleet checkpoint + chunk store
        assert not os.path.exists("fleet0_crash/fleet_chain_checkpoint.npz")
        assert not os.path.isdir("fleet0_crash/fleet_chain_chunks")

    def test_stale_config_tag_ignored(self, fleet_fixture, monkeypatch):
        """A checkpoint from a different fleet config must not be resumed."""
        from mcmc_spec_tpu.fleet_pipeline import run_fleet_mcmc, setup_fleet
        from mcmc_spec_tpu.io import results as results_io
        from mcmc_spec_tpu.utils.config import FitConfig

        p0 = fleet_fixture["p0"][:16]
        cfgs = []
        for i, pf in enumerate(fleet_fixture["parfiles"]):
            cfg = FitConfig.from_file(pf)
            cfg.dirname = f"fleet{i}_stale"
            cfg.nsteps = 100
            cfgs.append(cfg)
        ctxs = setup_fleet(cfgs, dtype=jnp.float64)
        os.makedirs("fleet0_stale", exist_ok=True)
        results_io.save_checkpoint(results_io.Checkpoint(
            coords=np.zeros((2, 16, 6)), log_prob=np.zeros((2, 16)),
            key=np.asarray(jax.random.PRNGKey(0)), step=50, n_accept=0,
            config_tag="fleet:other:2x16x6:999:40:0:1.0",
        ), "fleet0_stale/fleet_chain_checkpoint.npz")
        out = run_fleet_mcmc(ctxs, p0s=[p0, p0], nthin=50,
                             check_convergence=False, mesh=None, resume=True)
        # ran from scratch (2 chunks of 50 x 16 walkers each)
        assert out[0].shape[0] == 100 * 16


class TestShardedCollectiveStructure:
    """Structural multi-chip receipt: the compiled sharded step must contain
    ONLY the designed collectives — the complement all-gather (one per
    red/black half-update) and the acceptance-count psum — and no
    all-to-all / collective-permute / cross-replica reduce of array data.
    This is checkable on the virtual CPU mesh even though real multi-chip
    hardware is unavailable (SURVEY parallelism table; scaling-book recipe:
    annotate shardings, let XLA insert collectives, then VERIFY what it
    inserted)."""

    def test_compiled_sharded_step_collectives(self, fleet_fixture):
        import jax

        from mcmc_spec_tpu.inference.batched import log_posterior_batch
        from mcmc_spec_tpu.parallel.mesh import make_mesh
        from mcmc_spec_tpu.parallel.sharding import (
            run_ensemble_sharded,
            shard_ensemble_state,
        )
        from mcmc_spec_tpu.pipeline import setup_context
        from mcmc_spec_tpu.utils.config import FitConfig

        cfg = FitConfig.from_file(fleet_fixture["parfiles"][0])
        cfg.dirname = "fit0_hlo"
        ctx = setup_context(cfg, dtype=jnp.float64)
        tgt = ctx.target
        mesh = make_mesh(8, ("walkers",))
        p0 = np.asarray(fleet_fixture["p0"][:32], dtype=np.float64)
        logp = lambda b: log_posterior_batch(b, tgt)
        state = shard_ensemble_state(jnp.asarray(p0), logp, jax.random.PRNGKey(0), mesh)

        lowered = jax.jit(
            lambda s: run_ensemble_sharded(s, logp, mesh, n_steps=4, thin=4)
        ).lower(state)
        hlo = lowered.compile().as_text()
        # the two designed collectives appear...
        assert "all-gather" in hlo
        # ...and nothing unplanned: no all-to-all or collective-permute
        # (DCN-hostile patterns the walker layout is designed to avoid)
        assert "all-to-all" not in hlo
        assert "collective-permute-start" not in hlo.replace(
            "collective-permute-done", "")
