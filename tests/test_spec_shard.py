"""Spectral-axis (sp) sharding: parity on the 8-device virtual CPU mesh.

Validates parallel/spec_shard.py: the distributed radix-select median is
BIT-exact against sorted-rank semantics, the psum-composed log-posterior
matches the single-device XLA backend, post-pack nd padding reproduces
pack-time padding field-for-field, and the 2-D (walkers, spec) ensemble
chain is self-consistent and matches the walkers-only sampler.
"""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
from jax import shard_map
from jax.sharding import Mesh, PartitionSpec as P

from mcmc_spec_tpu.bench_target import build_bench_target, init_walker_batch
from mcmc_spec_tpu.inference.batched import log_posterior_batch
from mcmc_spec_tpu.parallel.spec_shard import (
    _dist_median_nonneg,
    make_spec_logpost,
    pad_packed_target_nd,
    run_ensemble_spec_sharded,
    shard_spec_ensemble_state,
    shard_target_over_spec,
    target_spec_tree,
)


def spec_mesh(n=8):
    return Mesh(np.array(jax.devices("cpu")[:n]), ("spec",))


def mesh_2d(w, s):
    return Mesh(np.array(jax.devices("cpu")[: w * s]).reshape(w, s),
                ("walkers", "spec"))


def _dist_median(model, n_true, mesh):
    f = shard_map(
        lambda m, n: _dist_median_nonneg(m, n, "spec"),
        mesh=mesh,
        in_specs=(P(None, "spec"), P()),
        out_specs=P(),
        check_vma=False,
    )
    return np.asarray(jax.jit(f)(jnp.asarray(model), jnp.asarray(n_true, jnp.int32)))


def _rank_median_f32(model, n_true):
    """Reference: the XLA backend's sorted-rank median (batched.py:127-131)."""
    srt = np.sort(model, axis=1)
    i0, i1 = (n_true - 1) // 2, n_true // 2
    return (np.float32(0.5) * (srt[:, i0] + srt[:, i1])).astype(np.float32)


class TestDistributedMedian:
    @pytest.mark.parametrize(
        "n_true,nd",
        [(240, 240), (239, 240), (200, 240), (201, 240), (2, 240), (1, 240)],
    )
    def test_bit_exact_vs_sorted_ranks(self, n_true, nd):
        rng = np.random.RandomState(7)
        model = rng.uniform(0.05, 8.0, (16, nd)).astype(np.float32)
        model[:, n_true:] = 1e30  # inert padding sentinel
        med = _dist_median(model, n_true, spec_mesh())
        assert np.array_equal(med, _rank_median_f32(model, n_true))

    def test_duplicates_and_zeros(self):
        rng = np.random.RandomState(3)
        model = rng.choice(
            np.array([0.0, 0.25, 1.0, 1.5, 3.0], np.float32), size=(12, 240)
        ).astype(np.float32)
        for n_true in (240, 201, 100):
            m = model.copy()
            m[:, n_true:] = 1e30
            med = _dist_median(m, n_true, spec_mesh())
            assert np.array_equal(med, _rank_median_f32(m, n_true))

    def test_float64_lane_bit_exact(self):
        # the x64 CPU test lane promotes sampler arithmetic to f64; the
        # median bisects the int64 bit range there (63 passes)
        rng = np.random.RandomState(5)
        for n_true in (240, 239):
            model = rng.uniform(0.05, 8.0, (8, 240))
            model[:, n_true:] = 1e30
            med = _dist_median(model, n_true, spec_mesh())
            srt = np.sort(model, axis=1)
            i0, i1 = (n_true - 1) // 2, n_true // 2
            assert np.array_equal(med, 0.5 * (srt[:, i0] + srt[:, i1]))

    def test_any_shard_count(self):
        rng = np.random.RandomState(11)
        model = rng.uniform(0.1, 2.0, (8, 240)).astype(np.float32)
        exp = _rank_median_f32(model, 240)
        for n in (1, 2, 4, 8):
            assert np.array_equal(_dist_median(model, 240, spec_mesh(n)), exp)


@pytest.fixture(scope="module")
def small_target():
    tgt, truth = build_bench_target(jnp.float32, nd=256, grid_step=8.0)
    coords = init_walker_batch(tgt, truth, 64, jnp.float32)
    return tgt, truth, coords


class TestSpecShardedLogPosterior:
    def test_matches_single_device_xla(self, small_target):
        tgt, _, coords = small_target
        ref = np.asarray(log_posterior_batch(coords, tgt))
        mesh = spec_mesh()
        tgt_sh = shard_target_over_spec(tgt, mesh)
        # target tensors really are sharded: each device holds nd/8 columns
        assert tgt_sh.D.addressable_shards[0].data.shape[2] == tgt.n_data // 8
        got = np.asarray(make_spec_logpost(tgt_sh, mesh)(coords, tgt_sh))
        assert np.all(np.isfinite(ref))
        np.testing.assert_allclose(got, ref, rtol=3e-5, atol=1e-4)

    def test_padded_target_matches_unpadded(self, small_target):
        tgt, _, coords = small_target
        ref = np.asarray(log_posterior_batch(coords, tgt))
        mesh = spec_mesh()
        padded = pad_packed_target_nd(tgt, 320)  # 320 = 8 * 40
        tgt_sh = shard_target_over_spec(padded, mesh)
        got = np.asarray(make_spec_logpost(tgt_sh, mesh)(coords, tgt_sh))
        np.testing.assert_allclose(got, ref, rtol=3e-5, atol=1e-4)

    def test_indivisible_nd_raises(self):
        tgt, _ = build_bench_target(jnp.float32, nd=250, grid_step=8.0)
        with pytest.raises(ValueError, match="not divisible"):
            shard_target_over_spec(tgt, spec_mesh())

    def test_walker_axis_hybrid(self, small_target):
        tgt, _, coords = small_target
        ref = np.asarray(log_posterior_batch(coords, tgt))
        mesh = mesh_2d(4, 2)
        tgt_sh = shard_target_over_spec(tgt, mesh)
        fn = make_spec_logpost(tgt_sh, mesh, walker_axis="walkers")
        got = np.asarray(fn(coords, tgt_sh))
        np.testing.assert_allclose(got, ref, rtol=3e-5, atol=1e-4)


class TestPadPackedTarget:
    def test_matches_pack_time_padding(self):
        base, _ = build_bench_target(jnp.float32, nd=250, grid_step=8.0)
        packed, _ = build_bench_target(jnp.float32, nd=250, grid_step=8.0,
                                       pad_nd=320)
        repad = pad_packed_target_nd(base, 320)
        assert repad.n_data == packed.n_data == 320
        assert int(repad.n_data_true) == int(packed.n_data_true) == 250
        for name in ("D", "data_flux", "data_err", "ext_k_data", "V", "Vpinv"):
            a, b = np.asarray(getattr(packed, name)), np.asarray(getattr(repad, name))
            assert np.array_equal(a, b, equal_nan=True), name

    def test_noop_and_shrink(self, ):
        tgt, _ = build_bench_target(jnp.float32, nd=256, grid_step=8.0)
        assert pad_packed_target_nd(tgt, 256) is tgt
        with pytest.raises(ValueError, match="<"):
            pad_packed_target_nd(tgt, 128)

    def test_padded_fields_are_host_arrays(self):
        # the padded fields must come back as HOST numpy so that
        # shard_target_over_spec's device_put sends each device only its
        # shard — the full padded D must never be staged on one device
        # (CLAUDE.md host-numpy rule; the module's larger-than-HBM purpose)
        tgt, _ = build_bench_target(jnp.float32, nd=250, grid_step=8.0)
        repad = pad_packed_target_nd(tgt, 320)
        for name in ("D", "data_flux", "data_err", "ext_k_data", "V", "Vpinv"):
            arr = getattr(repad, name)
            assert isinstance(arr, np.ndarray), f"{name} staged on device"
            assert arr.dtype == np.float32, name


class TestPipelineWiring:
    def test_resolve_mesh_wxs(self):
        from mcmc_spec_tpu.pipeline import resolve_mesh

        mesh = resolve_mesh("4x2", 64)
        assert mesh.axis_names == ("walkers", "spec")
        assert mesh.shape["walkers"] == 4 and mesh.shape["spec"] == 2
        with pytest.raises(ValueError, match="devices"):
            resolve_mesh("8x2", 64)  # only 8 virtual devices
        with pytest.raises(ValueError, match="walkers"):
            resolve_mesh("4x2", 60)  # 60 % (2*4) != 0
        with pytest.raises(ValueError, match="mesh must be"):
            resolve_mesh("banana", 64)

    def test_resolve_mesh_annealer_divisibility(self):
        # the annealer has no red/black halves: nwalk need only divide by W,
        # not 2*W — the default config's nwalk=150 must work on a 2xS mesh
        # (run_optimize_stage passes halves=False)
        from mcmc_spec_tpu.pipeline import resolve_mesh

        mesh = resolve_mesh("2x4", 150, halves=False)
        assert mesh.shape == {"walkers": 2, "spec": 4}
        with pytest.raises(ValueError, match="2\\*2"):
            resolve_mesh("2x4", 150)  # the MCMC stage still needs 2*W

    def test_malformed_wxs_clean_errors(self):
        # "0x2" / "4x" / "2x2x2" pass the digits-and-'x' shape check but
        # must raise a usable ValueError, not ZeroDivisionError / a raw
        # int() traceback (shared parse_wxs validates before parsing)
        from mcmc_spec_tpu.fleet_pipeline import resolve_fleet_mesh as fleet_resolve
        from mcmc_spec_tpu.pipeline import resolve_mesh

        for bad in ("0x2", "4x", "2x2x2", "2x0"):
            with pytest.raises(ValueError, match="mesh"):
                resolve_mesh(bad, 64)
            with pytest.raises(ValueError, match="mesh"):
                fleet_resolve(bad, 2, 64)
        # well-formed WxS is still rejected by fleet mode with the clear
        # single-target-only message
        with pytest.raises(ValueError, match="single-target"):
            fleet_resolve("4x2", 2, 64)

    def test_wxs_stage_counts_fail_fast(self):
        # with both stages requested, an MCMC seed count (max(nwalk//3, 2))
        # that can't divide over 2*W must error BEFORE the optimize stage
        # runs, not after it completes
        from mcmc_spec_tpu.pipeline import check_wxs_stage_counts

        # nwalk=24 -> seeds 8, 8 % (2*2) == 0: both stages fine on 2x4
        check_wxs_stage_counts(24, "2x4", True, True)
        # nwalk=150 -> seeds 50, 50 % 4 != 0: MCMC stage would die mid-run
        with pytest.raises(ValueError, match="seed"):
            check_wxs_stage_counts(150, "2x4", True, True)
        # annealer-only is fine at nwalk=150 (150 % 2 == 0)
        check_wxs_stage_counts(150, "2x4", True, False)
        # annealer walker count must divide by W
        with pytest.raises(ValueError, match="annealer"):
            check_wxs_stage_counts(151, "2x4", True, False)
        # non-WxS meshes and emcee-only runs are out of scope: no-op
        check_wxs_stage_counts(150, "auto", True, True)
        check_wxs_stage_counts(150, None, True, True)
        check_wxs_stage_counts(150, "2x4", False, True)

    def test_ensemble_driver_spec_mode(self, small_target):
        # the production MCMC stage's driver, spec mesh: init + run + flat
        # accessors all work, and the advanced log-probs recompute correctly
        from mcmc_spec_tpu.pipeline import _EnsembleDriver, resolve_mesh

        tgt, _, coords = small_target
        mesh = resolve_mesh("2x4", 64)
        logp = lambda q: log_posterior_batch(q, tgt)
        driver = _EnsembleDriver(logp, mesh, target=tgt)
        # nd=256 divides 4: padding helper left the target alone
        assert driver.tgt_sp.n_data == tgt.n_data
        state = driver.init(np.asarray(coords), jax.random.PRNGKey(0))
        state, chain = driver.run(state, n_steps=4, thin=2)
        assert chain.shape == (2, 64, tgt.ndim)
        flat = driver.coords(state)
        assert flat.shape == (64, tgt.ndim)
        np.testing.assert_allclose(
            driver.log_prob(state),
            np.asarray(log_posterior_batch(jnp.asarray(flat), tgt)),
            rtol=3e-5, atol=1e-4,
        )

    def test_driver_spec_mode_requires_target(self, small_target):
        from mcmc_spec_tpu.pipeline import _EnsembleDriver, resolve_mesh

        with pytest.raises(ValueError, match="packed target"):
            _EnsembleDriver(lambda q: q, resolve_mesh("2x4", 64))


class TestSpecCollectiveStructure:
    """Structural receipt for the sp memory claim: the compiled spec-sharded
    programs reduce with all-reduces (psums of counts, Gram products, chi^2
    partials) and NEVER all-gather wavelength-sized data — the full model
    row must not materialize on any chip (that is the point of the axis).
    Same virtual-mesh methodology as TestShardedCollectiveStructure in
    test_fleet_pipeline.py."""

    def test_logpost_program_has_no_gather(self, small_target):
        tgt, _, coords = small_target
        mesh = spec_mesh()
        tgt_sh = shard_target_over_spec(tgt, mesh)
        fn = make_spec_logpost(tgt_sh, mesh)
        hlo = fn.lower(coords, tgt_sh).compile().as_text()
        assert "all-reduce" in hlo
        assert "all-gather" not in hlo
        assert "all-to-all" not in hlo and "collective-permute" not in hlo

    def test_chain_gathers_only_walker_coords(self, small_target):
        # the 2-D chain's only all-gather is the stretch move's complement
        # coordinates ([nh, ndim] over the walker axis) — nothing
        # wavelength-sized crosses the mesh
        import re

        tgt, _, coords = small_target
        mesh = mesh_2d(4, 2)
        tgt_sh = shard_target_over_spec(tgt, mesh)
        state = shard_spec_ensemble_state(coords, tgt_sh, jax.random.PRNGKey(0), mesh)
        lowered = jax.jit(
            lambda s, t: run_ensemble_spec_sharded(s, t, mesh, n_steps=2, thin=2)
        ).lower(state, tgt_sh)
        hlo = lowered.compile().as_text()
        assert "all-reduce" in hlo and "all-gather" in hlo
        nd = tgt.n_data
        for line in hlo.splitlines():
            if "all-gather" in line:
                dims = [int(d) for d in re.findall(r"\d+", line.split("=")[0])]
                assert not any(d >= nd for d in dims), line


class TestSpecAnnealer:
    def test_anneal_spec_sharded(self, small_target):
        # stage 1 on the (walkers, spec) mesh: the psum'd median-only chi^2
        # must equal the single-device optimizer convention, and the
        # schedule must improve every walker from its seed
        from mcmc_spec_tpu.inference.batched import optimizer_chi2_batch
        from mcmc_spec_tpu.parallel.spec_shard import (
            _local_optimizer_chi2,
            run_anneal_spec_sharded,
        )

        tgt, _, coords = small_target
        mesh = mesh_2d(2, 4)
        tgt_sh = shard_target_over_spec(tgt, mesh)

        # chi^2 parity for the annealer convention (renorm=False + exact median)
        f = shard_map(
            lambda p, t: _local_optimizer_chi2(p, None, t, "spec"),
            mesh=mesh,
            in_specs=(P(), target_spec_tree(tgt_sh, "spec")),
            out_specs=P(),
            check_vma=False,
        )
        got = np.asarray(jax.jit(f)(coords, tgt_sh))
        ref = np.asarray(optimizer_chi2_batch(coords, tgt))
        np.testing.assert_allclose(got, ref, rtol=3e-5, atol=1e-3)

        # a short schedule runs and improves
        from mcmc_spec_tpu.inference.anneal import init_walkers

        p0 = init_walkers(tgt, 16, 2.0e-3, 1e-4, jax.random.PRNGKey(3))
        chi0 = np.asarray(optimizer_chi2_batch(p0, tgt))
        params, chi, trace = run_anneal_spec_sharded(
            tgt_sh, p0, jax.random.PRNGKey(4), mesh, steps=10, record_thin=50
        )
        params, chi = np.asarray(params), np.asarray(chi)
        assert params.shape == (16, tgt.ndim) and np.all(np.isfinite(chi))
        # <= up to psum-vs-local rounding (chi magnitudes are large at random seeds)
        assert np.all(chi <= chi0 * (1 + 1e-4) + 1e-6)
        assert trace[0].shape[1] == 16  # [n_chunks, nw, ndim] walker axis intact


class TestSpecEnsembleChain:
    def test_chain_consistency_and_walker_parity(self, small_target):
        tgt, _, coords = small_target
        mesh2 = mesh_2d(4, 2)
        tgt_sh = shard_target_over_spec(tgt, mesh2)
        key = jax.random.PRNGKey(0)
        state = shard_spec_ensemble_state(coords, tgt_sh, key, mesh2)
        state, chain, logps = run_ensemble_spec_sharded(
            state, tgt_sh, mesh2, n_steps=3, thin=1
        )
        chain = np.asarray(jax.device_get(chain))   # [3, 2, nh, ndim]
        logps = np.asarray(jax.device_get(logps))   # [3, 2, nh]
        assert np.all(np.isfinite(logps))
        # stored logps equal an independent recomputation on the stored coords
        last = jnp.asarray(chain[-1].reshape(-1, chain.shape[-1]))
        recomputed = np.asarray(log_posterior_batch(last, tgt))
        np.testing.assert_allclose(logps[-1].reshape(-1), recomputed,
                                   rtol=3e-5, atol=1e-4)

        # identical RNG trajectory to the walkers-only sampler on a 4-device
        # mesh (the spec psums round differently but the seeded run does not
        # flip any accept decision at these scales)
        from mcmc_spec_tpu.parallel.mesh import make_mesh
        from mcmc_spec_tpu.parallel.sharding import (
            run_ensemble_sharded,
            shard_ensemble_state,
        )

        mesh1 = make_mesh(4, ("walkers",))
        logp = lambda q: log_posterior_batch(q, tgt)
        st1 = shard_ensemble_state(coords, logp, key, mesh1)
        st1, chain1, logps1 = run_ensemble_sharded(st1, logp, mesh1,
                                                   n_steps=3, thin=1)
        np.testing.assert_allclose(
            chain, np.asarray(jax.device_get(chain1)), rtol=1e-5, atol=1e-5
        )


class TestHostStagedPacking:
    """ADVICE r4 (medium): the WxS pipeline must never commit the full
    [nT, nG, nd] grid projection to one device — pack_target's
    stage_on_device=False keeps every field as host numpy so
    shard_target_over_spec performs the ONLY device placement."""

    def test_pack_host_staged_fields_are_numpy(self):
        import dataclasses

        tgt, _ = build_bench_target(jnp.float32, nd=256, grid_step=8.0,
                                    stage_on_device=False)
        for f in dataclasses.fields(tgt):
            val = getattr(tgt, f.name)
            if isinstance(val, (int, float, bool, str)):
                continue
            assert isinstance(val, np.ndarray), (
                f"{f.name} staged on device ({type(val)})")

    def test_host_staged_shards_without_full_device_buffer(self):
        tgt, truth = build_bench_target(jnp.float32, nd=256, grid_step=8.0,
                                        stage_on_device=False)
        mesh = spec_mesh()
        tgt_sh = shard_target_over_spec(tgt, mesh)
        # per-device D buffer is exactly 1/8 of the wavelength axis
        for sh in tgt_sh.D.addressable_shards:
            assert sh.data.shape[2] == tgt.n_data // 8
        # and the sharded posterior matches a device-staged pack bit-for-bit
        # at the XLA-backend tolerance
        tgt_dev, _ = build_bench_target(jnp.float32, nd=256, grid_step=8.0)
        coords = init_walker_batch(tgt_dev, truth, 16, jnp.float32)
        ref = np.asarray(log_posterior_batch(coords, tgt_dev))
        got = np.asarray(make_spec_logpost(tgt_sh, mesh)(coords, tgt_sh))
        np.testing.assert_allclose(got, ref, rtol=3e-5, atol=1e-4)

    def test_driver_spec_mode_on_host_staged_target(self):
        # the production MCMC driver path the WxS CLI takes: a host-staged
        # target (indivisible nd, so the padding lane runs too) goes through
        # pad_packed_target_nd -> shard_target_over_spec without any
        # full-size device buffer, and the chain runs
        from mcmc_spec_tpu.pipeline import _EnsembleDriver, resolve_mesh

        tgt, truth = build_bench_target(jnp.float32, nd=250, grid_step=8.0,
                                        stage_on_device=False)
        coords = init_walker_batch(tgt, truth, 16, jnp.float32)
        mesh = resolve_mesh("2x4", 16)
        driver = _EnsembleDriver(None, mesh, target=tgt)
        assert driver.tgt_sp.n_data == 252  # padded to a multiple of 4
        for sh in driver.tgt_sp.D.addressable_shards:
            assert sh.data.shape[2] == 252 // 4
        state = driver.init(np.asarray(coords), jax.random.PRNGKey(0))
        state, chain = driver.run(state, n_steps=2, thin=1)
        assert np.all(np.isfinite(driver.log_prob(state)))
