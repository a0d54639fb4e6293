"""Large-nd spectrum lane (ops/spec_segmented.py).

Pins: the k-ary count median is BIT-exact against sorted-rank semantics
(single-device and distributed), the lane matches the XLA backend at
exact-dial tolerance (renorm and median-only conventions), and on a GPU
the composition dispatches it beyond ``flags.LARGE_ND``.
"""
import dataclasses

import numpy as np
import jax
import jax.numpy as jnp
import pytest
from jax import shard_map
from jax.sharding import Mesh, PartitionSpec as P

from mcmc_spec_tpu.bench_target import build_bench_target, init_walker_batch
from mcmc_spec_tpu.inference.batched import (
    _forward_small,
    _spec_chi2_xla,
    _spec_chi2_xla_median_only,
    log_posterior_batch,
)
from mcmc_spec_tpu.ops.spec_segmented import (
    median_nonneg_xla,
    spectrum_chi2_segmented,
)


def _rank_median(model, n_true):
    srt = np.sort(model, axis=1)
    i0, i1 = (n_true - 1) // 2, n_true // 2
    half = model.dtype.type(0.5)
    return (half * (srt[:, i0] + srt[:, i1])).astype(model.dtype)


class TestKaryMedian:
    @pytest.mark.parametrize("n_true,nd", [(240, 240), (239, 240), (200, 240),
                                           (201, 240), (2, 240), (1, 240)])
    def test_bit_exact_vs_sorted_ranks(self, n_true, nd):
        rng = np.random.RandomState(7)
        model = rng.uniform(0.05, 8.0, (16, nd)).astype(np.float32)
        model[:, n_true:] = 1e30
        med = np.asarray(jax.jit(median_nonneg_xla)(
            jnp.asarray(model), jnp.asarray(n_true, jnp.int32)))
        assert np.array_equal(med, _rank_median(model, n_true))

    def test_duplicates_zeros_and_f64(self):
        rng = np.random.RandomState(3)
        model = rng.choice([0.0, 0.25, 1.0, 1.0, 3.5], (8, 64)).astype(np.float32)
        med = np.asarray(jax.jit(median_nonneg_xla)(
            jnp.asarray(model), jnp.asarray(64, jnp.int32)))
        assert np.array_equal(med, _rank_median(model, 64))
        m64 = rng.uniform(0.0, 5.0, (8, 63))
        med64 = np.asarray(jax.jit(median_nonneg_xla)(
            jnp.asarray(m64, jnp.float64), jnp.asarray(63, jnp.int32)))
        assert np.array_equal(med64, np.median(m64, axis=1))

    def test_distributed_bit_exact(self):
        # psum_axis form: counts psum'd over a spec mesh reproduce the
        # single-chip result bit for bit (the _dist_median_nonneg contract)
        rng = np.random.RandomState(11)
        model = rng.uniform(0.01, 20.0, (16, 240)).astype(np.float32)
        model[:, 201:] = 1e30
        mesh = Mesh(np.array(jax.devices("cpu")[:8]), ("spec",))
        f = shard_map(
            lambda m, n: median_nonneg_xla(m, n, psum_axis="spec"),
            mesh=mesh, in_specs=(P(None, "spec"), P()), out_specs=P(),
            check_vma=False,
        )
        got = np.asarray(jax.jit(f)(jnp.asarray(model),
                                    jnp.asarray(201, jnp.int32)))
        assert np.array_equal(got, _rank_median(model, 201))


class TestFastMedianSegmented:
    """iters<31: ceil(iters/2) 2-bit rounds + bracket midpoint.

    The fast-median contract: the result lies within a 2^(31-iters)-wide
    bit interval of the exact order statistic, sharded == single-device bit
    for bit, and the renorm=False (annealer) path never sees it.
    """

    def test_bit_interval_bound(self):
        rng = np.random.RandomState(5)
        n_true, nd = 239, 240  # odd: exact median is a data element
        model = rng.uniform(0.05, 8.0, (32, nd)).astype(np.float32)
        model[:, n_true:] = 1e30
        exact = np.asarray(jax.jit(median_nonneg_xla)(
            jnp.asarray(model), jnp.asarray(n_true, jnp.int32)))
        fast = np.asarray(jax.jit(
            lambda m, n: median_nonneg_xla(m, n, iters=14))(
            jnp.asarray(model), jnp.asarray(n_true, jnp.int32)))
        db = np.abs(exact.view(np.int32).astype(np.int64)
                    - fast.view(np.int32).astype(np.int64))
        assert db.max() <= 2 ** 17  # iters=14 leaves a 2^17-wide bracket
        rel = np.abs(fast - exact) / exact
        assert rel.max() < 2e-2

    def test_fast_distributed_bit_identical(self):
        # counts are psum-additive, so the fast midpoint is bit-identical
        # sharded vs single-chip — the production WxS invariant
        rng = np.random.RandomState(13)
        model = rng.uniform(0.01, 20.0, (16, 240)).astype(np.float32)
        model[:, 201:] = 1e30
        single = np.asarray(jax.jit(
            lambda m, n: median_nonneg_xla(m, n, iters=14))(
            jnp.asarray(model), jnp.asarray(201, jnp.int32)))
        mesh = Mesh(np.array(jax.devices("cpu")[:8]), ("spec",))
        f = shard_map(
            lambda m, n: median_nonneg_xla(m, n, psum_axis="spec", iters=14),
            mesh=mesh, in_specs=(P(None, "spec"), P()), out_specs=P(),
            check_vma=False,
        )
        got = np.asarray(jax.jit(f)(jnp.asarray(model),
                                    jnp.asarray(201, jnp.int32)))
        assert np.array_equal(got, single)

    def test_f64_lane_dial_convention(self):
        # the dial is the pack-time f32 convention for EVERY dtype: on the
        # x64 test lane iters=31 still means EXACT (not "31 of 63 bits"
        # fast), and a fast setting resolves iters+3 bit-positions so the
        # RELATIVE bracket width — the eps the alpha^2 bound tempers —
        # matches the f32 contract (11-bit exponent vs f32's 8)
        rng = np.random.RandomState(17)
        m64 = rng.uniform(0.05, 8.0, (16, 239))
        exact31 = np.asarray(jax.jit(
            lambda m, n: median_nonneg_xla(m, n, iters=31))(
            jnp.asarray(m64, jnp.float64), jnp.asarray(239, jnp.int32)))
        assert np.array_equal(exact31, np.median(m64, axis=1))
        fast = np.asarray(jax.jit(
            lambda m, n: median_nonneg_xla(m, n, iters=14))(
            jnp.asarray(m64, jnp.float64), jnp.asarray(239, jnp.int32)))
        rel = np.abs(fast - exact31) / exact31
        assert 0 < rel.max() < 2e-2  # same relative pin as the f32 test

    @pytest.mark.parametrize("iters,psums,pmins", [(14, 7, 0), (31, 17, 1)])
    def test_distributed_median_psum_budget(self, iters, psums, pmins):
        # the per-eval collective latency-round budget: fast
        # median = ceil(14/2) = 7 count psums, no even-rank refinement;
        # exact = 15 two-bit rounds + final single-bit count + even-rank
        # count (17 psums) + its pmin.  The full renorm eval adds exactly
        # 2 more psums (renorm coeffs + residual) on top — pinned here so
        # a regression in the round structure is visible off-device.
        mesh = Mesh(np.array(jax.devices("cpu")[:8]), ("spec",))
        f = shard_map(
            lambda m, n: median_nonneg_xla(m, n, psum_axis="spec",
                                           iters=iters),
            mesh=mesh, in_specs=(P(None, "spec"), P()), out_specs=P(),
            check_vma=False,
        )
        jaxpr = str(jax.make_jaxpr(f)(
            jnp.ones((4, 240), jnp.float32), jnp.asarray(201, jnp.int32)))
        assert jaxpr.count("psum[") == psums
        assert jaxpr.count("pmin[") == pmins

    @pytest.mark.parametrize("renorm,should_match", [(False, True),
                                                     (True, False)])
    def test_dial_policy(self, renorm, should_match):
        # renorm=False (annealer convention): iters is IGNORED, exact
        # median always (optimizer_chi2_batch policy).  renorm=True: the
        # fast dial engages and stays within the alpha^2-bounded tolerance.
        tgt, truth = build_bench_target(jnp.float32, nd=1024, grid_step=8.0)
        coords = init_walker_batch(tgt, truth, 16, jnp.float32)
        p = jnp.asarray(coords, jnp.float32)
        *_, Wcomb = _forward_small(p, tgt)
        Wcomb, av = Wcomb.astype(jnp.float32), p[:, tgt.nspec]
        nT, nG, nd = tgt.D.shape
        args = (Wcomb, av, tgt.D.reshape(nT * nG, nd).astype(jnp.float32),
                tgt.ext_k_data, tgt.data_flux, tgt.data_err, tgt.V,
                tgt.Vpinv, tgt.med_data, tgt.n_data_true)
        fast = np.asarray(spectrum_chi2_segmented(*args, iters=14, renorm=renorm))
        ex = np.asarray(spectrum_chi2_segmented(*args, iters=31, renorm=renorm))
        if should_match:
            assert np.array_equal(fast, ex)
        else:
            np.testing.assert_allclose(fast, ex, rtol=2e-2)
            assert not np.array_equal(fast, ex)


@pytest.fixture(scope="module")
def seg_target():
    tgt, truth = build_bench_target(jnp.float32, nd=1024, grid_step=8.0)
    coords = init_walker_batch(tgt, truth, 24, jnp.float32)
    return tgt, truth, coords


class TestSegmentedComposition:
    def _wcomb_av(self, tgt, coords):
        p = jnp.asarray(coords, jnp.float32)
        *_, Wcomb = _forward_small(p, tgt)
        return Wcomb.astype(jnp.float32), p[:, tgt.nspec]

    @pytest.mark.parametrize("renorm", [True, False])
    def test_matches_xla_backend(self, seg_target, renorm):
        tgt, _, coords = seg_target
        Wcomb, av = self._wcomb_av(tgt, coords)
        nT, nG, nd = tgt.D.shape
        got = np.asarray(spectrum_chi2_segmented(
            Wcomb, av, tgt.D.reshape(nT * nG, nd).astype(jnp.float32),
            tgt.ext_k_data, tgt.data_flux, tgt.data_err, tgt.V, tgt.Vpinv,
            tgt.med_data, tgt.n_data_true, iters=31, renorm=renorm,
        ))
        f32 = lambda x: jnp.asarray(x, jnp.float32)
        tgt32 = dataclasses.replace(
            tgt, D=f32(tgt.D), data_flux=f32(tgt.data_flux),
            data_err=f32(tgt.data_err), ext_k_data=f32(tgt.ext_k_data),
            V=f32(tgt.V), Vpinv=f32(tgt.Vpinv), med_data=f32(tgt.med_data))
        ref_fn = _spec_chi2_xla if renorm else _spec_chi2_xla_median_only
        ref = np.asarray(ref_fn(Wcomb, av, tgt32))
        np.testing.assert_allclose(got, ref, rtol=2e-5, atol=1e-6)

    def test_non_power_of_two_nd(self, seg_target):
        # any nd: the lane has no tiles, so nd=1000 matches like nd=1024
        tgt, truth = build_bench_target(jnp.float32, nd=1000, grid_step=8.0)
        coords = init_walker_batch(tgt, truth, 8, jnp.float32)
        Wcomb, av = self._wcomb_av(tgt, coords)
        nT, nG, nd = tgt.D.shape
        got = np.asarray(spectrum_chi2_segmented(
            Wcomb, av, tgt.D.reshape(nT * nG, nd).astype(jnp.float32),
            tgt.ext_k_data, tgt.data_flux, tgt.data_err, tgt.V, tgt.Vpinv,
            tgt.med_data, tgt.n_data_true, iters=31,
        ))
        f32 = lambda x: jnp.asarray(x, jnp.float32)
        tgt32 = dataclasses.replace(
            tgt, D=f32(tgt.D), data_flux=f32(tgt.data_flux),
            data_err=f32(tgt.data_err), ext_k_data=f32(tgt.ext_k_data),
            V=f32(tgt.V), Vpinv=f32(tgt.Vpinv), med_data=f32(tgt.med_data))
        ref = np.asarray(_spec_chi2_xla(Wcomb, av, tgt32))
        np.testing.assert_allclose(got, ref, rtol=2e-5, atol=1e-6)


class TestLargeNdDispatch:
    def test_log_posterior_routes_segmented(self, monkeypatch):
        # nd > LARGE_ND on a GPU: the composition dispatches the large-nd
        # lane (the lane choice is made to see a GPU; the lane itself is
        # plain XLA and runs here); result matches the sort lane
        from mcmc_spec_tpu.utils.flags import LARGE_ND, spectrum_lane

        monkeypatch.setattr(jax, "default_backend", lambda: "gpu")
        tgt, truth = build_bench_target(jnp.float32, nd=8192, grid_step=8.0)
        assert tgt.n_data > LARGE_ND
        assert spectrum_lane(tgt.n_data) == "segmented"
        coords = init_walker_batch(tgt, truth, 8, jnp.float32)
        got = np.asarray(jax.jit(log_posterior_batch)(coords, tgt))
        monkeypatch.setattr(jax, "default_backend", lambda: "cpu")
        assert spectrum_lane(tgt.n_data) == "xla"
        ref = np.asarray(log_posterior_batch(coords, tgt))  # eager: a fresh trace
        assert np.all(np.isfinite(ref))
        np.testing.assert_allclose(got, ref, rtol=2e-4, atol=2e-3)
