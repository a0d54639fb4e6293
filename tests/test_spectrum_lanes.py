"""Spectrum-chi2 lanes: the sort-based XLA composition and the count-median
lane (ops/spec_segmented.py) the GPU runs beyond ``flags.LARGE_ND`` — their
agreement across target variants and conventions, the fast-median dial,
the routing through the production composition, and lowering for CUDA."""
import dataclasses

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from tests.helpers import make_setup
from mcmc_spec_tpu.inference import batched
from mcmc_spec_tpu.ops.spec_segmented import median_nonneg_xla, spectrum_chi2_segmented


def _median(m, iters=None):
    """The count median over every column of ``m``."""
    return np.asarray(median_nonneg_xla(jnp.asarray(m, jnp.float32), m.shape[1],
                                        iters=iters))


def _lane_args(P, tgt):
    """(Wcomb, av, ...) spectrum-lane operands for walker batch ``P``."""
    *_, Wcomb = batched._forward_small(P, tgt)
    nT, nG, nd = tgt.D.shape
    return (Wcomb, P[:, tgt.nspec], tgt.D.reshape(nT * nG, nd), tgt.ext_k_data,
            tgt.data_flux, tgt.data_err, tgt.V, tgt.Vpinv, tgt.med_data,
            tgt.n_data_true)


def _walkers(p_truth, n, seed, scale=0.02):
    rng = np.random.RandomState(seed)
    return jnp.asarray(
        np.stack([p_truth * (1 + scale * rng.randn(len(p_truth))) for _ in range(n)]),
        jnp.float32)


@pytest.fixture
def count_lane(monkeypatch):
    """Route the production composition through the count-median lane (the
    lane choice picks it only on a GPU beyond LARGE_ND; the lane itself is
    plain XLA and runs here).  Returns ``sort_lane(fn, *args)``, which
    evaluates ``fn`` eagerly through the sort lane: the reference."""
    from mcmc_spec_tpu.utils import flags

    monkeypatch.setattr(flags, "spectrum_lane", lambda nd, backend=None: "segmented")

    def sort_lane(fn, *args):
        with monkeypatch.context() as m:
            m.setattr(flags, "spectrum_lane", lambda nd, backend=None: "xla")
            return np.asarray(fn(*args))

    return sort_lane


class TestCountMedian:
    """The sort-free count median must equal np.median bit-for-bit."""

    def test_matches_np_median_even(self):
        rng = np.random.RandomState(0)
        for scale in [1.0, 1e-15, 1e6]:
            m = np.asarray(np.abs(rng.randn(16, 64)) * scale, np.float32)
            np.testing.assert_array_equal(_median(m), np.median(m, axis=1))

    def test_matches_np_median_odd(self):
        rng = np.random.RandomState(1)
        m = np.asarray(np.abs(rng.randn(8, 63)), np.float32)
        np.testing.assert_array_equal(_median(m), np.median(m, axis=1))

    def test_duplicates(self):
        m = np.array([[1.0, 2.0, 2.0, 3.0], [5.0, 5.0, 5.0, 5.0]], np.float32)
        np.testing.assert_array_equal(_median(m), np.median(m, axis=1))

    def test_with_zeros(self):
        m = np.array([[0.0, 0.0, 1.0, 2.0]], np.float32)
        assert float(_median(m)[0]) == 0.5

    @pytest.mark.parametrize("n_true", [40, 41, 1, 2])
    def test_sentinel_padding_ignored(self, n_true):
        """Only the first n_true columns count when the rest hold the fleet
        padding sentinel (1e30, above every real flux)."""
        rng = np.random.RandomState(2)
        m = np.abs(rng.randn(8, 64)).astype(np.float32)
        m[:, n_true:] = 1e30
        got = np.asarray(median_nonneg_xla(jnp.asarray(m), n_true))
        np.testing.assert_array_equal(got, np.median(m[:, :n_true], axis=1))


class TestCountLane:
    @pytest.mark.parametrize("variant", ["binary_dist", "rad_prior", "no_dist_fit",
                                         "triple", "fit_plx_false"])
    def test_matches_xla_fallback(self, variant):
        if variant == "triple":
            from mcmc_spec_tpu.bench_target import build_bench_target

            tgt, truth = build_bench_target(jnp.float32, nd=400, grid_step=8.0, nspec=3)
            p = np.asarray(truth)
        elif variant == "fit_plx_false":
            from mcmc_spec_tpu.inference.target import pack_target

            st, _ = make_setup(dtype=jnp.float32)
            tgt = pack_target(
                st["grid"], st["data_wl_um"], st["data_flux"], st["data_err"],
                st["cfilts"], st["cmag"], st["cerr"], st["pfilts"], st["zps"],
                st["pmag"], st["perr"], st["mist"], st["av_profile"],
                nspec=2, dist_fit=False, fit_plx=False, dtype=jnp.float32,
            )
            t = st["truth"]
            p = np.array([t["t1"], t["t2"], t["av"], t["rr2"]])
        else:
            st, tgt = make_setup(dtype=jnp.float32, rad_prior=variant == "rad_prior",
                                 dist_fit=variant != "no_dist_fit")
            p = st["p_truth"]
        args = _lane_args(_walkers(p, 16, seed=3), tgt)
        got = np.asarray(spectrum_chi2_segmented(*args, iters=31))
        ref = np.asarray(batched._spec_chi2_xla(args[0], args[1], tgt))
        np.testing.assert_allclose(got, ref, rtol=5e-5)

    def test_av_zero_branch(self):
        st, tgt = make_setup(dtype=jnp.float32)
        p = st["p_truth"].copy()
        p[2] = 0.0  # no extinction applied when Av <= 0 (mft6.py:1161-1166)
        args = _lane_args(jnp.asarray(np.stack([p, p]), jnp.float32), tgt)
        got = np.asarray(spectrum_chi2_segmented(*args, iters=31))
        ref = np.asarray(batched._spec_chi2_xla(args[0], args[1], tgt))
        np.testing.assert_allclose(got, ref, rtol=5e-5)

    @pytest.mark.parametrize("nd", [1000, 1792])
    def test_real_widths(self, nd):
        """Both conventions at nd 1,000 and the koi2298 width 1,792."""
        from mcmc_spec_tpu.bench_target import build_bench_target, init_walker_batch

        tgt, truth = build_bench_target(jnp.float32, nd=nd, grid_step=8.0)
        args = _lane_args(init_walker_batch(tgt, truth, 20, jnp.float32), tgt)
        for renorm, ref_fn in ((True, batched._spec_chi2_xla),
                               (False, batched._spec_chi2_xla_median_only)):
            got = np.asarray(spectrum_chi2_segmented(*args, iters=31, renorm=renorm))
            ref = np.asarray(ref_fn(args[0], args[1], tgt))
            np.testing.assert_allclose(got, ref, rtol=5e-5, err_msg=f"renorm={renorm}")

    def test_matches_vmapped_fleet(self):
        """Per-target ranks from each padded member's n_data_true."""
        from tests.test_fleet import _make_target, _walkers as fleet_walkers
        from mcmc_spec_tpu.inference.fleet import stack_targets

        fleet = stack_targets([_make_target(nd, nc, s, pad_nd=320, pad_nc=2,
                                            dtype=jnp.float32)
                               for nd, nc, s in ((300, 2, 21), (260, 1, 22))])
        P = jnp.stack([fleet_walkers(8, seed=i) for i in range(2)]).astype(jnp.float32)
        *_, Wcomb = jax.vmap(batched._forward_small)(P, fleet)
        av = P[..., fleet.nspec]
        ntgt, nT, nG, nd = fleet.D.shape
        got = np.asarray(jax.vmap(
            lambda w, a, D, k, d, e, V, Vp, md, n: spectrum_chi2_segmented(
                w, a, D, k, d, e, V, Vp, md, n, iters=31))(
            Wcomb, av, fleet.D.reshape(ntgt, nT * nG, nd), fleet.ext_k_data,
            fleet.data_flux, fleet.data_err, fleet.V, fleet.Vpinv, fleet.med_data,
            fleet.n_data_true))
        ref = np.asarray(jax.vmap(batched._spec_chi2_xla)(Wcomb, av, fleet))
        np.testing.assert_allclose(got, ref, rtol=5e-5)

    def test_padding_inert(self):
        """A padded and an unpadded copy of the same target agree."""
        from tests.test_fleet import _make_target, _walkers as fleet_walkers

        base = _make_target(300, 2, 7, dtype=jnp.float32)
        padded = _make_target(300, 2, 7, pad_nd=352, pad_nc=3, dtype=jnp.float32)
        P = fleet_walkers(16, seed=3).astype(jnp.float32)
        outs = [np.asarray(spectrum_chi2_segmented(*_lane_args(P, t), iters=31))
                for t in (base, padded)]
        np.testing.assert_allclose(outs[1], outs[0], rtol=5e-6)


class TestFastMedian:
    def test_reduced_iters_close(self):
        rng = np.random.RandomState(0)
        m = np.asarray(np.abs(rng.randn(32, 256)) * 1e-15, np.float32)
        # end-to-end fast vs exact differs by at most the order-statistic gap
        exact, fast = _median(m), _median(m, 20)
        srt = np.sort(m, axis=1)
        gap = np.abs(srt[:, 128] - srt[:, 127]) + 2.5e-4 * exact
        assert np.all(np.abs(fast - exact) <= gap + 1e-20)

    def test_env_flag(self, monkeypatch):
        # the env dial is resolved ONLY at pack time (utils.flags); the
        # lanes never read it
        from mcmc_spec_tpu.utils.flags import median_iters

        monkeypatch.delenv("MCMC_SPEC_FAST_MEDIAN", raising=False)
        # production default: 14-pass fast median with the interval-midpoint
        # refinement (structural tempering bound 0.027 sigma,
        # scripts/median_tempering_bound_cpu.py)
        assert median_iters() == 14
        monkeypatch.setenv("MCMC_SPEC_FAST_MEDIAN", "exact")
        assert median_iters() == 31
        monkeypatch.setenv("MCMC_SPEC_FAST_MEDIAN", "1")
        assert median_iters() == 20
        monkeypatch.setenv("MCMC_SPEC_FAST_MEDIAN", "25")
        assert median_iters() == 25
        monkeypatch.setenv("MCMC_SPEC_FAST_MEDIAN", "5")
        with pytest.raises(ValueError):
            median_iters()

    @pytest.mark.parametrize("bad", [-3, 32])
    def test_lane_rejects_out_of_range_dials(self, bad):
        st, tgt = make_setup(dtype=jnp.float32)
        args = _lane_args(jnp.asarray(st["p_truth"][None, :], jnp.float32), tgt)
        with pytest.raises(ValueError, match="0..31"):
            spectrum_chi2_segmented(*args, iters=bad)

    def test_production_path_reads_no_env_at_trace_time(self, monkeypatch,
                                                        count_lane):
        """log_posterior_batch on a packed target must never consult the
        accuracy-dial env var at trace time: a poisoned value (which RAISES
        if parsed) must not affect a FRESH trace — a new walker-count shape
        forces retracing, so a surviving env read would blow up here."""
        st, tgt = make_setup(dtype=jnp.float32)
        batched.log_posterior_batch(_walkers(st["p_truth"], 4, seed=5, scale=0.01), tgt)
        monkeypatch.setenv("MCMC_SPEC_FAST_MEDIAN", "poisoned")
        out = np.asarray(batched.log_posterior_batch(
            _walkers(st["p_truth"], 5, seed=6, scale=0.01), tgt))  # retrace
        assert out.shape == (5,)

    def test_intermediate_iters_error_bound(self):
        """iters=k error <= rank-search width 2^(8-k) + the middle gap the
        skipped even-n averaging would have halved."""
        rng = np.random.RandomState(3)
        m = np.asarray(np.abs(rng.lognormal(0, 2, (64, 512))), np.float32)
        exact, m25 = _median(m), _median(m, 25)
        srt = np.sort(m, axis=1)
        gap = np.abs(srt[:, 256] - srt[:, 255])
        bound = gap + 2.0 ** (8 - 25) * exact + 1e-20
        assert np.all(np.abs(m25 - exact) <= bound)


class TestCountLaneRouting:
    """The production composition routed through the count-median lane
    against the sort-based composition."""

    def _compare(self, sort_lane, tgt, p_truth, seed=0, rtol=5e-5):
        P = jnp.concatenate([_walkers(p_truth, 24, seed, scale=0.03),
                             jnp.ones((1, len(p_truth)), jnp.float32)])  # out of bounds
        ref = sort_lane(batched.log_posterior_batch, P, tgt)
        got = np.asarray(batched.log_posterior_batch(P, tgt))
        np.testing.assert_array_equal(np.isfinite(got), np.isfinite(ref))
        fin = np.isfinite(ref)
        assert fin.any() and not fin.all()
        np.testing.assert_allclose(got[fin], ref[fin], rtol=rtol,
                                   atol=1e-4 * np.abs(ref[fin]).max())

    def test_binary_dist(self, count_lane):
        st, tgt = make_setup(dtype=jnp.float32)
        self._compare(count_lane, tgt, st["p_truth"])

    def test_nospec(self, count_lane):
        st, tgt = make_setup(spectrum_weight=0.0, dtype=jnp.float32)
        self._compare(count_lane, tgt, st["p_truth"], seed=4)

    def test_annealer_convention(self, count_lane):
        st, tgt = make_setup(dtype=jnp.float32)
        P = _walkers(st["p_truth"], 16, seed=8)
        got = np.asarray(batched.optimizer_chi2_batch(P, tgt))
        ref = count_lane(batched.optimizer_chi2_batch, P, tgt)
        np.testing.assert_allclose(got, ref, rtol=5e-5)

    def test_fleet(self, count_lane):
        """A padded fleet takes the count lane too: each member's median
        ranks come from its own n_data_true."""
        from tests.test_fleet import _make_target, _walkers as fleet_walkers
        from mcmc_spec_tpu.inference.fleet import log_posterior_fleet, stack_targets

        fleet = stack_targets([_make_target(nd, nc, s, pad_nd=320, pad_nc=2,
                                            dtype=jnp.float32)
                               for nd, nc, s in ((300, 2, 31), (260, 1, 32))])
        P = jnp.stack([fleet_walkers(8, seed=i) for i in range(2)]).astype(jnp.float32)
        got = np.asarray(log_posterior_fleet(P, fleet))
        ref = count_lane(log_posterior_fleet, P, fleet)
        assert np.all(np.isfinite(ref))
        np.testing.assert_allclose(got, ref, rtol=5e-5)

    def test_sampler_through_count_lane(self, count_lane):
        from mcmc_spec_tpu.inference.stretch import init_ensemble, run_ensemble

        st, tgt = make_setup(dtype=jnp.float32)
        P = _walkers(st["p_truth"], 8, seed=0, scale=0.01)
        logp = lambda b: batched.log_posterior_batch(b, tgt)
        state = init_ensemble(P, logp, jax.random.PRNGKey(0))
        assert np.all(np.isfinite(np.asarray(state.log_prob)))
        state, chain, _ = run_ensemble(state, logp, n_steps=4, thin=4)
        assert np.all(np.isfinite(np.asarray(chain)))


class TestPackTimeDials:
    """MCMC_SPEC_FAST_MEDIAN is resolved once at pack time
    (PackedTarget.median_iters) and threaded into the lane as a static
    argument — flipping the env after a compilation must not be silently
    ignored (the jit cache is keyed only on shapes and statics)."""

    def test_pack_stamps_env_dials(self, monkeypatch):
        from mcmc_spec_tpu.inference.target import pack_target

        st, _ = make_setup(dtype=jnp.float32)

        def pack():
            return pack_target(
                st["grid"], st["data_wl_um"], st["data_flux"], st["data_err"],
                st["cfilts"], st["cmag"], st["cerr"], st["pfilts"], st["zps"],
                st["pmag"], st["perr"], st["mist"], st["av_profile"],
                nspec=2, dtype=jnp.float32,
            )

        monkeypatch.delenv("MCMC_SPEC_FAST_MEDIAN", raising=False)
        assert pack().median_iters == 14  # fast default
        monkeypatch.setenv("MCMC_SPEC_FAST_MEDIAN", "exact")
        assert pack().median_iters == 31
        monkeypatch.setenv("MCMC_SPEC_FAST_MEDIAN", "25")
        assert pack().median_iters == 25

    def test_lane_uses_pack_time_iters(self, monkeypatch, count_lane):
        monkeypatch.delenv("MCMC_SPEC_FAST_MEDIAN", raising=False)
        st, tgt = make_setup(dtype=jnp.float32)
        P = _walkers(st["p_truth"], 16, seed=7)
        exact = np.asarray(batched.log_posterior_batch(
            P, dataclasses.replace(tgt, median_iters=31)))
        crude = np.asarray(batched.log_posterior_batch(
            P, dataclasses.replace(tgt, median_iters=8)))
        # 8 passes only resolve sign+exponent bits: visibly approximate, so
        # the pack-time field demonstrably reaches the lane
        assert not np.allclose(exact, crude)
        # ...and the env var alone (flipped post-pack) changes nothing
        monkeypatch.setenv("MCMC_SPEC_FAST_MEDIAN", "8")
        exact2 = np.asarray(batched.log_posterior_batch(
            P, dataclasses.replace(tgt, median_iters=31)))
        np.testing.assert_array_equal(exact, exact2)


class TestAnnealerMode:
    """renorm=False — the annealer's median-only scoring through the count
    lane, pinned against the XLA transcription."""

    def test_matches_xla_median_only(self):
        st, tgt = make_setup(dtype=jnp.float32)
        args = _lane_args(_walkers(st["p_truth"], 16, seed=13), tgt)
        got = np.asarray(spectrum_chi2_segmented(*args, iters=31, renorm=False))
        ref = np.asarray(batched._spec_chi2_xla_median_only(args[0], args[1], tgt))
        np.testing.assert_allclose(got, ref, rtol=5e-5)
        # and it differs from the renorm'd scoring (regression guard)
        with_renorm = np.asarray(spectrum_chi2_segmented(*args, iters=31))
        assert not np.allclose(got, with_renorm)
        # the annealer convention ignores the fast dial (exact median always)
        fast = np.asarray(spectrum_chi2_segmented(*args, iters=14, renorm=False))
        np.testing.assert_array_equal(fast, got)


class TestProductionDefaultEnvelope:
    """The shipped 14-pass midpoint median vs the exact median through the
    count lane: the RELATIVE log-posterior deviation stays under 2e-2 (the
    14-pass rank-search bound ln2·2^(7-14) ≈ 5.4e-3 median scale error,
    amplified ~2x through the alpha^2 reweighting on small-|L| walkers) and
    the -inf support is identical."""

    def test_default_vs_exact(self, count_lane):
        st, tgt = make_setup(dtype=jnp.float32)
        P = jnp.concatenate([_walkers(st["p_truth"], 24, seed=21, scale=0.03),
                             jnp.ones((1, 6), jnp.float32)])
        exact = np.asarray(batched.log_posterior_batch(
            P, dataclasses.replace(tgt, median_iters=31)))
        prod = np.asarray(batched.log_posterior_batch(
            P, dataclasses.replace(tgt, median_iters=14)))
        np.testing.assert_array_equal(np.isfinite(prod), np.isfinite(exact))
        fin = np.isfinite(exact)
        assert fin.any() and not fin.all()
        rel = np.abs(prod[fin] - exact[fin]) / np.maximum(np.abs(exact[fin]), 1e-9)
        assert rel.max() < 2e-2, rel.max()
        assert not np.array_equal(prod[fin], exact[fin])


class TestCudaLowering:
    """The GPU lanes lower for CUDA on this CPU-only host, so a CPU-only
    operation on the GPU path fails here, not first on the card."""

    @pytest.mark.parametrize("lane,fn", [
        ("xla", "log_posterior_batch"), ("segmented", "log_posterior_batch"),
        ("segmented", "optimizer_chi2_batch")])
    def test_lowers_for_cuda(self, monkeypatch, lane, fn):
        from mcmc_spec_tpu.utils import flags

        monkeypatch.setattr(flags, "spectrum_lane", lambda nd, backend=None: lane)
        st, tgt = make_setup(dtype=jnp.float32)
        P = _walkers(st["p_truth"], 8, seed=1)
        f = jax.jit(lambda p: getattr(batched, fn)(p, tgt))
        text = f.trace(P).lower(lowering_platforms=("cuda",)).as_text()
        assert "func.func public @main" in text
        if lane == "xla":
            assert "stablehlo.sort" in text or "sort" in text
