"""IO robustness: FITS reader over the full public bps/ directory, filters,
results artifacts."""
import os
from glob import glob

import numpy as np
import pytest

from mcmc_spec_tpu.io.fits import list_hdus, read_bintable
from mcmc_spec_tpu.io.filters import infer_system, load_transmission
from mcmc_spec_tpu.io.results import (
    read_optimize_results,
    read_samples,
    write_optimize_results,
    write_samples,
    write_walker_traces,
)

BPS = "/root/reference/bps"
HAVE_BPS = os.path.isdir(BPS)


@pytest.mark.skipif(not HAVE_BPS, reason="bps unavailable")
class TestFitsReaderFuzz:
    def test_every_fits_file_parses(self):
        """Every FITS file the reference's loader could touch must parse."""
        paths = sorted(glob(os.path.join(BPS, "*.fits")))
        paths += sorted(glob(os.path.join(BPS, "*", "*.fits")))
        assert len(paths) > 30
        failures = []
        for p in paths:
            try:
                hdus = list_hdus(p)
                has_table = any(h.get("XTENSION", "").startswith("BINTABLE") for h in hdus)
                if has_table:
                    t = read_bintable(p)
                    assert len(t) >= 1
                    n = {len(v) for v in t.values()}
                    assert len(n) == 1  # all columns same length
            except Exception as e:
                failures.append((os.path.basename(p), repr(e)))
        assert not failures, failures

    def test_vega_spectrum(self):
        t = read_bintable("/root/reference/vegaspec.fits")
        wl, fx = t["WAVELENGTH"], t["FLUX"]
        assert len(wl) == 9170 and np.all(np.diff(wl) > 0)

    def test_every_reference_filter_name_loads(self):
        """All filter names the reference's targets use must resolve."""
        # 'kshort' is omitted: its file (Keck_NIRC2.Ks.dat) is not shipped in
        # the reference's bps/ either — the branch exists for users who have it
        names = ["lp600", "Kp", "j", "h", "k", "562", "692", "880",
                 "kepler", "brgamma", "sdss,r", "sdss,i", "sdss,z",
                 "gaia,g", "gaia,bp", "gaia,rp", "sloan,r", "johnson,v",
                 "johnson,b", "cousins,i", "bessell,j"]
        for name in names:
            c = load_transmission(name, BPS)
            assert len(c.wl) > 10 and np.all(np.isfinite(c.tr)), name
            assert 3000 < c.cwl < 30000, (name, c.cwl)


class TestInferSystem:
    def test_bare_names(self):
        assert infer_system("Kp") == ("keck", "kp")
        assert infer_system("j") == ("2mass", "j")
        assert infer_system("562") == ("dssi", "562")
        assert infer_system("kepler") == ("kep", "kepler")
        assert infer_system("brgamma") == ("nirc2", "brgamma")
        assert infer_system("sdss,r") == ("sdss", "r")


class TestResultsArtifacts:
    def test_round_trips(self, tmp_path):
        d = str(tmp_path)
        params = np.random.randn(10, 6)
        chis = np.random.rand(10)
        write_optimize_results(d, params, chis)
        c2, p2 = read_optimize_results(d)
        np.testing.assert_allclose(p2, params)
        np.testing.assert_allclose(c2, chis)

        samples = np.random.randn(100, 6)
        samples[7, 3] = np.nan  # diverged walker: must round-trip, not
        write_samples(d, samples)  # produce a short row (pandas na_rep)
        back = read_samples(d)
        assert back.shape == (100, 6) and np.isnan(back[7, 3])
        fin = np.isfinite(samples)
        np.testing.assert_allclose(back[fin], samples[fin], rtol=1e-6)

        # reference tools read these with np.genfromtxt — verify
        via_ref = np.genfromtxt(os.path.join(d, "samples.txt"))
        assert via_ref.shape == (100, 6)

        tp = np.random.randn(5, 3, 6)
        tc = np.random.rand(5, 3)
        write_walker_traces(d, tp, tc)
        w0 = np.genfromtxt(os.path.join(d, "params0.txt"))
        assert w0.shape == (5, 6)

    def test_chain_store_contiguity(self, tmp_path):
        """load_upto must refuse a gapped store: concatenating a subset
        would silently drop part of the pre-crash chain (the resume guards
        treat None as 'history unavailable' and restart loudly)."""
        from mcmc_spec_tpu.io.results import ChainStore

        store = ChainStore(str(tmp_path))
        c = np.random.randn(4, 8, 6)
        store.append(0, c)
        store.append(1, c + 1)
        np.testing.assert_allclose(
            store.load_upto(2), np.concatenate([c, c + 1], axis=0))
        store.append(3, c + 3)  # gap: chunk 2 never written
        assert store.load_upto(4) is None
        assert store.load_upto() is None
        assert store.load_upto(2) is not None  # prefix before the gap is fine
        # streamed access obeys the same contract
        assert store.has_chunks(2) and not store.has_chunks(4)
        got = np.concatenate(list(store.iter_chunks(2)), axis=0)
        np.testing.assert_allclose(got, np.concatenate([c, c + 1], axis=0))
        with pytest.raises(ValueError, match="missing chunks"):
            list(store.iter_chunks(4))

    def test_stream_fleet_samples(self, tmp_path):
        """The streamed per-target writer emits byte-identical samples.txt
        to write_samples on the concatenated chain, and its returned arrays
        match the old hold-all path."""
        from mcmc_spec_tpu.fleet_pipeline import stream_fleet_samples
        from mcmc_spec_tpu.io.results import ChainStore, read_samples, write_samples

        rng = np.random.RandomState(2)
        chunks = [rng.randn(5, 3, 8, 6).astype(np.float32) for _ in range(4)]
        chunks[1][2, 1, 3, 2] = np.nan  # diverged walker must round-trip
        store = ChainStore(str(tmp_path))
        for i, ch in enumerate(chunks):
            store.append(i, ch)
        dirnames = []
        for t in range(3):
            d = str(tmp_path / f"tgt{t}")
            os.makedirs(d)
            dirnames.append(d)
        out = stream_fleet_samples(store, dirnames, 4, 6, return_samples=True)
        full = np.concatenate(chunks, axis=0)
        for t, d in enumerate(dirnames):
            want = full[:, t].reshape(-1, 6)
            np.testing.assert_array_equal(out[t], want)
            ref_dir = str(tmp_path / f"ref{t}")
            os.makedirs(ref_dir)
            write_samples(ref_dir, want)
            assert (open(os.path.join(d, "samples.txt"), "rb").read()
                    == open(os.path.join(ref_dir, "samples.txt"), "rb").read())
            got = read_samples(d)
            fin = np.isfinite(want)
            np.testing.assert_array_equal(np.isfinite(got), fin)
            np.testing.assert_array_equal(got[fin].astype(np.float32), want[fin])
        assert stream_fleet_samples(store, dirnames, 4, 6,
                                    return_samples=False) is None

    def test_write_samples_streamed_byte_identity(self, tmp_path):
        """The block-streamed single-target writer and the whole-array
        writer share one format-critical helper (write_sample_block) and
        must emit identical bytes — including 'nan' for diverged rows."""
        from mcmc_spec_tpu.io.results import write_samples, write_samples_streamed

        rng = np.random.RandomState(7)
        arr = rng.randn(64, 6)
        arr[13, 2] = np.nan
        a = tmp_path / "whole"
        b = tmp_path / "streamed"
        os.makedirs(a), os.makedirs(b)
        write_samples(str(a), arr)
        n = write_samples_streamed(str(b), (arr[i:i + 10] for i in range(0, 64, 10)))
        assert n == 64
        assert (a / "samples.txt").read_bytes() == (b / "samples.txt").read_bytes()


@pytest.mark.skipif(not HAVE_BPS, reason="bps unavailable")
class TestBpsTextFormatFuzz:
    """Parse every TEXT-format transmission file in bps/ (.dat/.txt/.csv —
    the existing fuzz covers the FITS files; the *.tab files are binary
    STSDAS tables that neither the reference nor this framework reads — the
    same curves ship as the ``*_002.fits`` variants the generic loader
    branch consumes)."""

    def test_every_text_file_parses(self):
        import glob as globmod

        n_text = 0
        for path in sorted(globmod.glob(os.path.join(BPS, "*"))):
            if os.path.isdir(path):
                continue
            name = os.path.basename(path)
            if name.endswith((".dat", ".txt", ".csv")):
                delim = "," if name.endswith(".csv") else None
                arr = np.genfromtxt(path, delimiter=delim, comments="#")
                assert arr.ndim == 2 and arr.shape[1] >= 2, name
                assert np.isfinite(arr[:, 0]).all(), name  # wavelength column
                n_text += 1
        # Gaia passband tables live in a subdirectory; count them too
        for path in sorted(globmod.glob(os.path.join(BPS, "*", "*.dat"))):
            arr = np.genfromtxt(path)
            assert arr.ndim == 2 and arr.shape[1] >= 2, os.path.basename(path)
            n_text += 1
        assert n_text >= 15, n_text  # 13 top-level .dat/.txt/.csv + Gaia subdir


class TestBintableWriter:
    """``fits.write_bintable`` is the inverse of ``read_bintable``."""

    def test_round_trip_dtypes_and_extname(self, tmp_path):
        from mcmc_spec_tpu.io.fits import write_bintable

        cols = {"WAVELENGTH": np.linspace(1.0, 2.0, 7),
                "THROUGHPUT": np.arange(7, dtype=np.float32) / 3,
                "N": np.arange(7, dtype=np.int32), "BIG": np.arange(7, dtype=np.int64)}
        path = str(tmp_path / "t.fits")
        write_bintable(path, cols, extname="J")
        assert os.path.getsize(path) % 2880 == 0
        for got in (read_bintable(path), read_bintable(path, extname="J")):
            for k, v in cols.items():
                np.testing.assert_array_equal(got[k], v)
        hdus = list_hdus(path)
        assert hdus[0]["SIMPLE"] == "T" and hdus[1]["XTENSION"] == "BINTABLE"

    @pytest.mark.parametrize("cols,match", [
        ({"A": np.ones(3), "B": np.ones(4)}, "differ in length"),
        ({"S": np.array(["a", "b"])}, "unsupported dtype"),
    ])
    def test_rejects_bad_columns(self, tmp_path, cols, match):
        from mcmc_spec_tpu.io.fits import write_bintable

        with pytest.raises(ValueError, match=match):
            write_bintable(str(tmp_path / "bad.fits"), cols)


class TestSyntheticFilterDir:
    """``bench_target.write_filter_dir`` writes each curve in the file
    format ``load_transmission`` reads for it; reading it back gives the
    Gaussian stand-in curve, whatever the format's units."""

    @pytest.mark.parametrize("name,key", [
        ("lp600", "lp600"), ("Kp", "Kp"), ("sdss,r", "sdss,r"),
        ("sdss,i", "sdss,i"), ("sdss,z", "sdss,z"), ("2mass,j", "2mass,j"),
        ("2mass,h", "2mass,h"), ("2mass,ks", "2mass,ks"), ("kepler", "kepler"),
        ("gaia,g", "gaia,g"),
    ])
    def test_round_trip(self, bps_dir, name, key):
        from mcmc_spec_tpu.bench_target import filter_curve

        want = filter_curve(key)
        got = load_transmission(name, bps_dir)
        np.testing.assert_allclose(got.wl, want.wl, rtol=1e-12)
        # the loader normalises 2MASS Ks to its peak
        tr = want.tr / want.tr.max() if key == "2mass,ks" else want.tr
        np.testing.assert_allclose(got.tr, tr, rtol=1e-12)

    def test_filter_bank_resolves_the_fit_set(self, bps_dir):
        """The koi2298 contrast and photometry sets resolve, with AB zero
        points for SDSS and the Vega fallback for 2MASS."""
        from mcmc_spec_tpu.bench_target import CFILT, PFILT
        from mcmc_spec_tpu.io.filters import VEGA_ZERO_FLUX_FALLBACK, FilterBank

        bank = FilterBank(bps_dir)
        assert [c.name for c in bank.contrast_curves(CFILT)] == CFILT
        curves, zps = bank.phot_passbands(PFILT)
        assert len(curves) == 6 and np.all(np.isfinite(zps))
        assert zps[3] == VEGA_ZERO_FLUX_FALLBACK["2MASS_J"]
