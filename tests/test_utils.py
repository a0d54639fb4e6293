"""utils coverage: run logs, profiling helpers, feature flags."""
import json
import os
import time

import numpy as np
import pytest

from mcmc_spec_tpu.utils.flags import LARGE_ND, spectrum_lane
from mcmc_spec_tpu.utils.profiling import StageTimer, device_loop_time
from mcmc_spec_tpu.utils.runlog import RunLog, read_run_log


class TestRunLog:
    def test_events_and_timing(self, tmp_path):
        log = RunLog(str(tmp_path))
        log.start("stage_a", nwalk=10)
        time.sleep(0.01)
        log.end("stage_a", result=1.5)
        log.event("custom", value=42)
        events = read_run_log(str(tmp_path))
        assert [e["event"] for e in events] == ["stage_a.start", "stage_a.end", "custom"]
        assert events[1]["wall_s"] >= 0.01
        assert events[2]["value"] == 42

    def test_missing_log(self, tmp_path):
        assert read_run_log(str(tmp_path / "nope")) == []


class TestStageTimer:
    def test_compile_run_split(self):
        t = StageTimer()
        for _ in range(3):
            with t.stage("x"):
                time.sleep(0.005)
        assert "x" in t.first
        assert t.counts["x"] == 2  # first call counted separately
        rep = t.report()
        assert "x" in rep and "steady" in rep


class TestDeviceLoopTime:
    def test_returns_positive_seconds(self):
        import jax.numpy as jnp

        dt = device_loop_time(lambda x: (x * 2.0).sum(), jnp.ones((128, 128)), rep=5)
        assert 0 < dt < 1.0


class TestFlags:
    @pytest.mark.parametrize("backend,nd,lane", [
        ("gpu", 1792, "xla"),
        ("gpu", LARGE_ND, "xla"),
        ("gpu", LARGE_ND + 1, "segmented"),
        ("gpu", 65536, "segmented"),
        ("cpu", 1792, "xla"),
        ("cpu", 65536, "xla"),
    ])
    def test_spectrum_lane(self, backend, nd, lane):
        assert spectrum_lane(nd, backend=backend) == lane

    def test_spectrum_lane_reads_the_platform(self):
        """Without an explicit backend the lane follows JAX's default (the
        CPU here), never an environment variable."""
        assert spectrum_lane(65536) == "xla"

    def test_compile_cache_env_dir(self, tmp_path, monkeypatch):
        """JAX_COMPILATION_CACHE_DIR wins, and no other directory is set."""
        import jax

        from mcmc_spec_tpu.utils.flags import enable_persistent_compile_cache

        prev = jax.config.jax_compilation_cache_dir
        cache = str(tmp_path / "xla-cache")
        monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", cache)
        try:
            jax.config.update("jax_compilation_cache_dir", "sentinel")
            assert enable_persistent_compile_cache() == cache
            assert os.path.isdir(cache)
            assert jax.config.jax_compilation_cache_dir == "sentinel"
        finally:
            jax.config.update("jax_compilation_cache_dir", prev)

    def test_compile_cache_default_in_checkout(self, monkeypatch):
        """Without the env var the cache sits at one fixed path in the checkout."""
        import jax

        import mcmc_spec_tpu
        from mcmc_spec_tpu.utils.flags import compile_cache_dir, enable_persistent_compile_cache

        monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
        root = os.path.dirname(os.path.dirname(os.path.abspath(mcmc_spec_tpu.__file__)))
        assert compile_cache_dir() == os.path.join(root, ".jax_cache")
        prev = jax.config.jax_compilation_cache_dir
        try:
            assert enable_persistent_compile_cache() == compile_cache_dir()
            assert jax.config.jax_compilation_cache_dir == compile_cache_dir()
        finally:
            jax.config.update("jax_compilation_cache_dir", prev)


class TestMakeMesh:
    def test_too_few_devices_raises(self):
        """No silent fallback to other devices: asking for more than the
        default backend has is an error."""
        import jax

        from mcmc_spec_tpu.parallel.mesh import make_mesh

        n = len(jax.devices())
        with pytest.raises(ValueError, match=f"need {n + 1} devices"):
            make_mesh(n + 1)

    def test_explicit_devices(self):
        import jax

        from mcmc_spec_tpu.parallel.mesh import make_mesh

        cpus = jax.devices("cpu")
        mesh = make_mesh(4, ("targets", "walkers"), devices=cpus)
        assert dict(mesh.shape) == {"targets": 2, "walkers": 2}
        assert list(mesh.devices.ravel()) == cpus[:4]


class TestExtras:
    def test_missing_module_exits_with_message(self):
        from mcmc_spec_tpu.utils.extras import require

        with pytest.raises(SystemExit, match=r"install the 'plots' extra.*--noplots"):
            require("no_such_module_xyz", "plots", hint="or pass --noplots")
        require("numpy", "plots")  # present: no error

    def test_fit_path_imports_without_extras(self):
        """The CLI fit path needs only jax, numpy and scipy: it imports with
        matplotlib and pandas unavailable."""
        import subprocess
        import sys

        code = ("import sys; sys.modules['matplotlib'] = None; "
                "sys.modules['pandas'] = None; "
                "import mcmc_spec_tpu.cli, mcmc_spec_tpu.fleet_pipeline, "
                "mcmc_spec_tpu.bench_target, mcmc_spec_tpu.report.composite")
        repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
        out = subprocess.run([sys.executable, "-c", code], cwd=repo,
                             capture_output=True, text=True, timeout=300,
                             env=dict(os.environ, JAX_PLATFORMS="cpu"))
        assert out.returncode == 0, out.stderr[-2000:]


class TestConfigParserRobustness:
    """Adversarial param-file variants beyond the verbatim koi2298 fixture:
    tab-separated values, inline comments, blank/comment-only lines, CRLF
    endings, unknown keys (silently ignored, as the reference's dict parser
    does), float-typed ints, and the filename-keyed synth switch."""

    def test_adversarial_param_file(self, tmp_path):
        from mcmc_spec_tpu.utils.config import FitConfig

        path = tmp_path / "param_weird.txt"
        path.write_bytes(
            b"# leading comment\r\n"
            b"\r\n"
            b"models\tsynthetic\t#tab separated\r\n"
            b"res 1700    # trailing comment\n"
            b"tmin 3000\n"
            b"tmax 5600.0\n"           # float-typed int
            b"unknown_key whatever\n"  # ignored like the reference
            b"cmag [1.5,2.5]\n"
            b"cfilt ['lp600','Kp']\n"
            b"mask TRUE\n"
            b"rad_prior f\n"
            b"plx 2e-3\n"
            b"nwalk 16\n"
            b"nsteps  5000\n"          # run of spaces (hand-aligned file)
        )
        cfg = FitConfig.from_file(str(path))
        assert cfg.models == "synthetic"
        assert cfg.res == 1700 and cfg.tmin == 3000 and cfg.tmax == 5600
        assert cfg.nsteps == 5000  # must not be silently dropped to default
        assert cfg.cmag == [1.5, 2.5] and cfg.cfilt == ["lp600", "Kp"]
        assert cfg.mask is True and cfg.rad_prior is False
        assert abs(cfg.plx - 2e-3) < 1e-12 and cfg.nwalk == 16
        assert not cfg.synth

    def test_synth_switch_keys_off_filename(self, tmp_path):
        from mcmc_spec_tpu.utils.config import FitConfig

        p = tmp_path / "param_synth_3850_3225.txt"
        p.write_text("models synthetic\n")
        assert FitConfig.from_file(str(p)).synth  # mft6.py:3553
        q = tmp_path / "param_koi9999.txt"
        q.write_text("models synthetic\n")
        assert not FitConfig.from_file(str(q)).synth
