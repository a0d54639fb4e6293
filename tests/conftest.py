import os

import pytest

# Tests run on a virtual 8-device CPU mesh; sharding-correctness is validated
# here, performance on the GPU via bench.py.
os.environ["JAX_PLATFORMS"] = "cpu"
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = flags + " --xla_force_host_platform_device_count=8"

# Parity suites validate EXACT np.median semantics against the scalar /
# emulator references; the production default pass count lives in
# utils/flags.py::median_iters (the single source of truth, with the
# measured posterior-impact receipts — scripts/median_tempering_bound_cpu.py).
# The fast modes' accuracy envelopes have their own dedicated tests
# (TestFastMedian, TestPackTimeDials set the env explicitly).
os.environ.setdefault("MCMC_SPEC_FAST_MEDIAN", "exact")

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")

# float64 on CPU for golden-value comparisons; the GPU path packs float32.
jax.config.update("jax_enable_x64", True)


@pytest.fixture(scope="session")
def bps_dir(tmp_path_factory):
    """A filter-curve directory in the reference's file formats, from the
    synthetic koi2298 filter set (``bench_target.write_filter_dir``)."""
    from mcmc_spec_tpu.bench_target import write_filter_dir

    return write_filter_dir(str(tmp_path_factory.mktemp("bps")))
