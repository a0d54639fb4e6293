"""Runtime feature flags (env-overridable) and the spectrum-lane choice."""
from __future__ import annotations

import os

# Above this data-axis width the GPU computes the spectrum block with the
# count-median lane (``ops.spec_segmented``) instead of the sort-based XLA
# composition.  The value is not tuned for the H100: PERF.md records both
# lanes' times on either side of it.
LARGE_ND = 4096


def spectrum_lane(nd: int, backend: str | None = None) -> str:
    """Which implementation computes the spectrum chi^2 block.

    ``"segmented"``: the count-median XLA lane (``ops.spec_segmented``), on
    a GPU beyond ``LARGE_ND`` data points; ``"xla"``: the sort-based
    composition (``inference.batched._spec_chi2_xla``), everywhere else.
    ``backend`` defaults to ``jax.default_backend()``.
    """
    if backend is None:
        import jax

        backend = jax.default_backend()
    return "segmented" if backend == "gpu" and nd > LARGE_ND else "xla"


def median_iters() -> int:
    """Radix-median pass count: DEFAULT 14 (fast), 31 = exact.

    ``MCMC_SPEC_FAST_MEDIAN`` is an accuracy dial: any integer in [8, 31]
    selects that pass count (``31``/``exact`` = np.median-identical; ``1``
    is a legacy alias for 20).  14 passes is the default, adopted on the
    STRUCTURAL tempering bound: on the emcee (renorm) path a relative median
    error eps is exactly a (1+eps)^-2 reweighting of the spectrum chi^2 (the
    alpha^2 factorization, PARITY.md, pinned bit-for-bit by
    ``TestAlphaSquaredFactorization``), and the Cauchy-Schwarz
    posterior-shift bound std(dL) measured over an equilibrated production
    ensemble is 0.027 sigma at 14 passes (0.0068 @ 16, 0.107 @ 12 —
    scripts/median_tempering_bound_cpu.py).  The ANNEALER's renorm=False
    scoring has no such factorization and always uses the exact median
    regardless of this dial (``optimizer_chi2_batch``).  Fast modes return
    the MIDPOINT of the remaining rank-search interval (halved, sign-free
    error).  The dial reaches only the count-median lane
    (``ops.spec_segmented``), which the GPU takes beyond ``LARGE_ND`` data
    points; the sort-based lane (every other case, koi2298's nd 1,792
    among them) is exact at every setting.  Resolved ONCE at
    target-pack time (``pack_target`` -> ``PackedTarget.median_iters``) and
    threaded into the lane as a static argument: the jit cache is keyed on
    shapes and statics only, so an env read at trace time would silently
    miss a change made mid-process.
    """
    raw = os.environ.get("MCMC_SPEC_FAST_MEDIAN", "")
    if not raw:
        return 14
    if raw.lower() == "exact":
        return 31
    n = int(raw)
    if n == 1:
        return 20
    if not 8 <= n <= 31:
        raise ValueError(f"MCMC_SPEC_FAST_MEDIAN={raw!r}: use 'exact', 1, or 8..31")
    return n


def compile_cache_dir() -> str:
    """Directory of JAX's persistent compilation cache.

    ``JAX_COMPILATION_CACHE_DIR`` when it is set; otherwise ``.jax_cache``
    at the root of the checkout (listed in ``.gitignore``).  The path is
    fixed so that repeat runs find what earlier runs compiled.
    """
    env = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if env:
        return env
    root = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    return os.path.join(root, ".jax_cache")


def enable_persistent_compile_cache() -> "str | None":
    """Turn on JAX's persistent compilation cache before the first dispatch.

    Repeat runs of the same shapes then skip compilation.  When
    ``JAX_COMPILATION_CACHE_DIR`` is set, JAX already reads it and no other
    directory is set here.  Returns the cache directory, or None when it
    cannot be created.  Called by the CLI, ``bench.py`` and
    ``chip_smoke.py``.
    """
    import jax

    path = compile_cache_dir()
    try:
        os.makedirs(path, exist_ok=True)
        if not os.environ.get("JAX_COMPILATION_CACHE_DIR"):
            jax.config.update("jax_compilation_cache_dir", path)
        # trivial programs churn the cache for no win
        jax.config.update("jax_persistent_cache_min_compile_time_secs", 1.0)
    except OSError as e:
        print(f"[cache] persistent compilation cache unavailable: {e}")
        return None
    return path
