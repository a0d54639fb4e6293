"""Spectral-axis (sp) model parallelism: wavelength shards across chips.

The walker mesh axis (``parallel.sharding``) scales the *ensemble*; this
module adds the orthogonal scaling axis the reference has no analogue of:
sharding the **wavelength axis** of the packed target across chips.  The
dominant device tensor of a fit is the grid projection ``D [nT, nG, nd]``
(plus the per-point data/renorm vectors); at full native PHOENIX resolution
``nd`` is O(10^5-10^6) and a dense temperature grid pushes ``D`` past one
chip's HBM.  With ``nd`` sharded, every chip holds ``1/n_spec`` of the grid
and of the per-point work, and the log-posterior stays *exact*:

* the model-spectrum matmul ``Wcomb @ D`` is column-parallel (each chip
  produces its wavelength slice of the model — classic tensor-parallel
  layout, zero communication);
* extinction and the per-point residuals are elementwise (local);
* the continuum-renorm projection ``frac @ Vpinv.T`` and the chi^2
  reduction are sums over wavelength -> one ``psum`` each ([nw, 3] and
  [nw] floats between the cards);
* the rank-based median is computed by a **distributed radix select**: the
  non-negative f32 bit range is searched on per-pass *counts*, and counts
  are additive across shards — so ``psum``-ing the local counts reproduces
  the single-chip search, and therefore the median, **bit-exactly**
  (since round 5: 2 bits per round via quartile thresholds, one [nw, 3]
  int32 psum each — a whole renorm eval is 19 psums + 1 pmin, vs 34 under
  the round-4 bisection; census pinned in ``bench_suite.py spshard``;
  ``ops.spec_segmented.median_nonneg_xla``).

Everything wavelength-independent (photometry, contrasts, priors, bounds)
is computed redundantly per shard from replicated inputs — a few percent
of the work, identical on every chip.

Semantics match the single-device spectrum chi^2 (exact median; the
fast-median tempering dial applies to the single-device count-median lane
only — see ``utils.flags.median_iters``), pinned by tests/test_spec_shard.py on the
8-device virtual CPU mesh against ``inference.batched``.

Composes with walker data-parallelism on a 2-D ``(walkers, spec)`` mesh:
``run_ensemble_spec_sharded`` runs the full stretch-move chain with the
complement ``all_gather`` riding the walker axis and the spectrum psums
riding the spec axis.

Reference scope note: the reference evaluates one spectrum per process on
host numpy (mft6.py:994-1046) and its parallelism is an OS process pool
(mft6.py:1744-1755); wavelength sharding has no reference counterpart —
it exists so grids larger than one chip's HBM can run at all.
"""
from __future__ import annotations

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
from jax import shard_map
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from mcmc_spec_tpu.inference.batched import _HI, log_posterior_batch
from mcmc_spec_tpu.inference.stretch import EnsembleState
from mcmc_spec_tpu.inference.target import PackedTarget
# PackedTarget data fields carrying the data-wavelength axis, with the axis
# position ``nd`` occupies in each (everything else is replicated).
_SPEC_AXIS_FIELDS = {
    "D": 2,          # [nT, nG, nd]
    "data_flux": 0,  # [nd]
    "data_err": 0,   # [nd]
    "ext_k_data": 0, # [nd]
    "V": 0,          # [nd, 3]
    "Vpinv": 1,      # [3, nd]
}


def target_spec_tree(tgt: PackedTarget, spec_axis: str = "spec") -> PackedTarget:
    """PackedTarget-shaped pytree of PartitionSpecs: nd axis -> ``spec_axis``.

    Used both as ``shard_map`` in_specs and (via :func:`shard_target_over_spec`)
    to place the target on the mesh.
    """
    reps = {}
    for field in dataclasses.fields(tgt):
        name = field.name
        if name in _SPEC_AXIS_FIELDS:
            axpos = _SPEC_AXIS_FIELDS[name]
            ndim = np.ndim(getattr(tgt, name))
            spec = [None] * ndim
            spec[axpos] = spec_axis
            reps[name] = P(*spec)
        elif name in PackedTarget.__dataclass_fields__ and not _is_meta(name):
            reps[name] = P()
    return dataclasses.replace(tgt, **reps)


def _is_meta(name: str) -> bool:
    return name in (
        "nspec", "dist_fit", "rad_prior", "fit_plx", "spectrum_weight",
        "median_iters", "rad_sigma_frac",
    )


def pad_packed_target_nd(tgt: PackedTarget, pad_nd: int) -> PackedTarget:
    """Pad an already-packed target's data axis to ``pad_nd`` points.

    Applies exactly the inert sentinel scheme ``pack_target(pad_nd=...)``
    uses — the shared ``target.pad_nd_arrays`` helper (tests pin
    field-for-field equality): medians, the renorm fit, and the residual
    sum are unchanged.  Used to round ``nd`` up to a multiple of the
    spec-mesh size.

    The concatenation runs in HOST numpy and the padded fields are
    returned as host arrays cast to the target dtype:
    ``shard_target_over_spec``'s ``device_put`` then sends each device
    only its shard, so the full padded ``D`` is never staged on one device
    (the whole point of spectral sharding).
    """
    from mcmc_spec_tpu.inference.target import pad_nd_arrays

    nd = tgt.n_data
    if pad_nd < nd:
        raise ValueError(f"pad_nd={pad_nd} < current nd={nd}")
    if pad_nd == nd:
        return tgt
    dt = np.dtype(tgt.data_flux.dtype)
    D, data_flux, data_err, ext_k_data, V, Vpinv = pad_nd_arrays(
        np.asarray(tgt.D), np.asarray(tgt.data_flux, dt),
        np.asarray(tgt.data_err, dt), np.asarray(tgt.ext_k_data, dt),
        np.asarray(tgt.V, dt), np.asarray(tgt.Vpinv, dt),
        pad_nd - nd,
    )
    return dataclasses.replace(
        tgt,
        D=D, data_flux=data_flux, data_err=data_err,
        ext_k_data=ext_k_data, V=V, Vpinv=Vpinv,
    )


def shard_target_over_spec(
    tgt: PackedTarget, mesh: Mesh, spec_axis: str = "spec"
) -> PackedTarget:
    """Place a packed target on ``mesh`` with the nd axis sharded.

    ``tgt.n_data`` must divide the spec-mesh size — round up first with
    :func:`pad_packed_target_nd` (or pack with ``pad_nd=``).
    """
    nshard = mesh.shape[spec_axis]
    if tgt.n_data % nshard != 0:
        raise ValueError(
            f"n_data={tgt.n_data} not divisible by {nshard} '{spec_axis}' shards; "
            f"pad first: pad_packed_target_nd(tgt, {-(-tgt.n_data // nshard) * nshard})"
        )
    specs = target_spec_tree(tgt, spec_axis)
    return jax.tree_util.tree_map(
        lambda x, sp: jax.device_put(x, NamedSharding(mesh, sp)), tgt, specs
    )


# --------------------------------------------------------------- local math
def _dist_median_nonneg(model_local, n_true, axis: str):
    """Exact np.median over the *global* wavelength axis, per row.

    Matches the single-device count median bit for bit: an
    exact radix search of the non-negative f32 bit range driven by rank
    counts — here the counts are ``psum``-med over the spec shards, which
    reproduces the single-chip result exactly.  ``n_true`` is the global
    count of REAL points; fleet/spec padding carries sentinel model values
    (~1e30) that sort above every real point, so rank ``(n_true+1)//2``
    always lands on a real value (same convention as the XLA backend's
    sorted-rank median, batched.py:127-131).

    Unlike the single-chip helper, ``n_true``'s parity is traced (it is a
    device scalar), so the even-rank refinement (one extra count pass + a
    ``pmin``) always runs and a ``where`` selects.

    Dtype-generic: f32 is the production path (31 bits of int32 range,
    16 2-bit rounds); f64 (the x64 CPU test lane — the sampler's proposal
    arithmetic promotes) searches the int64 bit range (63 bits, 32 rounds).

    PRECONDITION (the same invariant as the single-device count median,
    ``ops.spec_segmented.median_nonneg_xla``): every element of ``model_local`` must be
    **non-negative** — the bisection starts at ``lo=0``, so a negative
    value (whose bit pattern bitcasts to a negative int, always counted by
    ``mi <= mid``) would corrupt the rank counts.  This holds by
    construction for the spectrum model: ``model = Wcomb @ D * trans``
    where the tent-basis blend weights are clipped to [0, 1]
    (``ops.interp.tent_weights``), the component scales are squared radii
    (>= 0), the grid fluxes ``D`` are physical fluxes (>= 0; padding
    sentinel 1e30), and the extinction transmission is an exponential
    (> 0).  Callers feeding anything else must clamp first.
    """
    from mcmc_spec_tpu.ops.spec_segmented import median_nonneg_xla

    # since round 5 the search runs 2 bits per round (k-ary quartile
    # thresholds; the three counts fuse into one pass over the data AND one
    # [nw, 3] psum) — HALF the collective latency rounds per eval: 17 int32 psums
    # (15 two-bit rounds + the final single-bit count + the even-rank
    # refinement) instead of 32 in f32; a renorm eval is 19 psums + 1 pmin
    # (census: benchmarks/bench_suite.py `spshard`).  Exact mode is
    # unchanged bit for bit (it is an exact order-statistic search; the
    # bit-exactness tests pin it).
    return median_nonneg_xla(model_local, n_true, psum_axis=axis)


def _spec_chi2_psum(Wcomb, av, tgt: PackedTarget, axis: str, renorm: bool = True):
    """Mean spectrum chi^2 with the wavelength axis sharded over ``axis``.

    Same semantics as ``batched._spec_chi2_xla`` (renorm=True, the emcee
    likelihood) / ``_spec_chi2_xla_median_only`` (renorm=False, the
    annealer's convention): per-shard slices of the model, one psum each
    for the renorm projection and the residual sum, distributed median.
    """
    nT, nG, ndl = tgt.D.shape  # ndl = local shard width
    model = jnp.matmul(Wcomb, tgt.D.reshape(nT * nG, ndl), precision=_HI)
    apply_ext = (av > 0)[:, None]
    trans = jnp.where(
        apply_ext,
        jnp.exp((-0.4 * jnp.log(10.0)) * av[:, None] * tgt.ext_k_data[None, :]),
        1.0,
    )
    model = model * trans
    med = _dist_median_nonneg(model, tgt.n_data_true, axis)
    model = model * (tgt.med_data / med)[:, None]
    if renorm:
        frac = tgt.data_flux[None, :] / model
        coeffs = jax.lax.psum(jnp.matmul(frac, tgt.Vpinv.T, precision=_HI), axis)
        data_ref = tgt.data_flux[None, :] / jnp.matmul(coeffs, tgt.V.T, precision=_HI)
    else:
        data_ref = tgt.data_flux[None, :]
    resid2 = ((model - data_ref) / tgt.data_err) ** 2
    resid2 = jnp.where(jnp.isfinite(resid2), resid2, 0.0)  # padded: err=inf
    total = jax.lax.psum(jnp.sum(resid2, axis=1), axis)
    return total / tgt.n_data_true.astype(model.dtype)


def _local_optimizer_chi2(p_local, rad_sigma, tgt_local: PackedTarget, spec_axis: str):
    """Per-shard annealer chi^2: the median-only spectrum term via psums.

    The annealer always scores with the EXACT median (its renorm=False
    convention has no alpha^2 protection — see ``batched.optimizer_chi2_batch``);
    the distributed median here is exact by construction.
    """
    from mcmc_spec_tpu.inference.batched import _forward_small, optimizer_chi2_batch

    if tgt_local.spectrum_weight == 0.0:
        chi_spec = jnp.zeros(p_local.shape[0], dtype=p_local.dtype)
    else:
        av = p_local[:, tgt_local.nspec]
        *_, Wcomb = _forward_small(p_local, tgt_local)
        chi_spec = _spec_chi2_psum(Wcomb, av, tgt_local, spec_axis, renorm=False)
    return optimizer_chi2_batch(p_local, tgt_local, rad_sigma=rad_sigma,
                                chi_spec=chi_spec)


def _local_log_posterior(p_local, tgt_local: PackedTarget, spec_axis: str):
    """Per-shard body: spectrum term via psums, everything else replicated."""
    from mcmc_spec_tpu.inference.batched import _forward_small

    if tgt_local.spectrum_weight == 0.0:
        chi_spec = jnp.zeros(p_local.shape[0], dtype=p_local.dtype)
    else:
        n = tgt_local.nspec
        av = p_local[:, n]
        *_, Wcomb = _forward_small(p_local, tgt_local)
        chi_spec = _spec_chi2_psum(Wcomb, av, tgt_local, spec_axis)
    return log_posterior_batch(p_local, tgt_local, chi_spec=chi_spec)


# ------------------------------------------------------------- public API
def make_spec_logpost(
    tgt: PackedTarget, mesh: Mesh, spec_axis: str = "spec",
    walker_axis: str | None = None,
):
    """Jitted ``fn(p, tgt) -> logp [nw]`` with the target spec-sharded.

    ``walker_axis``: also shard the walker batch rows over that mesh axis
    (2-D hybrid).  ``tgt`` must already be placed by
    :func:`shard_target_over_spec` (it is only used here for its pytree
    structure / statics; pass the same object at call time).
    """
    pspec = P(walker_axis) if walker_axis else P()
    specs = target_spec_tree(tgt, spec_axis)
    f = shard_map(
        functools.partial(_local_log_posterior, spec_axis=spec_axis),
        mesh=mesh,
        in_specs=(pspec, specs),
        out_specs=pspec,
        check_vma=False,
    )
    return jax.jit(f)


def shard_spec_ensemble_state(
    coords, tgt: PackedTarget, key, mesh: Mesh,
    walker_axis: str = "walkers", spec_axis: str = "spec",
) -> EnsembleState:
    """[2, nh, ndim] ensemble state for the 2-D (walkers, spec) mesh."""
    nw, ndim = coords.shape
    ndev = mesh.shape[walker_axis]
    assert nw % (2 * ndev) == 0, f"nw={nw} must divide by 2*{ndev}"
    logp_fn = make_spec_logpost(tgt, mesh, spec_axis, walker_axis=None)
    logp2 = logp_fn(jnp.asarray(coords), tgt).reshape(2, nw // 2)
    coords2 = jnp.asarray(coords).reshape(2, nw // 2, ndim)
    sh = NamedSharding(mesh, P(None, walker_axis))
    return EnsembleState(
        jax.device_put(coords2, sh), jax.device_put(logp2, sh), key,
        jnp.zeros((), jnp.int32),
    )


@functools.partial(
    jax.jit,
    static_argnames=("mesh", "steps", "record_thin", "walker_axis", "spec_axis"),
)
def run_anneal_spec_sharded(
    tgt: PackedTarget,
    p0,
    key,
    mesh: Mesh,
    steps: int = 200,
    record_thin: int = 0,
    walker_axis: str = "walkers",
    spec_axis: str = "spec",
):
    """Stage-1 annealer on a 2-D (walkers, spec) mesh.

    The annealing schedule (``inference.anneal._anneal_scan``) runs per
    walker shard — walkers are fully independent, so the only collective is
    the spectrum term's psums.  The RNG key folds in the walker-shard index
    (identical across spec shards, like the ensemble sampler), so the
    proposal stream differs from single-device ``run_anneal`` in layout but
    not in distribution.  Returns (params [nw, ndim], chi [nw], trace).
    """
    from mcmc_spec_tpu.inference.anneal import _anneal_scan

    pw = P(walker_axis)
    in_specs = (target_spec_tree(tgt, spec_axis), pw, P())
    if record_thin:
        out_specs = (pw, pw, (P(None, walker_axis), P(None, walker_axis)))
    else:
        out_specs = (pw, pw)

    @functools.partial(shard_map, mesh=mesh, in_specs=in_specs,
                       out_specs=out_specs, check_vma=False)
    def local(t, p0_local, key):
        me = jax.lax.axis_index(walker_axis)
        chi_fn = lambda p, rs: _local_optimizer_chi2(p, rs, t, spec_axis)
        params, chi, trace = _anneal_scan(
            t, p0_local, jax.random.fold_in(key, me), steps, record_thin, chi_fn
        )
        return (params, chi, trace) if record_thin else (params, chi)

    out = local(tgt, jnp.asarray(p0), key)
    return out if record_thin else (out[0], out[1], None)


@functools.partial(
    jax.jit,
    static_argnames=("mesh", "n_steps", "thin", "a", "walker_axis", "spec_axis"),
)
def run_ensemble_spec_sharded(
    state: EnsembleState,
    tgt: PackedTarget,
    mesh: Mesh,
    n_steps: int,
    thin: int = 1,
    a: float = 2.0,
    walker_axis: str = "walkers",
    spec_axis: str = "spec",
):
    """Full stretch-move chain on a 2-D (walkers, spec) mesh, one shard_map.

    The sampler mechanics are ``parallel.sharding._sharded_steps`` — the
    SAME scan/half-update loop as the walkers-only chain (complement
    ``all_gather`` + RNG fold over the WALKER axis only, so the proposal
    stream is identical on every spec shard) — with the spec-sharded
    target threaded in as the extra shard_map input and the psum
    composition above as its per-shard log-posterior.  Returns
    ``(final_state, chain, logps)`` shaped like ``run_ensemble_sharded``.
    """
    from mcmc_spec_tpu.parallel.sharding import _sharded_steps

    return _sharded_steps(
        state, None, mesh, n_steps, thin, a, walker_axis,
        extra=tgt,
        extra_specs=target_spec_tree(tgt, spec_axis),
        logp_factory=lambda t: (lambda q: _local_log_posterior(q, t, spec_axis)),
    )
