"""shard_map'd ensemble sampling: walkers across chips, chains on-device.

Layout: the ensemble is ``[2, nh, ndim]`` (red/black halves); the half axis is
replicated and the ``nh`` walker axis is sharded over the mesh's ``walkers``
axis.  A stretch-move half-update needs the *entire* complement half (each
walker draws a random partner from it), which costs one ``all_gather`` of
``nh x ndim`` floats per half — a few KB — after which everything is
local.  This is the whole communication surface of the sampler; compare the
reference's fork+pickle process pool (``mft6.py:1744-1755``).

The full chain (scan over steps) runs *inside* ``shard_map`` under one jit, so
multi-chip runs have zero per-step host dispatch.
"""
from __future__ import annotations

import functools
from typing import Callable

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P
from jax import shard_map

from mcmc_spec_tpu.inference.stretch import EnsembleState, _stretch_z


def shard_ensemble_state(coords, log_prob_fn, key, mesh: Mesh, axis="walkers"):
    """Build an [2, nh, ...] EnsembleState sharded over ``axis``.

    ``coords`` is the flat ``[nw, ndim]`` ensemble; nw must be divisible by
    ``2 * mesh.shape[axis]``.
    """
    nw, ndim = coords.shape
    ndev = mesh.shape[axis]
    assert nw % (2 * ndev) == 0, f"nw={nw} must divide by 2*{ndev}"
    coords2 = jnp.asarray(coords).reshape(2, nw // 2, ndim)
    logp2 = log_prob_fn(jnp.asarray(coords)).reshape(2, nw // 2)
    sh = NamedSharding(mesh, P(None, axis))
    coords2 = jax.device_put(coords2, sh)
    logp2 = jax.device_put(logp2, sh)
    return EnsembleState(coords2, logp2, key, jnp.zeros((), jnp.int32))


def _half_update_local(coords2, logp2, key, n_acc, half, log_prob_fn, a, axis):
    """Update one half; runs per-shard inside shard_map."""
    nh_local, ndim = coords2.shape[1], coords2.shape[2]
    me = jax.lax.axis_index(axis)

    # complement half, gathered across all shards (the only collective)
    comp = jax.lax.all_gather(coords2[1 - half], axis, axis=0, tiled=True)  # [nh, ndim]
    nh = comp.shape[0]

    key, kz, kp, ka = jax.random.split(jax.random.fold_in(key, half), 4)
    kz = jax.random.fold_in(kz, me)
    kp = jax.random.fold_in(kp, me)
    ka = jax.random.fold_in(ka, me)

    z = _stretch_z(kz, (nh_local,), a)
    partner_idx = jax.random.randint(kp, (nh_local,), 0, nh)
    partners = comp[partner_idx]

    cur = coords2[half]
    proposal = partners + z[:, None] * (cur - partners)
    logp_new = log_prob_fn(proposal)
    log_ratio = (ndim - 1) * jnp.log(z) + logp_new - logp2[half]
    accept = jnp.log(jax.random.uniform(ka, (nh_local,))) < log_ratio

    coords2 = coords2.at[half].set(jnp.where(accept[:, None], proposal, cur))
    logp2 = logp2.at[half].set(jnp.where(accept, logp_new, logp2[half]))
    n_acc = n_acc + jax.lax.psum(jnp.sum(accept), axis).astype(n_acc.dtype)
    return coords2, logp2, key, n_acc


def sharded_log_prob(log_prob_fn: Callable, mesh: Mesh, axis="walkers"):
    """vmap a scalar log-prob over a walker-sharded batch via shard_map."""

    @functools.partial(
        shard_map,
        mesh=mesh,
        in_specs=(P(axis),),
        out_specs=P(axis),
        check_vma=False,
    )
    def batched(coords):
        return log_prob_fn(coords)

    return batched


def sharded_stretch_step(state, log_prob_fn, mesh, a=2.0, axis="walkers"):
    """One distributed full ensemble update (for step-at-a-time drivers)."""
    return _sharded_steps(state, log_prob_fn, mesh, 1, 1, a, axis)[0]


@functools.partial(
    jax.jit, static_argnames=("log_prob_fn", "mesh", "n_steps", "thin", "a", "axis")
)
def run_ensemble_sharded(
    state: EnsembleState,
    log_prob_fn: Callable,
    mesh: Mesh,
    n_steps: int,
    thin: int = 1,
    a: float = 2.0,
    axis: str = "walkers",
):
    """Distributed analogue of ``run_ensemble``: whole chain in one shard_map.

    Returns ``(final_state, chain [n_steps//thin, 2, nh, ndim], logps)`` with
    the chain sharded like the ensemble.
    """
    return _sharded_steps(state, log_prob_fn, mesh, n_steps, thin, a, axis)


def _sharded_steps(state, log_prob_fn, mesh, n_steps, thin, a, axis,
                   extra=None, extra_specs=None, logp_factory=None):
    """Whole stretch chain in one shard_map over the walker axis.

    ``extra`` / ``extra_specs`` / ``logp_factory``: optional additional
    shard_map input (a pytree, e.g. a spec-sharded ``PackedTarget``) with
    its PartitionSpec tree, and a factory building the per-shard log-prob
    from the local view of that input.  This is how
    ``parallel.spec_shard.run_ensemble_spec_sharded`` reuses the sampler
    loop on a 2-D (walkers, spec) mesh instead of duplicating it.
    """
    n_keep = max(n_steps // thin, 1)

    pspec_coords = P(None, axis)
    in_specs = (pspec_coords, pspec_coords, P(), P())
    if extra is not None:
        in_specs = in_specs + (extra_specs,)
    out_specs = (
        (pspec_coords, pspec_coords, P(), P()),
        (P(None, None, axis), P(None, None, axis)),
    )

    @functools.partial(shard_map, mesh=mesh, in_specs=in_specs, out_specs=out_specs,
                       check_vma=False)
    def scan_chain(coords2, logp2, key, n_acc, *rest):
        logp = logp_factory(rest[0]) if logp_factory is not None else log_prob_fn

        def one_step(carry, _):
            coords2, logp2, key, n_acc = carry
            key, sub = jax.random.split(key)
            coords2, logp2, sub, n_acc = _half_update_local(
                coords2, logp2, sub, n_acc, 0, logp, a, axis
            )
            coords2, logp2, sub, n_acc = _half_update_local(
                coords2, logp2, sub, n_acc, 1, logp, a, axis
            )
            return (coords2, logp2, key, n_acc), None

        def outer(carry, _):
            carry, _ = jax.lax.scan(one_step, carry, None, length=thin)
            return carry, (carry[0], carry[1])

        carry, chain = jax.lax.scan(outer, (coords2, logp2, key, n_acc), None, length=n_keep)
        return carry, chain

    args = (state.coords, state.log_prob, state.key, state.n_accept)
    if extra is not None:
        args = args + (extra,)
    (coords2, logp2, key, n_acc), (chain, logps) = scan_chain(*args)
    return EnsembleState(coords2, logp2, key, n_acc), chain, logps
