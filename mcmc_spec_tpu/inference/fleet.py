"""Fleet mode: many targets x many walkers in one jitted program.

BASELINE.md config 5: all KOI targets x 4096 walkers fit simultaneously.
The reference runs one process invocation per target (SURVEY.md parallelism
table: "data parallel over targets — shell-level"); here the target axis is a
batch dimension of the same compiled program.

Targets are ragged (different data lengths, contrast-filter counts), so each
is packed with ``pad_nd``/``pad_nc`` to the fleet maxima — padded entries are
inert by construction (infinite errors, zero renorm weights, sentinel model
values above any real flux so rank-based medians ignore them) — and the
per-target arrays are stacked on a leading axis.  ``log_posterior_fleet`` is
then a plain ``vmap`` of the batched posterior over that axis; meshes shard
either axis (targets are embarrassingly parallel; walkers need only the
stretch move's complement ``all_gather``).
"""
from __future__ import annotations

from typing import Sequence

import jax
import jax.numpy as jnp

from mcmc_spec_tpu.inference.batched import log_posterior_batch, optimizer_chi2_batch
from mcmc_spec_tpu.inference.stretch import EnsembleState, _stretch_z
from mcmc_spec_tpu.inference.target import PackedTarget


def stack_targets(targets: Sequence[PackedTarget]) -> PackedTarget:
    """Stack identically-shaped PackedTargets on a new leading axis.

    All targets must share meta config and array shapes (pack with matching
    ``pad_nd``/``pad_nc`` and the same grid/MIST shapes).
    """
    t0 = targets[0]
    for t in targets[1:]:
        assert t.nspec == t0.nspec and t.fit_plx == t0.fit_plx, "mixed fleet configs"
        assert t.dist_fit == t0.dist_fit and t.rad_prior == t0.rad_prior
    return jax.tree.map(lambda *xs: jnp.stack(xs), *targets)


def log_posterior_fleet(params, fleet: PackedTarget):
    """[ntgt, nw, ndim] -> [ntgt, nw] log posteriors."""
    return jax.vmap(log_posterior_batch)(params, fleet)


def optimizer_chi2_fleet(params, fleet: PackedTarget):
    return jax.vmap(lambda p, t: optimizer_chi2_batch(p, t))(params, fleet)


def init_fleet_ensemble(coords, fleet: PackedTarget, key):
    """coords [ntgt, nw, ndim] -> EnsembleState with leading target axis."""
    logp = log_posterior_fleet(coords, fleet)
    return EnsembleState(coords, logp, key, jnp.zeros((), jnp.int32))


def _fleet_half_update(carry, half, fleet, a):
    coords, logp, key, n_acc = carry
    ntgt, nw, ndim = coords.shape
    nh = nw // 2
    sl = slice(0, nh) if half == 0 else slice(nh, nw)
    co = slice(nh, nw) if half == 0 else slice(0, nh)
    m = nh if half == 0 else nw - nh
    n_comp = nw - m

    key, kz, kp, ka = jax.random.split(key, 4)
    z = _stretch_z(kz, (ntgt, m), a)
    partner_idx = jax.random.randint(kp, (ntgt, m), 0, n_comp)
    partners = jnp.take_along_axis(coords[:, co], partner_idx[..., None], axis=1)

    cur = coords[:, sl]
    proposal = partners + z[..., None] * (cur - partners)
    logp_new = log_posterior_fleet(proposal, fleet)
    log_ratio = (ndim - 1) * jnp.log(z) + logp_new - logp[:, sl]
    accept = jnp.log(jax.random.uniform(ka, (ntgt, m))) < log_ratio

    coords = coords.at[:, sl].set(jnp.where(accept[..., None], proposal, cur))
    logp = logp.at[:, sl].set(jnp.where(accept, logp_new, logp[:, sl]))
    return coords, logp, key, n_acc + jnp.sum(accept).astype(n_acc.dtype)


import functools


@functools.partial(jax.jit, static_argnames=("n_steps", "thin", "a"))
def run_fleet_ensemble(state: EnsembleState, fleet: PackedTarget, n_steps: int,
                       thin: int = 1, a: float = 2.0):
    """Stretch-move all fleet ensembles in one lax.scan.

    Returns (state, chain [n_keep, ntgt, nw, ndim], logps [n_keep, ntgt, nw]).
    """
    n_keep = max(n_steps // thin, 1)

    def one_step(carry, _):
        coords, logp, key, n_acc = carry
        key, sub = jax.random.split(key)
        carry2 = (coords, logp, sub, n_acc)
        carry2 = _fleet_half_update(carry2, 0, fleet, a)
        carry2 = _fleet_half_update(carry2, 1, fleet, a)
        coords, logp, sub, n_acc = carry2
        return (coords, logp, key, n_acc), None

    def outer(carry, _):
        carry, _ = jax.lax.scan(one_step, carry, None, length=thin)
        return carry, (carry[0], carry[1])

    carry = (state.coords, state.log_prob, state.key, state.n_accept)
    carry, (chain, logps) = jax.lax.scan(outer, carry, None, length=n_keep)
    return EnsembleState(*carry), chain, logps
