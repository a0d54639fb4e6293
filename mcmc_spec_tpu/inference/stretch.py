"""Affine-invariant ensemble MCMC (Goodman & Weare stretch move), on device.

Replaces the reference's (commented-out) ``emcee.EnsembleSampler`` driver
(``mft6.py:1472-1529``).  The ensemble is updated red-black: the first half
proposes against the current second half, then the second half proposes
against the *updated* first half — the exact scheme emcee uses, which keeps
detailed balance when every walker in a half moves simultaneously.

All walkers evaluate the fused log-posterior under ``vmap``; whole chains run
inside a single ``lax.scan`` with zero host round-trips, emitting a thinned
chain.  Cross-chip scaling shards the walker axis over a mesh (see
``mcmc_spec_tpu/parallel``).
"""
from __future__ import annotations

import functools
from typing import Callable, NamedTuple

import jax
import jax.numpy as jnp


class EnsembleState(NamedTuple):
    coords: jnp.ndarray  # [nw, ndim]
    log_prob: jnp.ndarray  # [nw]
    key: jax.Array
    n_accept: jnp.ndarray  # [] total accepted moves


def _stretch_z(key, shape, a):
    """Draw from g(z) ~ 1/sqrt(z) on [1/a, a]: z = ((a-1)u + 1)^2 / a."""
    u = jax.random.uniform(key, shape)
    return ((a - 1.0) * u + 1.0) ** 2 / a


def _half_update(carry, half, log_prob_fn, a):
    """Propose and accept for one half of the ensemble against the other."""
    coords, logp, key, n_acc = carry
    nw, ndim = coords.shape
    nh = nw // 2
    sl = slice(0, nh) if half == 0 else slice(nh, nw)
    co = slice(nh, nw) if half == 0 else slice(0, nh)
    m = nh if half == 0 else nw - nh  # sizes differ when nw is odd
    n_comp = nw - m

    key, kz, kp, ka = jax.random.split(key, 4)
    z = _stretch_z(kz, (m,), a)
    partner_idx = jax.random.randint(kp, (m,), 0, n_comp)
    partners = coords[co][partner_idx]  # [m, ndim]

    cur = coords[sl]
    proposal = partners + z[:, None] * (cur - partners)
    logp_new = log_prob_fn(proposal)

    log_ratio = (ndim - 1) * jnp.log(z) + logp_new - logp[sl]
    accept = jnp.log(jax.random.uniform(ka, (m,))) < log_ratio

    new_half = jnp.where(accept[:, None], proposal, cur)
    new_logp_half = jnp.where(accept, logp_new, logp[sl])
    coords = coords.at[sl].set(new_half)
    logp = logp.at[sl].set(new_logp_half)
    return coords, logp, key, n_acc + jnp.sum(accept).astype(n_acc.dtype)


def stretch_step(state: EnsembleState, log_prob_fn: Callable, a: float = 2.0) -> EnsembleState:
    """One full ensemble update (both halves)."""
    carry = (state.coords, state.log_prob, state.key, state.n_accept)
    carry = _half_update(carry, 0, log_prob_fn, a)
    carry = _half_update(carry, 1, log_prob_fn, a)
    return EnsembleState(*carry)


def init_ensemble(coords, log_prob_fn, key) -> EnsembleState:
    """Initialise the ensemble; ``log_prob_fn`` maps [n, ndim] -> [n]."""
    coords = jnp.asarray(coords)
    logp = log_prob_fn(coords)
    return EnsembleState(coords, logp, key, jnp.zeros((), jnp.int32))


@functools.partial(jax.jit, static_argnames=("log_prob_fn", "n_steps", "thin", "a"))
def run_ensemble(
    state: EnsembleState,
    log_prob_fn: Callable,
    n_steps: int,
    thin: int = 1,
    a: float = 2.0,
):
    """Run ``n_steps`` stretch moves inside one ``lax.scan``.

    Returns ``(final_state, chain [n_steps//thin, nw, ndim], logps)``.
    With ``thin > 1`` only every ``thin``-th state is emitted (the reference
    dumps coords every ``nthin`` steps, mft6.py:1494-1510).

    The scan carries the two ensemble halves as separate arrays (no
    dynamic-update-slice scatters in the loop body — a device trace showed
    those costing ~5% of step time) and the stretch/partner/accept random
    draws for each emitted chunk of ``thin`` steps are generated in three
    batched ops, instead of 6 small threefry dispatches per step.  The key
    advances once per emitted chunk, so at a fixed ``thin`` a run is
    bit-invariant to how it is split across successive ``run_ensemble``
    calls — ``run(40, thin=1)`` equals ``run(20) + run(20)`` — which
    checkpoint/resume relies on (tests/test_resume.py).
    """
    nw, ndim = state.coords.shape
    if nw % 2:  # odd ensembles: generic per-step path
        return _run_ensemble_generic(state, log_prob_fn, n_steps, thin, a)

    n_keep = n_steps // thin
    nh = nw // 2

    c0, c1 = state.coords[:nh], state.coords[nh:]
    lp0, lp1 = state.log_prob[:nh], state.log_prob[nh:]

    def half(cur, lp_cur, other, z_h, idx_h, log_u_h, n_acc):
        partners = other[idx_h]
        proposal = partners + z_h[:, None] * (cur - partners)
        logp_new = log_prob_fn(proposal)
        log_ratio = (ndim - 1) * jnp.log(z_h) + logp_new - lp_cur
        accept = log_u_h < log_ratio
        cur = jnp.where(accept[:, None], proposal, cur)
        lp_cur = jnp.where(accept, logp_new, lp_cur)
        return cur, lp_cur, n_acc + jnp.sum(accept).astype(n_acc.dtype)

    def outer(carry, _):
        c0, c1, lp0, lp1, key, n_acc = carry
        key, kz, kp, ka = jax.random.split(key, 4)
        # draws in the ensemble dtype: under x64 the default f64 draws would
        # otherwise promote the carried halves out of their dtype
        z = _stretch_z(kz, (thin, 2, nh), a).astype(c0.dtype)
        partner_idx = jax.random.randint(kp, (thin, 2, nh), 0, nh)
        log_u = jnp.log(jax.random.uniform(ka, (thin, 2, nh))).astype(lp0.dtype)

        def inner(c, x):
            c0, c1, lp0, lp1, n_acc = c
            z_s, idx_s, lu_s = x
            c0, lp0, n_acc = half(c0, lp0, c1, z_s[0], idx_s[0], lu_s[0], n_acc)
            c1, lp1, n_acc = half(c1, lp1, c0, z_s[1], idx_s[1], lu_s[1], n_acc)
            return (c0, c1, lp0, lp1, n_acc), None

        (c0, c1, lp0, lp1, n_acc), _ = jax.lax.scan(
            inner, (c0, c1, lp0, lp1, n_acc), (z, partner_idx, log_u)
        )
        carry = (c0, c1, lp0, lp1, key, n_acc)
        return carry, (jnp.concatenate([c0, c1]), jnp.concatenate([lp0, lp1]))

    carry = (c0, c1, lp0, lp1, state.key, state.n_accept)
    carry, (chain, logps) = jax.lax.scan(outer, carry, None, length=n_keep)
    c0, c1, lp0, lp1, key, n_acc = carry
    state = EnsembleState(
        jnp.concatenate([c0, c1]), jnp.concatenate([lp0, lp1]), key, n_acc
    )
    return state, chain, logps


def _run_ensemble_generic(state, log_prob_fn, n_steps, thin, a):
    """Per-step fallback (odd walker counts): one stretch_step per iteration."""
    n_keep = n_steps // thin

    def outer(state, _):
        def inner(s, _):
            return stretch_step(s, log_prob_fn, a), None

        state, _ = jax.lax.scan(inner, state, None, length=thin)
        return state, (state.coords, state.log_prob)

    state, (chain, logps) = jax.lax.scan(outer, state, None, length=n_keep)
    return state, chain, logps


def acceptance_fraction(state: EnsembleState, n_steps: int) -> jnp.ndarray:
    nw = state.coords.shape[0]
    return state.n_accept / (nw * jnp.maximum(n_steps, 1))
