"""Annealer attempt-budget divergence measurement.

The reference's out-of-bounds branch burns ``total_n`` once per reflection
increment — +100 K per temperature step, +0.1 mag Av, +0.01 R, 1%
multiplicative parallax steps (mft6.py:1070-1103) — potentially dozens per
OOB proposal, while the rebuild burns exactly 1 (anneal.py:171, reflection
is rejection either way: the reference regenerates ``var_par`` from ``gi``
next iteration, discarding the reflected values).  The accountings differ
ONLY in how fast the runaway cap ``total_n < 50*steps`` (mft6.py:966) is
approached, so the divergence is material only if the cap ever binds.

This script replays the koi2298-shaped schedule (150 walkers, steps=400,
the coarse/fine sigmas and OOB bounds of mft6.py:952-982) host-side with
BOTH accountings on the same proposal stream and reports:

  * OOB rate and the reference's mean/max budget burn per OOB event,
  * per-walker total budget burned under each accounting,
  * whether the 50*steps cap binds under either, and the number of real
    (in-bounds, chi-evaluated) proposals each accounting admits.

Run: python scripts/anneal_budget_divergence.py  (CPU, ~1 min)
"""
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
os.environ["JAX_PLATFORMS"] = "cpu"

import jax

jax.config.update("jax_platforms", "cpu")

import jax.numpy as jnp
import numpy as np

from mcmc_spec_tpu.bench_target import build_bench_target, init_walker_batch  # noqa: E402
from mcmc_spec_tpu.inference.anneal import init_walkers  # noqa: E402
from mcmc_spec_tpu.inference.batched import optimizer_chi2_batch  # noqa: E402

NWALK, STEPS = 150, 400  # param_koi2298.txt nwalk/nstep
CAP = 50 * STEPS


def reference_oob_burn(t, av, r1, rr, plx, tmin, tmax):
    """total_n burned by the reference's reflection loops for one OOB
    proposal (mft6.py:1070-1103), including the initial +1."""
    burn = 1
    t = list(t)
    # temperatures low / high
    for i in range(len(t)):
        while t[i] < tmin:
            t[i] += 100.0
            burn += 1
    for i in range(len(t)):
        while t[i] > tmax:
            t[i] -= 100.0
            burn += 1
    while t[0] < t[1]:
        t[1] -= 100.0
        burn += 1
    while av < 0:
        av += 0.1
        burn += 1
    for r in (r1, rr):
        while r < 0.05:
            r += 0.01
            burn += 1
    while plx > 1.0 / 100.0:
        plx -= 0.01 * abs(plx)
        burn += 1
    while plx < 1.0 / 3000.0:
        plx += 0.01 * abs(plx)
        burn += 1
    return burn


def main():
    tgt, truth = build_bench_target(jnp.float32, nd=256, grid_step=8.0)
    tmin, tmax = float(tgt.tmin), float(tgt.tmax)
    key = jax.random.PRNGKey(0)
    p0 = np.asarray(init_walkers(tgt, NWALK, truth[-1], 0.05e-3, key),
                    np.float64)

    chi_fn = jax.jit(lambda p, rs: optimizer_chi2_batch(p, tgt, rad_sigma=rs))

    rng = np.random.RandomState(1)
    params = p0.copy()
    chi = np.asarray(chi_fn(jnp.asarray(params, jnp.float32), None), np.float64)
    n = np.zeros(NWALK, int)
    tot_ours = np.zeros(NWALK, int)
    tot_ref = np.zeros(NWALK, int)
    real_ours = np.zeros(NWALK, int)
    real_ref = np.zeros(NWALK, int)
    oob_events, oob_burns = 0, []

    sig_c = np.concatenate([np.full((NWALK, 2), 250.0), np.full((NWALK, 1), 0.05),
                            0.1 * p0[:, 3:5], 0.02 * p0[:, 5:6]], axis=1)
    sig_f = np.concatenate([np.full((NWALK, 2), 20.0), np.full((NWALK, 1), 0.01),
                            0.05 * p0[:, 3:5], 0.005 * p0[:, 5:6]], axis=1)

    it = 0
    while True:
        active_ours = (n < STEPS) & (tot_ours < CAP)
        active_ref = (n < STEPS) & (tot_ref < CAP)
        active = active_ours | active_ref
        if not active.any() or it > CAP:
            break
        it += 1
        fine = n > STEPS // 2
        sig = np.where(fine[:, None], sig_f, sig_c)
        prop = params + rng.normal(size=params.shape) * sig
        ok = ((prop[:, 0] > tmin) & (prop[:, 0] < tmax)
              & (prop[:, 1] > tmin) & (prop[:, 1] < tmax)
              & (prop[:, 2] >= 0)
              & (prop[:, 3] >= 0.05) & (prop[:, 3] <= 1.5)
              & (prop[:, 4] > 0.05) & (prop[:, 4] < 1.0)
              & (prop[:, 5] > 1.0 / 3000.0) & (prop[:, 5] < 0.1))
        cn = np.asarray(chi_fn(jnp.asarray(prop, jnp.float32),
                               jnp.asarray(sig[:, 3:5], jnp.float32)),
                        np.float64)
        better = ok & (cn < chi) & active
        params = np.where(better[:, None], prop, params)
        chi = np.where(better, cn, chi)
        n = np.where(active & ok, n + 1, n)
        n = np.where(better, np.where(fine, STEPS // 2 + 1, 0), n)
        # budget accounting
        tot_ours = np.where(active_ours, tot_ours + 1, tot_ours)
        real_ours = np.where(active_ours & ok, real_ours + 1, real_ours)
        real_ref = np.where(active_ref & ok, real_ref + 1, real_ref)
        for w in np.where(active_ref)[0]:
            if ok[w]:
                tot_ref[w] += 1
            else:
                burn = reference_oob_burn(prop[w, :2], prop[w, 2], prop[w, 3],
                                          prop[w, 4], prop[w, 5], tmin, tmax)
                tot_ref[w] += burn
                oob_events += 1
                oob_burns.append(burn)

    oob_burns = np.asarray(oob_burns) if oob_burns else np.zeros(1)
    print(f"schedule: nwalk={NWALK} steps={STEPS} cap={CAP}")
    print(f"OOB events: {oob_events} "
          f"({oob_events / max(tot_ours.sum(), 1):.4%} of attempts)")
    print(f"reference burn per OOB event: mean {oob_burns.mean():.2f}, "
          f"max {int(oob_burns.max())}")
    print(f"total budget burned  ours: mean {tot_ours.mean():.0f}  "
          f"max {tot_ours.max()}   reference: mean {tot_ref.mean():.0f}  "
          f"max {tot_ref.max()}")
    print(f"walkers hitting the 50*steps cap  ours: "
          f"{int((tot_ours >= CAP).sum())}   reference: "
          f"{int((tot_ref >= CAP).sum())}")
    print(f"real (chi-evaluated) proposals admitted  ours: mean "
          f"{real_ours.mean():.0f}   reference: mean {real_ref.mean():.0f}  "
          f"(diff {real_ours.mean() - real_ref.mean():+.1f}, "
          f"{(real_ours.mean() - real_ref.mean()) / max(real_ref.mean(), 1):.3%})")


if __name__ == "__main__":
    main()
