"""32 replicas from ONE simulation: the bitplane engine (counterpart of
the JAX package's ``examples/bitplane_replicas.py``).

One ``bitplane`` session advances 32 independent replica lattices packed
1 bit/spin into each uint32 word, drawing ONE shared Philox uint32 per
site.  The measured trajectory is ``(n_measure, 32)``: 32 per-replica
magnetization series from one ``measure()``.

Two shared-randoms facts this example demonstrates (Block, Virnau &
Preis, arXiv:1007.3726):

* **Above/near T_c** the 32 chains stay distinct and the per-time-sample
  replica average genuinely reduces variance -- but the chains are
  *correlated* through the shared stream, so the error bar must come
  from a block jackknife over TIME, never from treating the replicas as
  32 independent measurements.
* **Below T_c** shared-randomness coupling *coalesces* chains: replicas
  falling into the same magnetization well merge into bit-identical
  configurations within a few hundred sweeps (at most the two +-m wells
  survive).  The replica multiplier is void there -- use an ensemble of
  distinct seeds for ordered-phase statistics instead.

The JAX script asserts at most 4 distinct replicas after 400 sweeps at
T = 2.0.  How many remain then depends on the start: over seeds 11-20
at 48^2, 3 of the JAX package's starts and 4 of the port's leave 5-7
(seed 11: JAX 4, the port 7), while after 800 sweeps every one of the
20 leaves at most 3.  So this script prints the count after 400 sweeps
and asserts at most 4 after 800.

Run:  python -m repro_torch.examples.bitplane_replicas [--device cpu]
"""
from __future__ import annotations

import argparse

import numpy as np

from repro_torch.analysis import jackknife, tau_int
from repro_torch.api import (EngineSpec, LatticeSpec, RunSpec, Session,
                             SweepSpec)

L = 48
HOT_T, COLD_T = 2.5, 2.0
#: the JAX script's sweeps below Tc, and the sweeps of this assertion
COLD_SWEEPS, COLD_ASSERT_SWEEPS = 400, 800


def distinct_replicas(session) -> int:
    """How many of the session's 32 replica lattices differ."""
    black, white = (p.cpu().numpy() for p in session.state)
    return len({(((black >> r) & 1).tobytes(), ((white >> r) & 1).tobytes())
                for r in range(session.engine.replicas)})


def bitplane_spec(temp, sweep=None) -> RunSpec:
    return RunSpec(lattice=LatticeSpec(n=L, m=L),
                   engine=EngineSpec("bitplane"),
                   temperature=temp, seed=11, sweep=sweep)


def main(argv=None) -> dict:
    """Run both sides; returns ``{"traj", "distinct_hot", "est", "err",
    "err_single", "distinct_400", "distinct_cold"}``.  Raises
    ``AssertionError`` where the replica average does not beat one chain,
    or where more than 4 replicas survive below T_c."""
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.examples.bitplane_replicas",
        description="32 replicas of one bitplane simulation")
    ap.add_argument("--device", default="",
                    help="torch device, e.g. cpu (default: the CUDA card)")
    args = ap.parse_args(argv)
    device = args.device or None

    # -- disordered side: 32 live chains, replica averaging works ---------
    sim = Session.open(bitplane_spec(HOT_T, SweepSpec(
        thermalize=300, measure_every=2, n_measure=120)), device)
    traj = sim.measure()
    m = np.abs(traj["m"])                       # (120, 32) per-replica
    hot = distinct_replicas(sim)
    print(f"T={HOT_T} (> Tc): trajectory {traj['m'].shape}, "
          f"{hot}/32 distinct replica configs")

    per_rep = np.array([jackknife(m[:, r])[0] for r in range(m.shape[1])])
    print(f"  per-replica <|m|>: min {per_rep.min():.4f} max "
          f"{per_rep.max():.4f} spread {per_rep.std():.4f}")

    series = m.mean(axis=1)                     # replica-average a sample,
    est, err = jackknife(series)                # then error bar over time
    _, err_single = jackknife(m[:, 0])
    print(f"  replica-averaged <|m|> = {est:.4f} +- {err:.4f} "
          f"(single chain +- {err_single:.4f}, tau_int "
          f"{tau_int(series):.2f})")
    if not err < err_single:                    # shared draws still help
        raise AssertionError(f"the replica average's error {err} is not "
                             f"below one chain's {err_single}")

    # -- ordered side: shared randoms coalesce the chains ------------------
    sim = Session.open(bitplane_spec(COLD_T), device)
    sim.run(COLD_SWEEPS)
    early = distinct_replicas(sim)
    sim.run(COLD_ASSERT_SWEEPS - COLD_SWEEPS)
    cold = distinct_replicas(sim)
    print(f"T={COLD_T} (< Tc): {early}/32 distinct replica configs after "
          f"{COLD_SWEEPS} sweeps, {cold}/32 after {COLD_ASSERT_SWEEPS} -- "
          f"coalesced into the +-m wells; use ensemble seeds below Tc")
    if cold > 4:
        raise AssertionError(f"{cold} replicas survive below Tc (at most 4)")
    return {"traj": traj, "distinct_hot": hot, "est": est, "err": err,
            "err_single": err_single, "distinct_400": early,
            "distinct_cold": cold}


if __name__ == "__main__":
    main()
