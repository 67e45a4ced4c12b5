"""Reproduce the paper's validation figures (Fig. 5 magnetization curve,
Fig. 6 Binder cumulant) on small lattices -- batched, from one spec
(counterpart of the JAX package's ``examples/phase_transition.py``).

The whole temperature scan per lattice size is ONE ensemble-mode
``RunSpec``: every (temperature, seed) member advances in the same
launches (the member axis of the kernels), with one ``measure()`` a size.

Run:  python -m repro_torch.examples.phase_transition [--device cpu]
"""
from __future__ import annotations

import argparse

import numpy as np

from repro_torch.analysis import binder
from repro_torch.api import (BatchSpec, EngineSpec, LatticeSpec, RunSpec,
                             Session, SweepSpec)
from repro_torch.core import observables as obs

TEMPS = [1.5, 1.8, 2.0, 2.1, 2.2, 2.27, 2.35, 2.5, 3.0]
SIZES = [32, 48]
SWEEP = SweepSpec(thermalize=400, measure_every=5, n_measure=40,
                  fields=("m",))


def size_spec(L: int) -> RunSpec:
    """One lattice size's scan: ordered start below Tc, which avoids the
    striped metastable states the paper reports in S5.3 for cold random
    starts."""
    return RunSpec(
        lattice=LatticeSpec(n=L, m=L, init_p_up=1.0),
        engine=EngineSpec("multispin"),
        batch=BatchSpec(temperatures=tuple(TEMPS),
                        seeds=tuple(11 + i for i in range(len(TEMPS)))),
        sweep=SWEEP)


def main(argv=None) -> dict:
    """Run the scan and print its table; returns ``{L: (|m| by T, U_L by
    T)}``."""
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.examples.phase_transition",
        description="|m| and the Binder cumulant against T, one ensemble "
                    "a lattice size")
    ap.add_argument("--device", default="",
                    help="torch device, e.g. cpu (default: the CUDA card)")
    args = ap.parse_args(argv)

    results = {}
    for L in SIZES:
        session = Session.open(size_spec(L), args.device or None)
        samples = session.measure()["m"]         # (n_measure, len(TEMPS))
        m = np.abs(samples).mean(axis=0)
        u = [binder(samples[:, i]) for i in range(len(TEMPS))]
        results[L] = (m, u)

    print("T      " + "".join(f"  L={L}:m,U_L   " for L in SIZES)
          + " onsager")
    for t_idx, T in enumerate(TEMPS):
        row = f"{T:5.2f} "
        for L in SIZES:
            m, u = results[L]
            row += f"  {m[t_idx]:.3f},{u[t_idx]:+.3f} "
        row += f"   {obs.onsager_magnetization(T):.4f}"
        print(row)
    print(f"Tc = {obs.T_CRITICAL}")
    return results


if __name__ == "__main__":
    main()
