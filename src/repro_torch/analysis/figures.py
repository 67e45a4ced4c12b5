"""The paper's validation figures (Fig. 5/6) with error bars, on the card.

Counterpart of the JAX package's ``examples/figures.py``, with the same
13 temperatures, seeds (``101 + 1000 k + i`` for size k and temperature
i), sweep plans and recorder rows.  Fig. 5: |m|(T) against Onsager's
exact curve, with jackknife error bars, susceptibility chi, specific
heat C_v and tau_int a temperature.  Fig. 6: the Binder cumulant U_L(T)
of each lattice size and the U_L-crossing estimate of T_c (exact:
2/ln(1+sqrt(2)) = 2.269185).

Each lattice size runs its whole temperature scan as one ensemble-mode
``RunSpec``, whose samples' observables on the card are replays of one
captured CUDA graph (``repro_torch.analysis.measure``).  The rows go through
``RunRecorder`` into the EXPERIMENTS.md CSV, with each size's spec in
the metadata.

Run:    python -m repro_torch.analysis.figures [--smoke] [--out DIR]
            [--engine NAME] [--sizes L ...] [--device cpu]
Smoke:  small lattices, short runs; asserts that the Binder-crossing T_c
        lies within 2% of the exact value.  Runs on the CUDA card unless
        ``--device cpu`` is given.
"""
from __future__ import annotations

import argparse
import os
import time

import numpy as np

from repro_torch.analysis import (RunRecorder, binder, binder_crossing,
                                  jackknife, specific_heat, susceptibility,
                                  tau_int)
from repro_torch.api import (BatchSpec, EngineSpec, LatticeSpec, RunSpec,
                             Session, SweepSpec)
from repro_torch.core import observables as obs

TEMPS = [1.5, 1.8, 2.0, 2.1, 2.15, 2.2, 2.25, 2.3, 2.35, 2.4, 2.5, 2.7,
         3.0]

#: the sweep plans of ``--smoke`` and of the default run
SMOKE_SWEEP = SweepSpec(thermalize=400, measure_every=2, n_measure=400)
FULL_SWEEP = SweepSpec(thermalize=1500, measure_every=4, n_measure=2000)
SMOKE_SIZES = (16, 32)
FULL_SIZES = (32, 64)

#: the largest relative error of the Binder-crossing T_c ``--smoke``
#: accepts
TC_TOLERANCE = 0.02


def size_spec(L, temps, sweep, engine, seed0) -> RunSpec:
    """The ensemble-mode spec of one lattice size's temperature scan."""
    return RunSpec(
        lattice=LatticeSpec(n=L, m=L, init_p_up=1.0),
        engine=EngineSpec(engine),
        batch=BatchSpec(temperatures=tuple(temps),
                        seeds=tuple(seed0 + i
                                    for i in range(len(temps)))),
        sweep=sweep)


def figure_specs(sizes, sweep, engine) -> dict:
    """``{L: spec}`` of every size, size k's seeds from 101 + 1000 k."""
    return {L: size_spec(L, TEMPS, sweep, engine, seed0=101 + 1000 * k)
            for k, L in enumerate(sizes)}


def scan_size(spec, recorder, device=None):
    """One lattice size: batched Session, one measured trajectory, rows.
    Returns the Binder cumulants by temperature, the seconds of
    ``measure()`` and its samples."""
    L = spec.lattice.n
    temps = spec.batch.temperatures
    session = Session.open(spec, device=device)
    t0 = time.perf_counter()
    traj = session.measure()                 # {"m","e"}: (n_measure, B)
    seconds = time.perf_counter() - t0
    us = seconds * 1e6 / len(temps)
    n_spins = L * L
    binders = []
    for i, T in enumerate(temps):
        m, e = traj["m"][:, i], traj["e"][:, i]
        m_abs, m_err = jackknife(np.abs(m))
        u, u_err = jackknife(m, stat=binder)
        binders.append(u)
        recorder.record(
            f"fig5_L{L}_T{T:.3f}", us,
            m=m_abs, m_err=m_err,
            onsager=float(obs.onsager_magnetization(T)),
            chi=susceptibility(m, T, n_spins),
            cv=specific_heat(e, T, n_spins),
            tau_int=tau_int(m))
        recorder.record(f"fig6_L{L}_T{T:.3f}", us, binder=u,
                        binder_err=u_err)
    return np.asarray(binders), seconds, traj


def main(argv=None) -> dict:
    """Run the figure; returns ``{"tc", "rel_err", "measure_s": {L: s},
    "traj": {L: samples}, "csv"}``.  ``--smoke`` raises
    ``AssertionError`` unless T_c lies within :data:`TC_TOLERANCE` of the
    exact value."""
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.analysis.figures",
        description="The paper's Fig. 5/6 temperature scan and its "
                    "Binder-crossing T_c")
    ap.add_argument("--smoke", action="store_true",
                    help="small/fast run; assert T_c within 2%% of exact")
    ap.add_argument("--out", default="results", help="output directory")
    ap.add_argument("--engine", default="multispin")
    ap.add_argument("--sizes", type=int, nargs="*", default=None)
    ap.add_argument("--device", default="",
                    help="torch device, e.g. cpu (default: the CUDA card)")
    args = ap.parse_args(argv)

    sizes = args.sizes or (SMOKE_SIZES if args.smoke else FULL_SIZES)
    sweep = SMOKE_SWEEP if args.smoke else FULL_SWEEP
    specs = figure_specs(sizes, sweep, args.engine)
    # the recorder metadata holds the serialized specs: the whole figure
    # reproduces from this record alone
    rec = RunRecorder(echo=True, meta={
        "figure": "fig5+fig6",
        "specs": {str(L): s.to_dict() for L, s in specs.items()}})

    u_by_size, measure_s, traj = {}, {}, {}
    for L in sizes:
        u_by_size[L], measure_s[L], traj[L] = scan_size(
            specs[L], rec, args.device or None)

    tc = binder_crossing(TEMPS, u_by_size[min(sizes)],
                         u_by_size[max(sizes)])
    rel = (abs(tc - obs.T_CRITICAL) / obs.T_CRITICAL
           if tc is not None else float("nan"))
    rec.record("fig6_tc_estimate", 0.0,
               tc=float("nan") if tc is None else tc,
               exact=obs.T_CRITICAL, rel_err=rel)

    os.makedirs(args.out, exist_ok=True)
    csv = rec.write_csv(os.path.join(args.out, "fig5_fig6.csv"))
    print(f"# wrote {csv}")
    print(f"# T_c estimate {tc} (exact {obs.T_CRITICAL}, "
          f"rel err {rel:.4f})")
    if args.smoke:
        assert tc is not None and rel < TC_TOLERANCE, (
            f"Binder-crossing T_c {tc} deviates {rel:.1%} from "
            f"{obs.T_CRITICAL} (>2%)")
        print("# smoke OK: T_c within 2% of exact")
    return {"tc": tc, "rel_err": rel, "measure_s": measure_s, "traj": traj,
            "csv": csv}


if __name__ == "__main__":
    main()
