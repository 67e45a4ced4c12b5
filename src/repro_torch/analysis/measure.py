"""Measurement along a trajectory (counterpart of ``repro.analysis.measure``).

A :class:`MeasurementPlan` says how many samples to take, how many
sweeps apart, after how many thermalizing sweeps.  The JAX package runs
the plan as one compiled ``lax.scan``; here :func:`measure_scan` is a
Python loop over the engine's ``scan_step`` and ``observables``, which
gives the same samples: the Philox stream depends only on the
cumulative sweep count.  Samples stay on the device until the end, so
the loop does not wait for the card between samples.
:func:`measure_scan_batched` does the same for an ensemble's members.
"""
from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class MeasurementPlan:
    """``n_measure`` samples, ``sweeps_between`` sweeps apart, after
    ``thermalize`` sweeps, of the observable ``fields``."""

    n_measure: int
    sweeps_between: int
    thermalize: int = 0
    fields: Tuple[str, ...] = ("m", "e")

    def __post_init__(self):
        if self.n_measure <= 0 or self.sweeps_between <= 0 \
                or self.thermalize < 0:
            raise ValueError(f"bad measurement plan {self}")
        if not self.fields:
            raise ValueError("need at least one observable field")
        object.__setattr__(self, "fields", tuple(self.fields))

    @property
    def total_sweeps(self) -> int:
        return self.thermalize + self.n_measure * self.sweeps_between


def measure_scan(engine, state, plan: MeasurementPlan, step_count: int = 0):
    """Run ``plan`` from ``state`` at cumulative sweep ``step_count``.

    Returns ``(final_state, {field: (n_measure,) float32 ndarray},
    new_step_count)``; an engine whose observables are per-replica
    vectors (bitplane) gives ``(n_measure, 32)`` trajectories, as in the
    JAX package.
    """
    missing = set(plan.fields) - set(engine.observable_fields)
    if missing:
        raise ValueError(f"plan fields {sorted(missing)} not in engine "
                         f"{engine.name!r} observables "
                         f"{sorted(engine.observable_fields)}")
    inv_temp = engine.cfg.inv_temp
    seed = engine.cfg.seed
    step = step_count
    if plan.thermalize:
        state = engine.scan_step(state, inv_temp, seed, step,
                                 plan.thermalize)
        step += plan.thermalize
    samples = {k: [] for k in plan.fields}
    for _ in range(plan.n_measure):
        state = engine.scan_step(state, inv_temp, seed, step,
                                 plan.sweeps_between)
        step += plan.sweeps_between
        o = engine.observables(state, inv_temp)
        for k in plan.fields:
            samples[k].append(o[k])
    traj = {k: torch.stack(v).cpu().numpy().astype(np.float32)
            for k, v in samples.items()}
    return state, traj, step_count + plan.total_sweeps


def measure_scan_batched(engine, states, inv_temps, seeds,
                         plan: MeasurementPlan, step_count: int = 0):
    """:func:`measure_scan` of every member of an ensemble at once (its
    inverse temperature and seed; one launch of the member axis a block
    of sweeps).

    Returns ``(final_states, {field: (n_measure, B) float32 ndarray},
    new_step_count)``, ``(n_measure, B, 32)`` for the per-replica
    observables of the bitplane engines, as in the JAX package.
    """
    if not engine.counter_based:
        raise ValueError(
            f"engine {engine.name!r} is not counter-based; batched "
            "measurement needs a traceable-seed sweep (DESIGN.md S3/S4)")
    missing = set(plan.fields) - set(engine.observable_fields)
    if missing:
        raise ValueError(f"plan fields {sorted(missing)} not in engine "
                         f"{engine.name!r} observables "
                         f"{sorted(engine.observable_fields)}")
    step = step_count
    if plan.thermalize:
        states = engine.scan_step_batched(states, inv_temps, seeds, step,
                                          plan.thermalize)
        step += plan.thermalize
    samples = {k: [] for k in plan.fields}
    for _ in range(plan.n_measure):
        states = engine.scan_step_batched(states, inv_temps, seeds, step,
                                          plan.sweeps_between)
        step += plan.sweeps_between
        o = engine.observables_batched(states, inv_temps)
        for k in plan.fields:
            samples[k].append(o[k])
    traj = {k: torch.stack(v).cpu().numpy().astype(np.float32)
            for k, v in samples.items()}
    return states, traj, step_count + plan.total_sweeps
