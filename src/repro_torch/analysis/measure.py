"""Measurement along a trajectory (counterpart of ``repro.analysis.measure``).

A :class:`MeasurementPlan` says how many samples to take, how many
sweeps apart, after how many thermalizing sweeps.  The JAX package runs
the plan as one compiled ``lax.scan``: one dispatch a trajectory.  Here
:func:`measure_scan_batched` runs an ensemble's plan on the card as:

1. the sweeps, launched from the host as the loop launches them, each
   block ending in the caller's planes (a k-sweep block's new planes
   are copied back into them);
2. the first sample's observables, computed as the loop computes them
   (which also warms them up);
3. a CUDA graph of one sample's observables (every member's, about 50
   small launches, written into row ``i`` of preallocated
   ``(n_measure, B[, 32])`` device buffers, ``i`` a device counter the
   graph advances), captured once on the caller's planes and replayed
   after each later sample's sweeps, each replay counted in
   :data:`DISPATCHES`;
4. the samples to the host once, after the last replay; the graph and
   its memory pool freed.

Only the observables are captured: a sweep launch carries its
half-sweep offset as a by-value parameter, different in every sample,
so a captured sweep could not be replayed (and a graph of a whole
trajectory costs its capture, the loop's own Python, on top of the
loop's time).  The graph gives the samples and the final planes of the
loop bit for bit: the same launches run in the same order, and every sum
is an integer.  A capture that fails raises; it never falls back to the
loop.  On the CPU (only where the caller asked for it) the plan runs as
that loop, the plain version.  :func:`measure_scan` of a counter-based
engine is the batch of one; the engines that are not counter-based
(``tensorcore``, ``basic``, ``spinglass``, ``wolff``) keep a loop on
either device.  The times of the last graph are in
:data:`GRAPH_STATS`.
"""
from __future__ import annotations

import dataclasses
import inspect
import time
from typing import Tuple

import numpy as np
import torch

#: CUDA graph replays since the count was last set to 0: one per sample
#: after the first of a measured trajectory on the card (the JAX
#: package's ``DISPATCH_COUNT`` counts one a trajectory)
DISPATCHES = 0

#: the last graph: seconds of its capture and its instantiation, and
#: its replays
GRAPH_STATS: dict = {}


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


def _check_fields(engine, plan: MeasurementPlan) -> None:
    missing = set(plan.fields) - set(engine.observable_fields)
    if missing:
        raise ValueError(f"plan fields {sorted(missing)} not in engine "
                         f"{engine.name!r} observables "
                         f"{sorted(engine.observable_fields)}")


def measure_scan(engine, state, plan: MeasurementPlan, step_count: int = 0,
                 *, loop: bool = False):
    """Run ``plan`` from ``state`` at cumulative sweep ``step_count``.

    Returns ``(final_state, {field: (n_measure,) float32 ndarray},
    new_step_count)``; an engine whose observables are per-replica
    vectors (bitplane) gives ``(n_measure, 32)`` trajectories, as in the
    JAX package.  A counter-based engine runs :func:`measure_scan_batched`
    of one member (``loop`` as there).
    """
    _check_fields(engine, plan)
    inv_temp, seed = engine.cfg.inv_temp, engine.cfg.seed
    if engine.counter_based:
        states, traj, step = measure_scan_batched(
            engine, tuple(p[None] for p in state), [inv_temp], [seed], plan,
            step_count, loop=loop)
        return (engine.member(states, 0), {k: v[:, 0] for k, v in
                                            traj.items()}, step)
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
                         plan: MeasurementPlan, step_count: int = 0, *,
                         loop: bool = False):
    """:func:`measure_scan` of every member of an ensemble at once (its
    inverse temperature and seed; one launch of the member axis a block
    of sweeps), on the card with the observables one captured graph;
    ``loop=True`` asks for the loop of launches on the card too (what
    the graph is compared with).

    Returns ``(final_states, {field: (n_measure, B) float32 ndarray},
    new_step_count)``, ``(n_measure, B, 32)`` for the per-replica
    observables of the bitplane engines, as in the JAX package.  The
    final states are ``states`` themselves, advanced, wherever the card
    ran the graph.
    """
    if not engine.counter_based:
        raise ValueError(
            f"engine {engine.name!r} is not counter-based; batched "
            "measurement needs a traceable-seed sweep (DESIGN.md S3/S4)")
    _check_fields(engine, plan)
    device = states[0].device
    shape = (plan.n_measure, states[0].shape[0]) + (
        (engine.replicas,) if engine.replicas > 1 else ())
    out = {k: torch.empty(shape, dtype=torch.float32, device=device)
           for k in plan.fields}
    args = (engine, inv_temps, seeds, plan, step_count, out)
    if device.type == "cuda" and not loop:
        states = _graph_trajectory(states, *args)
    else:
        states = _trajectory(states, *args)
    traj = {k: v.cpu().numpy() for k, v in out.items()}
    return states, traj, step_count + plan.total_sweeps


def _trajectory(states, engine, inv_temps, seeds, plan, step, out):
    """Thermalize, then ``n_measure`` x (sweeps; every member's
    observables into row i of ``out``); returns the final states."""
    if plan.thermalize:
        states = engine.scan_step_batched(states, inv_temps, seeds, step,
                                          plan.thermalize)
        step += plan.thermalize
    for i in range(plan.n_measure):
        states = engine.scan_step_batched(states, inv_temps, seeds, step,
                                          plan.sweeps_between)
        step += plan.sweeps_between
        _observe(engine, states, inv_temps, plan, out, i)
    return states


def _observe(engine, states, inv_temps, plan, out, row) -> None:
    """Every member's observables into row ``row`` (an int, or a device
    index tensor of one entry) of ``out``."""
    o = engine.observables_batched(states, inv_temps)
    for k in plan.fields:
        if isinstance(row, int):
            out[k][row].copy_(o[k])
        else:
            out[k].index_copy_(0, row, o[k][None])


def _new_graph():
    """A ``CUDAGraph`` kept after its capture and instantiated apart, so
    that the two are timed apart, where this PyTorch can
    (``keep_graph``; the package asks for torch 2.4 or later, where an
    older one instantiates in ``capture_end``); and whether it is."""
    if "keep_graph" in inspect.signature(torch.cuda.CUDAGraph.__new__) \
            .parameters:
        return torch.cuda.CUDAGraph(keep_graph=True), True
    return torch.cuda.CUDAGraph(), False


def _graph_trajectory(states, engine, inv_temps, seeds, plan, step, out):
    """:func:`_trajectory` with the observables of every sample after the
    first one replay of a graph captured on ``states``, which end each
    block of sweeps and which it returns, advanced."""
    global DISPATCHES
    GRAPH_STATS.clear()

    def sweep(n_sweeps, step):
        new = engine.scan_step_batched(states, inv_temps, seeds, step,
                                       n_sweeps)
        for dst, src in zip(states, new):
            if src.data_ptr() != dst.data_ptr():
                dst.copy_(src)
        return step + n_sweeps

    if plan.thermalize:
        step = sweep(plan.thermalize, step)
    step = sweep(plan.sweeps_between, step)
    _observe(engine, states, inv_temps, plan, out, 0)
    if plan.n_measure == 1:
        return states
    device = states[0].device
    stream = torch.cuda.current_stream(device)
    row = torch.ones(1, dtype=torch.int64, device=device)
    t0 = time.perf_counter()
    graph, separate = _new_graph()
    # captured on a side stream, as ``torch.cuda.graph`` does, but without
    # its emptying of the allocator's cache, which would make the next
    # run's allocations pay for new device memory
    capture = torch.cuda.Stream(device)
    capture.wait_stream(stream)
    with torch.cuda.stream(capture):
        graph.capture_begin()
        try:
            _observe(engine, states, inv_temps, plan, out, row)
            row.add_(1)
        finally:
            graph.capture_end()     # raises where the capture failed
    stream.wait_stream(capture)
    t1 = time.perf_counter()
    if separate:
        graph.instantiate()
    t2 = time.perf_counter()
    for _ in range(1, plan.n_measure):
        step = sweep(plan.sweeps_between, step)
        graph.replay()
        DISPATCHES += 1
    stream.synchronize()        # the pool's blocks are free once it is done
    graph.reset()
    del graph
    GRAPH_STATS.update(capture_s=t1 - t0,
                       instantiate_s=t2 - t1 if separate else None,
                       replays=plan.n_measure - 1)
    return states
