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
   after each later sample's sweeps, each replay counted in the
   telemetry counter ``measure.graph_replays`` (read as
   :data:`DISPATCHES`);
4. the samples to the host once, after the last replay; the graph kept
   until the engine's next measurement has captured its own graph, on
   the same side stream, into the same memory pool, and freed then: a
   capture into a new pool allocates new device memory (``cudaMalloc``,
   which can stall the host for tens of ms), a capture into a kept one
   takes the blocks its last capture freed.

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
either device.

A measured trajectory is ONE dispatch in the telemetry counters, as the
JAX package's one compiled scan is, inside a ``measure_scan`` span that
holds its ``dispatch`` span.  Inside that, the phases are spans of their
own: ``measure.sweeps`` (a block of sweeps, with its copy-back),
``measure.observe`` (a sample's observables by the loop),
``measure.graph_capture``, ``measure.graph_instantiate``,
``measure.graph_replay`` (each replay) and ``measure.graph_reset`` (the
engine's previous graph freed, this one kept); around it,
``measure.alloc`` (the sample buffers) and ``measure.to_host`` (their
copy to the host).  Spans are host intervals: none waits for the card,
and none opens inside the capture.
"""
from __future__ import annotations

import contextlib
import dataclasses
import inspect
import weakref
from typing import Tuple

import numpy as np
import torch

import repro_torch.telemetry as tel

#: CUDA graph replays: one per sample after the first of a measured
#: trajectory on the card (module-held: survives ``REGISTRY.reset()``)
GRAPH_REPLAYS = tel.REGISTRY.counter("measure.graph_replays")
#: each engine's last measurement graph and the side stream it was
#: captured on, kept for the engine's next capture (the pool's blocks are
#: the stream's) and freed with the engine
_KEPT = weakref.WeakKeyDictionary()


def __getattr__(name: str):
    # ``DISPATCHES``: the replays so far, read from the registry (the
    # JAX package reads its ``DISPATCH_COUNT`` from its counter likewise)
    if name == "DISPATCHES":
        return GRAPH_REPLAYS.value
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


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


@contextlib.contextmanager
def _traced(engine, plan: MeasurementPlan, batch: int):
    """The ``measure_scan`` span around a whole trajectory, its one
    ``dispatch`` span inside, and the trajectory's one dispatch in the
    counters once it has run."""
    with tel.span("measure_scan", engine=engine.name,
                  lattice=(engine.cfg.n, engine.cfg.m),
                  n_measure=plan.n_measure,
                  sweeps_between=plan.sweeps_between,
                  thermalize=plan.thermalize, batch=batch,
                  replicas=engine.replicas):
        with tel.span("dispatch", engine=engine.name, k=plan.total_sweeps,
                      batch=batch):
            yield
        tel.record_dispatch(n_sweeps=plan.total_sweeps,
                            sites=engine.cfg.n * engine.cfg.m,
                            replicas=engine.replicas, batch=batch,
                            counter_based=engine.counter_based)


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
    with _traced(engine, plan, 1):
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
    with tel.span("measure.alloc"):
        out = {k: torch.empty(shape, dtype=torch.float32, device=device)
               for k in plan.fields}
    args = (engine, inv_temps, seeds, plan, step_count, out)
    with _traced(engine, plan, len(seeds)):
        if device.type == "cuda" and not loop:
            states = _graph_trajectory(states, *args)
        else:
            states = _trajectory(states, *args)
    with tel.span("measure.to_host"):
        traj = {k: v.cpu().numpy() for k, v in out.items()}
    return states, traj, step_count + plan.total_sweeps


def _trajectory(states, engine, inv_temps, seeds, plan, step, out):
    """Thermalize, then ``n_measure`` x (sweeps; every member's
    observables into row i of ``out``); returns the final states."""
    if plan.thermalize:
        with tel.span("measure.sweeps", k=plan.thermalize):
            states = engine.scan_step_batched(states, inv_temps, seeds,
                                              step, plan.thermalize)
        step += plan.thermalize
    for i in range(plan.n_measure):
        with tel.span("measure.sweeps", k=plan.sweeps_between):
            states = engine.scan_step_batched(states, inv_temps, seeds,
                                              step, plan.sweeps_between)
        step += plan.sweeps_between
        with tel.span("measure.observe", row=i):
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
    that the two are spanned apart, where this PyTorch can
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
    def sweep(n_sweeps, step):
        with tel.span("measure.sweeps", k=n_sweeps):
            new = engine.scan_step_batched(states, inv_temps, seeds, step,
                                           n_sweeps)
            for dst, src in zip(states, new):
                if src.data_ptr() != dst.data_ptr():
                    dst.copy_(src)
        return step + n_sweeps

    if plan.thermalize:
        step = sweep(plan.thermalize, step)
    step = sweep(plan.sweeps_between, step)
    with tel.span("measure.observe", row=0):
        _observe(engine, states, inv_temps, plan, out, 0)
    if plan.n_measure == 1:
        return states
    device = states[0].device
    stream = torch.cuda.current_stream(device)
    row = torch.ones(1, dtype=torch.int64, device=device)
    graph, separate = _new_graph()
    # captured on a side stream, as ``torch.cuda.graph`` does, but without
    # its emptying of the allocator's cache, which would make the next
    # run's allocations pay for new device memory; the engine's stream
    # and, while its last graph lives, that graph's pool
    kept, capture = _KEPT.get(engine, (None, None))
    if capture is None:
        capture = torch.cuda.Stream(device)
    capture.wait_stream(stream)
    with torch.cuda.stream(capture), tel.span("measure.graph_capture"):
        graph.capture_begin(pool=None if kept is None else kept.pool())
        try:
            _observe(engine, states, inv_temps, plan, out, row)
            row.add_(1)
        finally:
            graph.capture_end()     # raises where the capture failed
    stream.wait_stream(capture)
    if separate:
        with tel.span("measure.graph_instantiate"):
            graph.instantiate()
    for _ in range(1, plan.n_measure):
        step = sweep(plan.sweeps_between, step)
        with tel.span("measure.graph_replay"):
            graph.replay()
        GRAPH_REPLAYS.inc()
    with tel.span("measure.graph_reset"):
        # its pool is this graph's now: freeing it frees no device memory
        if kept is not None:
            kept.reset()
        _KEPT[engine] = graph, capture
    return states
