"""``repro_torch.telemetry`` -- spans, counters, and trace export.

Counterpart of ``repro.telemetry``: observability for the whole
execution stack, with no dependency beyond the standard library (and
``torch`` to fence).  Two halves with different costs:

* **Metrics** (:data:`REGISTRY`) are *always on*: one locked integer
  add per dispatch on the host.  The canonical counters below count
  what the JAX package's count, so the same spec through either
  package's ``Session`` gives equal :func:`diff_counters`.
* **Spans** (:data:`TRACER`) are *opt-in* (``enable()`` /
  ``python -m repro_torch run --trace out.json``): when disabled, a
  span is one ``if not enabled`` branch and fencing never happens, so
  the host never waits for the card on their account.

Quickstart::

    import repro_torch.telemetry as tel
    tel.enable()
    ... run things ...
    tel.export("trace.json")        # Chrome trace (Perfetto-loadable)
    tel.export("trace.jsonl")       # line-delimited stream
    print(tel.REGISTRY.snapshot())  # counters/gauges/histograms

Counter semantics (asserted in tests/test_torch_telemetry.py):

* ``dispatches``   -- +1 per ``sweeps`` call of a runner (each
  attempt of a retried one again) and +1 per measured trajectory,
  whatever the sweeps and kernel launches inside (the kernels'
  ``.launches`` attributes count launches).
* ``sweeps``       -- lattice-time sweeps advanced, NOT multiplied by
  replicas or batch members (a bitplane sweep advances 32 replicas one
  sweep = 1 here).
* ``spin_flips``   -- update attempts: sweeps x sites x replicas x
  batch (the flips/ns numerator of the paper's Table 1).
* ``philox_draws`` -- uint32s drawn by counter-based engines:
  sweeps x sites x batch (one draw per site per sweep; multispin packs
  8 sites per word but draws 8 offsets/word, bitplane shares one draw
  across its 32 replicas -- both land on exactly sites draws/sweep).
* ``halo_exchanges`` -- halo exchange *events* on the sharded paths:
  the per-half-sweep distributed tier performs 2 per sweep, the
  sharded resident tier exactly one per block of k sweeps.
* ``halo_bytes``     -- bytes moved across the mesh by those
  exchanges, summed over every shard.
"""
from __future__ import annotations

from .metrics import (REGISTRY, Counter, Gauge, Histogram,
                      MetricsRegistry, diff_counters)
from .schema import (TelemetryError, validate_event, validate_snapshot,
                     validate_trace)
from .trace import NULL_SPAN, TRACER, SpanHandle, Tracer

__all__ = [
    "TRACER", "REGISTRY", "Tracer", "MetricsRegistry",
    "Counter", "Gauge", "Histogram", "SpanHandle", "NULL_SPAN",
    "TelemetryError", "validate_snapshot", "validate_trace",
    "validate_event", "diff_counters",
    "DISPATCHES", "SWEEPS", "SPIN_FLIPS", "PHILOX_DRAWS",
    "HALO_EXCHANGES", "HALO_BYTES",
    "enable", "disable", "enabled", "reset", "span", "instant",
    "record_dispatch", "record_halo_exchange", "export",
]

#: canonical counters -- module-held references survive REGISTRY.reset()
DISPATCHES = REGISTRY.counter("dispatches")
SWEEPS = REGISTRY.counter("sweeps")
SPIN_FLIPS = REGISTRY.counter("spin_flips")
PHILOX_DRAWS = REGISTRY.counter("philox_draws")
HALO_EXCHANGES = REGISTRY.counter("halo_exchanges")
HALO_BYTES = REGISTRY.counter("halo_bytes")


def enable() -> None:
    """Turn span tracing on (counters are always on)."""
    TRACER.enable()


def disable() -> None:
    TRACER.disable()


def enabled() -> bool:
    return TRACER.enabled


def reset() -> None:
    """Drop recorded events and zero every metric (test isolation /
    the start of a traced run), keeping instrument identity."""
    TRACER.clear()
    REGISTRY.reset()


#: module-level aliases so call sites read ``tel.span("dispatch", ...)``
span = TRACER.span
instant = TRACER.instant


def record_dispatch(*, n_sweeps: int, sites: int, replicas: int = 1,
                    batch: int = 1, counter_based: bool = False) -> None:
    """Account one dispatch into the canonical counters: from the host
    wrapper that launches it, never from a captured CUDA graph (a
    capture runs the Python once, its replays never)."""
    if n_sweeps < 0:
        raise ValueError(f"record_dispatch: n_sweeps={n_sweeps}")
    draws = int(n_sweeps) * int(sites)
    # all instruments share the registry lock: batch the adds into one
    # acquisition -- this sits on every dispatch path
    with REGISTRY._lock:
        DISPATCHES._value += 1
        SWEEPS._value += int(n_sweeps)
        SPIN_FLIPS._value += draws * int(replicas) * int(batch)
        if counter_based:
            PHILOX_DRAWS._value += draws * int(batch)


def record_halo_exchange(exchanges: int, bytes_moved: int) -> None:
    """Account halo traffic of one sharded dispatch: ``exchanges``
    exchange events moving ``bytes_moved`` bytes total (all shards,
    both planes).  Host-side only, like :func:`record_dispatch`."""
    if exchanges < 0 or bytes_moved < 0:
        raise ValueError(
            f"record_halo_exchange: {exchanges=}, {bytes_moved=}")
    with REGISTRY._lock:
        HALO_EXCHANGES._value += int(exchanges)
        HALO_BYTES._value += int(bytes_moved)


def export(path: str, meta: dict | None = None) -> str:
    """Validate and write the current trace + metrics snapshot.

    ``*.jsonl`` -> line-delimited stream; anything else -> Chrome
    trace-event JSON (open in Perfetto / ``chrome://tracing``).
    """
    snap = REGISTRY.snapshot()
    validate_snapshot(snap)
    if path.endswith(".jsonl"):
        return TRACER.export_jsonl(path, metrics=snap, meta=meta)
    validate_trace(TRACER.to_chrome(metrics=snap, meta=meta))
    return TRACER.export_chrome(path, metrics=snap, meta=meta)
