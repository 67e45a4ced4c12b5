"""Schema for telemetry exports (counterpart of ``repro.telemetry.schema``).

Two validated documents:

* the **metrics snapshot** (``MetricsRegistry.snapshot()``): counters
  are non-negative ints, gauges finite floats, histograms carry
  consistent ``count/sum/min/max/mean`` summaries;
* the **trace document** (``Tracer.to_chrome()``): a Perfetto-loadable
  ``traceEvents`` list of complete (``ph: "X"``) and instant
  (``ph: "i"``) events with finite non-negative timestamps/durations
  and JSON-scalar span attributes, plus the optional embedded
  ``metrics`` snapshot and ``meta`` block.

The rules are the JAX package's, so a trace of either package validates
under both.  Every export path validates before writing (``python -m
repro_torch run --trace``), and the committed golden trace of the JAX
package validates here too (``tests/test_torch_telemetry.py``) -- a
trace a viewer cannot load, or a snapshot a dashboard cannot chart,
must die at emission time, not in a later consumer.
"""
from __future__ import annotations

import math


class TelemetryError(ValueError):
    """A telemetry document violates the trace/snapshot schema."""


def _fail(ctx: str, msg: str) -> None:
    raise TelemetryError(f"{ctx}: {msg}")


def _check_num(ctx: str, key: str, v, *, nonneg: bool = True) -> float:
    if isinstance(v, bool) or not isinstance(v, (int, float)):
        _fail(ctx, f"{key} must be a number, got {type(v).__name__}")
    f = float(v)
    if not math.isfinite(f):
        _fail(ctx, f"{key} must be finite, got {v!r}")
    if nonneg and f < 0:
        _fail(ctx, f"{key} must be >= 0, got {v!r}")
    return f


# ---------------------------------------------------------------------------
# metrics snapshot
# ---------------------------------------------------------------------------

SNAPSHOT_KEYS = frozenset({"counters", "gauges", "histograms"})

#: keys a histogram summary may carry; count-0 histograms carry only
#: ``count`` (a min/max of an empty stream is not a measurement)
HIST_KEYS = frozenset({"count", "sum", "min", "max", "mean"})


def _check_name(ctx: str, name) -> None:
    if not isinstance(name, str) or not name:
        _fail(ctx, f"metric name must be a non-empty string, "
                   f"got {name!r}")


def validate_snapshot(snap: dict, ctx: str = "snapshot") -> None:
    """Raise :class:`TelemetryError` unless ``snap`` is a valid metrics
    snapshot."""
    if not isinstance(snap, dict):
        _fail(ctx, f"snapshot must be a dict, got {type(snap).__name__}")
    extra = set(snap) - SNAPSHOT_KEYS
    if extra:
        _fail(ctx, f"unknown snapshot keys {sorted(extra)}")
    for req in SNAPSHOT_KEYS:
        if not isinstance(snap.get(req), dict):
            _fail(ctx, f"missing/invalid {req!r} (must be a dict)")
    for name, v in snap["counters"].items():
        _check_name(f"{ctx} counters", name)
        if isinstance(v, bool) or not isinstance(v, int) or v < 0:
            _fail(ctx, f"counter {name!r} must be an int >= 0, got {v!r}")
    for name, v in snap["gauges"].items():
        _check_name(f"{ctx} gauges", name)
        _check_num(ctx, f"gauge {name!r}", v, nonneg=False)
    for name, h in snap["histograms"].items():
        _check_name(f"{ctx} histograms", name)
        hctx = f"{ctx} histogram {name!r}"
        if not isinstance(h, dict):
            _fail(hctx, "summary must be a dict")
        extra = set(h) - HIST_KEYS
        if extra:
            _fail(hctx, f"unknown keys {sorted(extra)}")
        count = h.get("count")
        if isinstance(count, bool) or not isinstance(count, int) \
                or count < 0:
            _fail(hctx, f"count must be an int >= 0, got {count!r}")
        if count == 0:
            if set(h) != {"count"}:
                _fail(hctx, "empty histogram must carry only count=0")
            continue
        for k in ("sum", "min", "max", "mean"):
            if k not in h:
                _fail(hctx, f"missing {k!r}")
            _check_num(hctx, k, h[k], nonneg=False)
        if not h["min"] <= h["mean"] <= h["max"]:
            _fail(hctx, f"min <= mean <= max violated: {h}")


# ---------------------------------------------------------------------------
# chrome trace document
# ---------------------------------------------------------------------------

TRACE_KEYS = frozenset({"traceEvents", "displayTimeUnit", "metrics",
                        "meta"})
EVENT_KEYS = frozenset({"name", "cat", "ph", "ts", "dur", "pid", "tid",
                        "args", "s"})


def _check_args(ctx: str, args) -> None:
    if not isinstance(args, dict):
        _fail(ctx, "args must be a dict")
    for k, v in args.items():
        if not isinstance(k, str) or not k:
            _fail(ctx, f"args key {k!r} must be a non-empty string")
        if isinstance(v, list):
            bad = [x for x in v
                   if not isinstance(x, (str, int, float, bool))
                   and x is not None]
            if bad:
                _fail(ctx, f"args[{k!r}] list holds non-scalars {bad!r}")
        elif not isinstance(v, (str, int, float, bool)) and v is not None:
            _fail(ctx, f"args[{k!r}] must be a JSON scalar or scalar "
                       f"list, got {type(v).__name__}")


def validate_event(ev: dict, ctx: str = "event") -> None:
    if not isinstance(ev, dict):
        _fail(ctx, f"event must be a dict, got {type(ev).__name__}")
    name = ev.get("name")
    if not isinstance(name, str) or not name:
        _fail(ctx, f"name must be a non-empty string, got {name!r}")
    ctx = f"{ctx} {name!r}"
    extra = set(ev) - EVENT_KEYS
    if extra:
        _fail(ctx, f"unknown event keys {sorted(extra)}")
    ph = ev.get("ph")
    if ph not in ("X", "i"):
        _fail(ctx, f"ph must be 'X' (complete) or 'i' (instant), "
                   f"got {ph!r}")
    _check_num(ctx, "ts", ev.get("ts"))
    if ph == "X":
        if "dur" not in ev:
            _fail(ctx, "complete event missing dur")
        _check_num(ctx, "dur", ev["dur"])
    elif "dur" in ev:
        _fail(ctx, "instant event carries dur")
    for k in ("pid", "tid"):
        v = ev.get(k)
        if isinstance(v, bool) or not isinstance(v, int):
            _fail(ctx, f"{k} must be an int, got {v!r}")
    _check_args(ctx, ev.get("args", {}))


def validate_trace(doc: dict, ctx: str = "trace") -> None:
    """Raise :class:`TelemetryError` unless ``doc`` is a valid Chrome
    trace-event document (with the optional embedded snapshot)."""
    if not isinstance(doc, dict):
        _fail(ctx, f"trace must be a dict, got {type(doc).__name__}")
    extra = set(doc) - TRACE_KEYS
    if extra:
        _fail(ctx, f"unknown top-level keys {sorted(extra)}")
    events = doc.get("traceEvents")
    if not isinstance(events, list):
        _fail(ctx, "traceEvents must be a list")
    for i, ev in enumerate(events):
        validate_event(ev, ctx=f"{ctx} traceEvents[{i}]")
    if "metrics" in doc:
        validate_snapshot(doc["metrics"], ctx=f"{ctx} metrics")
    if "meta" in doc and not isinstance(doc["meta"], dict):
        _fail(ctx, "meta must be a dict")
