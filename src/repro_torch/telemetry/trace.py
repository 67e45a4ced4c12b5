"""Span tracer: named host intervals, on the device trace's clock too.

Counterpart of ``repro.telemetry.trace``.  A *span* is one named,
attributed, nested interval of host wall-clock
(``time.perf_counter_ns``) around a phase of the execution stack --
``spec.validate``, ``session.open``, ``measure_scan``, ``dispatch``,
``ckpt.save`` ...  A span is a host interval and never waits for the
card: CUDA launches return before the card has run them, so a span
around device work ends when the host has queued it (or when the code
inside synchronized on its own).  The device's time comes from the
device trace, never from a host wait, and a span may enclose a CUDA
graph capture (none may open inside one).

A span is recorded in two cases, each checked when it opens:

* while ``enabled`` -- into this tracer's event list, for the exports
  below;
* while a ``torch.profiler`` session records in the process -- as a
  ``record_function`` range named ``repro_torch/<span name>``, which the
  profiler exports as a ``user_annotation`` event on its own clock,
  beside the card's kernels (an instant is a range of no length).

Otherwise a span is the shared :data:`NULL_SPAN`: one flag test and one
``torch.autograd._profiler_enabled()`` call (``torch`` read from
``sys.modules``, so the telemetry imports without it).

Export formats:

* ``export_chrome(path)`` -- Chrome trace-event JSON (``traceEvents``
  complete/instant events), loadable in Perfetto / ``chrome://tracing``
  as-is; extra top-level keys carry the metrics snapshot and run meta.
* ``export_jsonl(path)`` -- one JSON object per line (``kind: span |
  instant | metrics | meta``), for streaming consumers.

Thread-safe: the nesting stack is thread-local (the async checkpoint
writer records ``ckpt.write`` spans from its worker thread), the event
list is lock-guarded, and events carry their ``tid``.
"""

from __future__ import annotations

import json
import sys
import threading
import time
from typing import Any, Dict, List, Optional

#: the prefix of a span's range in a ``torch.profiler`` trace
RANGE_PREFIX = "repro_torch/"


def profiling() -> bool:
    """Whether a ``torch.profiler`` session records in this process
    (never where ``torch`` is not loaded)."""
    torch = sys.modules.get("torch")
    return torch is not None and torch.autograd._profiler_enabled()


def _enter_range(name: str):
    """The profiler range of the span or instant ``name``, entered."""
    from torch.profiler import record_function
    r = record_function(RANGE_PREFIX + name)
    r.__enter__()
    return r


def _jsonable(v) -> Any:
    """Attribute values must survive ``json.dumps`` losslessly."""
    if isinstance(v, (str, int, float, bool)) or v is None:
        return v
    if isinstance(v, (tuple, list)):
        return [_jsonable(x) for x in v]
    return str(v)


class _NullSpan:
    """The shared no-op span of a phase that nothing records."""

    __slots__ = ()
    duration_ns: Optional[int] = None

    def set(self, **attrs) -> None:
        pass

    def __enter__(self):
        return self

    def __exit__(self, exc_type, exc, tb):
        return False


NULL_SPAN = _NullSpan()


class SpanHandle:
    """Live span, a context manager (:meth:`Tracer.span`): ``set`` adds
    attributes; after the ``with`` block exits, ``duration_ns`` holds its
    host wall-clock.  ``keep``: it goes into the tracer's event list
    (tracing was enabled when it opened); ``profiled``: it is a
    ``torch.profiler`` range too."""

    __slots__ = ("name", "attrs", "t0_ns", "depth", "tid", "keep",
                 "profiled", "duration_ns", "_tracer", "_range")

    def __init__(self, tracer: "Tracer", name: str, attrs: Dict[str, Any],
                 keep: bool, profiled: bool):
        self._tracer = tracer
        self.name = name
        self.attrs = attrs
        self.t0_ns = 0
        self.depth = 0
        self.tid = threading.get_ident()
        self.keep = keep
        self.profiled = profiled
        self.duration_ns: Optional[int] = None
        self._range = None

    def set(self, **attrs) -> None:
        for k, v in attrs.items():
            self.attrs[k] = _jsonable(v)

    def __enter__(self):
        if self.keep:
            self._tracer._push(self)
        if self.profiled:
            self._range = _enter_range(self.name)
        self.t0_ns = time.perf_counter_ns()
        return self

    def __exit__(self, exc_type, exc, tb):
        self._tracer._close(self, error=exc_type is not None)
        return False


class Tracer:
    """Collects span/instant events while ``enabled``, and mirrors them
    into a recording ``torch.profiler``; no-ops otherwise."""

    def __init__(self):
        self.enabled = False
        self._lock = threading.Lock()
        self._events: List[dict] = []
        self._tls = threading.local()
        self._origin_ns = time.perf_counter_ns()

    # -- lifecycle ----------------------------------------------------------
    def enable(self) -> None:
        self.enabled = True

    def disable(self) -> None:
        self.enabled = False

    def clear(self) -> None:
        with self._lock:
            self._events = []
        self._origin_ns = time.perf_counter_ns()

    # -- recording ----------------------------------------------------------
    def _stack(self) -> list:
        st = getattr(self._tls, "stack", None)
        if st is None:
            st = self._tls.stack = []
        return st

    def _push(self, handle: SpanHandle) -> None:
        st = self._stack()
        handle.depth = len(st)
        st.append(handle)

    def span(self, name: str, **attrs):
        """``with tracer.span("dispatch", engine="multispin") as sp:``

        :data:`NULL_SPAN` while tracing is disabled and no profiler
        records.  Attributes are JSON-normalized at entry;
        ``sp.set(...)`` adds more.
        """
        profiled = profiling()
        if not (self.enabled or profiled):
            return NULL_SPAN
        return SpanHandle(self, name,
                          {k: _jsonable(v) for k, v in attrs.items()},
                          self.enabled, profiled)

    def _close(self, handle: SpanHandle, error: bool = False) -> None:
        t1 = time.perf_counter_ns()
        if handle._range is not None:
            handle._range.__exit__(None, None, None)
            handle._range = None
        handle.duration_ns = t1 - handle.t0_ns
        if not handle.keep:
            return
        st = self._stack()
        if st and st[-1] is handle:
            st.pop()
        if error:
            handle.attrs["error"] = True
        event = {"kind": "span", "name": handle.name,
                 "ts_us": (handle.t0_ns - self._origin_ns) / 1e3,
                 "dur_us": handle.duration_ns / 1e3,
                 "depth": handle.depth, "tid": handle.tid,
                 "args": handle.attrs}
        with self._lock:
            self._events.append(event)

    def instant(self, name: str, **attrs) -> None:
        """A zero-duration annotation event (e.g. ``planner.decide``)."""
        if profiling():
            _enter_range(name).__exit__(None, None, None)
        if not self.enabled:
            return
        event = {"kind": "instant", "name": name,
                 "ts_us": (time.perf_counter_ns() - self._origin_ns) / 1e3,
                 "depth": len(self._stack()),
                 "tid": threading.get_ident(),
                 "args": {k: _jsonable(v) for k, v in attrs.items()}}
        with self._lock:
            self._events.append(event)

    # -- reading ------------------------------------------------------------
    @property
    def events(self) -> List[dict]:
        """Snapshot copy of the recorded events (chronological per
        thread; spans are appended at CLOSE time, so a parent span
        appears after its children)."""
        with self._lock:
            return list(self._events)

    def span_names(self) -> List[str]:
        return sorted({e["name"] for e in self.events})

    # -- export -------------------------------------------------------------
    def to_chrome(self, metrics: Optional[dict] = None,
                  meta: Optional[dict] = None) -> dict:
        """The Chrome trace-event document (Perfetto-loadable): every
        span as a ``ph: "X"`` complete event, instants as ``ph: "i"``;
        ``metrics``/``meta`` ride along as extra top-level keys that
        trace viewers ignore and ``summarize`` reads back."""
        trace_events = []
        for e in self.events:
            ev = {"name": e["name"], "cat": "repro",
                  "ph": "X" if e["kind"] == "span" else "i",
                  "ts": e["ts_us"], "pid": 0, "tid": e["tid"],
                  "args": dict(e["args"], depth=e["depth"])}
            if e["kind"] == "span":
                ev["dur"] = e["dur_us"]
            else:
                ev["s"] = "t"  # instant scope: thread
            trace_events.append(ev)
        # viewers sort by ts, but keep the file humanly chronological
        trace_events.sort(key=lambda ev: ev["ts"])
        doc = {"traceEvents": trace_events, "displayTimeUnit": "ms"}
        if metrics is not None:
            doc["metrics"] = metrics
        if meta is not None:
            doc["meta"] = meta
        return doc

    def export_chrome(self, path: str, metrics: Optional[dict] = None,
                      meta: Optional[dict] = None) -> str:
        with open(path, "w") as f:
            json.dump(self.to_chrome(metrics=metrics, meta=meta), f,
                      indent=1, sort_keys=True)
        return path

    def export_jsonl(self, path: str, metrics: Optional[dict] = None,
                     meta: Optional[dict] = None) -> str:
        with open(path, "w") as f:
            if meta is not None:
                f.write(json.dumps({"kind": "meta", **meta},
                                   sort_keys=True) + "\n")
            for e in self.events:
                f.write(json.dumps(e, sort_keys=True) + "\n")
            if metrics is not None:
                f.write(json.dumps({"kind": "metrics", **metrics},
                                   sort_keys=True) + "\n")
        return path


#: the process-global tracer every subsystem records into
TRACER = Tracer()
