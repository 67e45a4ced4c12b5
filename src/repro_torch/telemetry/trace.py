"""Span tracer: monotonic-clock phase timing with explicit fencing.

Counterpart of ``repro.telemetry.trace``.  A *span* is one named,
attributed, nested interval of host wall-clock
(``time.perf_counter_ns``) around a phase of the execution stack --
``spec.validate``, ``session.open``, ``measure_scan``, ``dispatch``,
``ckpt.save`` ...  CUDA launches return before the card has run them,
so a span that times device work must *fence* before it closes:
``sp.fence(out)`` remembers the output (a tensor, or a tuple, list or
dict of them, nested: a sharded state is lists of shards on their
devices), and at close the tracer records a ``torch.cuda.Event`` on the
current stream of each CUDA device among them and synchronizes it (what
the JAX tracer does with ``jax.block_until_ready``), so the recorded
duration covers the device work, not just the enqueue.  CPU tensors
need no fence.  Fencing (like every other part of a span) is a NO-OP
while tracing is disabled -- the default -- so instrumented code adds
no host synchronization when nobody is looking.  No span may be open
around a CUDA graph capture: an event synchronize is illegal while a
stream captures.

Export formats:

* ``export_chrome(path)`` -- Chrome trace-event JSON (``traceEvents``
  complete/instant events), loadable in Perfetto / ``chrome://tracing``
  as-is; extra top-level keys carry the metrics snapshot and run meta.
* ``export_jsonl(path)`` -- one JSON object per line (``kind: span |
  instant | metrics | meta``), for streaming consumers.

Span close also feeds a ``span_ms.<name>`` histogram in the metrics
registry, so the snapshot carries per-phase timing even without the
event list.  Thread-safe: the nesting stack is thread-local (the async
checkpoint writer records ``ckpt.write`` spans from its worker thread),
the event list is lock-guarded, and events carry their ``tid``.
"""
from __future__ import annotations

import json
import threading
import time
from typing import Any, Dict, List, Optional

from .metrics import REGISTRY


def fence_devices(value, out=None) -> list:
    """The CUDA devices of the tensors in ``value`` (a tensor, or a
    tuple, list or dict of them, nested), each once, in first-seen
    order."""
    out = [] if out is None else out
    if isinstance(value, dict):
        for v in value.values():
            fence_devices(v, out)
    elif isinstance(value, (tuple, list)):
        for v in value:
            fence_devices(v, out)
    else:
        device = getattr(value, "device", None)
        if getattr(device, "type", None) == "cuda" and device not in out:
            out.append(device)
    return out


def wait_for(value) -> None:
    """Block the host until the work queued so far on the current stream
    of every CUDA device in ``value`` is done: an event recorded there,
    then synchronized."""
    devices = fence_devices(value)
    if not devices:
        return
    import torch
    for device in devices:
        event = torch.cuda.Event()
        event.record(torch.cuda.current_stream(device))
        event.synchronize()


def _jsonable(v) -> Any:
    """Attribute values must survive ``json.dumps`` losslessly."""
    if isinstance(v, (str, int, float, bool)) or v is None:
        return v
    if isinstance(v, (tuple, list)):
        return [_jsonable(x) for x in v]
    return str(v)


class _NullSpan:
    """The shared no-op handle yielded while tracing is disabled."""

    __slots__ = ()
    duration_ns: Optional[int] = None

    def set(self, **attrs) -> None:
        pass

    def fence(self, value) -> None:
        pass  # disabled tracing: no event, no synchronize


NULL_SPAN = _NullSpan()


class SpanHandle:
    """Live span: ``set`` adds attributes, ``fence`` registers tensors
    to wait for before the close timestamp is taken; after the ``with``
    block exits, ``duration_ns`` holds the fenced wall-clock."""

    __slots__ = ("name", "attrs", "t0_ns", "depth", "tid", "_fence",
                 "duration_ns")

    def __init__(self, name: str, attrs: Dict[str, Any], t0_ns: int,
                 depth: int, tid: int):
        self.name = name
        self.attrs = attrs
        self.t0_ns = t0_ns
        self.depth = depth
        self.tid = tid
        self._fence = None
        self.duration_ns: Optional[int] = None

    def set(self, **attrs) -> None:
        for k, v in attrs.items():
            self.attrs[k] = _jsonable(v)

    def fence(self, value) -> None:
        self._fence = value


class _Scope:
    """Context manager returned by :meth:`Tracer.span`."""

    __slots__ = ("_tracer", "_handle")

    def __init__(self, tracer: "Tracer", handle):
        self._tracer = tracer
        self._handle = handle

    def __enter__(self):
        h = self._handle
        if h is not NULL_SPAN:
            self._tracer._push(h)
            h.t0_ns = time.perf_counter_ns()
        return h

    def __exit__(self, exc_type, exc, tb):
        h = self._handle
        if h is not NULL_SPAN:
            self._tracer._close(h, error=exc_type is not None)
        return False


class Tracer:
    """Collects span/instant events while ``enabled``; no-ops otherwise."""

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

    def span(self, name: str, **attrs) -> _Scope:
        """``with tracer.span("dispatch", engine="multispin") as sp:``

        Yields :data:`NULL_SPAN` while disabled.  Attributes are
        JSON-normalized at entry; ``sp.set(...)`` adds more, and
        ``sp.fence(out)`` makes the close wait for the device work on
        the streams that produced ``out``.
        """
        if not self.enabled:
            return _Scope(self, NULL_SPAN)
        handle = SpanHandle(name,
                            {k: _jsonable(v) for k, v in attrs.items()},
                            0, 0, threading.get_ident())
        return _Scope(self, handle)

    def _close(self, handle: SpanHandle, error: bool = False) -> None:
        if handle._fence is not None:
            wait_for(handle._fence)
            handle._fence = None
        t1 = time.perf_counter_ns()
        st = self._stack()
        if st and st[-1] is handle:
            st.pop()
        handle.duration_ns = t1 - handle.t0_ns
        if error:
            handle.attrs["error"] = True
        event = {"kind": "span", "name": handle.name,
                 "ts_us": (handle.t0_ns - self._origin_ns) / 1e3,
                 "dur_us": handle.duration_ns / 1e3,
                 "depth": handle.depth, "tid": handle.tid,
                 "args": handle.attrs}
        with self._lock:
            self._events.append(event)
        REGISTRY.histogram(f"span_ms.{handle.name}").observe(
            handle.duration_ns / 1e6)

    def instant(self, name: str, **attrs) -> None:
        """A zero-duration annotation event (e.g. ``planner.decide``)."""
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
