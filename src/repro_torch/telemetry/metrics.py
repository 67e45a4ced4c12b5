"""Metrics registry: counters, gauges, timing histograms.

Counterpart of ``repro.telemetry.metrics``.  The registry is the
*always-on* half of the telemetry subsystem: a counter increment is one
locked integer add on the host (once per dispatch, never per sweep or
per site), so the counters stay correct whether or not span tracing is
enabled, and a run of either package on the same spec gives the same
counts.

Three instrument kinds, all process-global through :data:`REGISTRY`:

* :class:`Counter`   -- monotone int (dispatches, sweeps, spin_flips,
  philox_draws, planner decisions).  ``value`` reads, ``inc`` adds.
* :class:`Gauge`     -- last-written float.
* :class:`Histogram` -- streaming count/sum/min/max of float samples.

``REGISTRY.snapshot()`` renders everything as one plain-JSON dict in
the validated schema of :mod:`repro_torch.telemetry.schema` (every
emission validates before export).  ``reset()`` zeroes instruments *in
place* -- modules hold references to their counters (e.g.
``repro_torch.telemetry.DISPATCHES``), so the objects must survive a
reset.
"""
from __future__ import annotations

import math
import threading
from typing import Dict, Optional


class Counter:
    """Monotone integer counter; ``inc`` is host-side only."""

    __slots__ = ("name", "_value", "_lock")

    def __init__(self, name: str, lock: threading.Lock):
        self.name = name
        self._value = 0
        self._lock = lock

    def inc(self, n: int = 1) -> None:
        if n < 0:
            raise ValueError(f"counter {self.name!r}: inc({n}) -- "
                             f"counters are monotone")
        with self._lock:
            self._value += int(n)

    @property
    def value(self) -> int:
        return self._value

    def _reset(self) -> None:
        with self._lock:
            self._value = 0


class Gauge:
    """Last-written float value; ``None`` until first ``set``."""

    __slots__ = ("name", "_value", "_lock")

    def __init__(self, name: str, lock: threading.Lock):
        self.name = name
        self._value: Optional[float] = None
        self._lock = lock

    def set(self, v: float) -> None:
        f = float(v)
        if not math.isfinite(f):
            raise ValueError(f"gauge {self.name!r}: non-finite {v!r}")
        with self._lock:
            self._value = f

    @property
    def value(self) -> Optional[float]:
        return self._value

    def _reset(self) -> None:
        with self._lock:
            self._value = None


class Histogram:
    """Streaming summary (count/sum/min/max) of float observations."""

    __slots__ = ("name", "count", "sum", "min", "max", "_lock")

    def __init__(self, name: str, lock: threading.Lock):
        self.name = name
        self._lock = lock
        self._zero()

    def _zero(self) -> None:
        self.count = 0
        self.sum = 0.0
        self.min = math.inf
        self.max = -math.inf

    def observe(self, v: float) -> None:
        f = float(v)
        if not math.isfinite(f):
            raise ValueError(f"histogram {self.name!r}: non-finite {v!r}")
        with self._lock:
            self.count += 1
            self.sum += f
            self.min = min(self.min, f)
            self.max = max(self.max, f)

    def stats(self) -> dict:
        """``{count, sum, min, max, mean}``; empty histograms report
        only ``count=0`` (a min/max of +-inf is not JSON).  The mean is
        clamped into [min, max]: the rounded float sum of equal values
        divided by their count can land an ulp above them (three
        observations of 699050.9333094994), which the schema rejects."""
        with self._lock:
            if not self.count:
                return {"count": 0}
            mean = min(max(self.sum / self.count, self.min), self.max)
            return {"count": self.count, "sum": self.sum,
                    "min": self.min, "max": self.max, "mean": mean}

    def _reset(self) -> None:
        with self._lock:
            self._zero()


class MetricsRegistry:
    """Name -> instrument map with get-or-create accessors.

    A name is permanently bound to its first-created kind; asking for a
    ``counter`` that exists as a ``gauge`` is a bug and raises.
    """

    def __init__(self):
        self._lock = threading.Lock()
        self._counters: Dict[str, Counter] = {}
        self._gauges: Dict[str, Gauge] = {}
        self._histograms: Dict[str, Histogram] = {}

    def _get(self, table, others, name: str, factory):
        if not isinstance(name, str) or not name:
            raise ValueError(f"metric name must be a non-empty string, "
                             f"got {name!r}")
        with self._lock:
            for other in others:
                if name in other:
                    raise ValueError(
                        f"metric {name!r} already registered as a "
                        f"different instrument kind")
            inst = table.get(name)
            if inst is None:
                inst = table[name] = factory(name, self._lock)
            return inst

    def counter(self, name: str) -> Counter:
        return self._get(self._counters,
                         (self._gauges, self._histograms), name, Counter)

    def gauge(self, name: str) -> Gauge:
        return self._get(self._gauges,
                         (self._counters, self._histograms), name, Gauge)

    def histogram(self, name: str) -> Histogram:
        return self._get(self._histograms,
                         (self._counters, self._gauges), name, Histogram)

    def snapshot(self) -> dict:
        """The whole registry as one plain-JSON dict (validated shape:
        :func:`repro_torch.telemetry.schema.validate_snapshot`).  Unset gauges
        are omitted -- ``None`` is not a measurement."""
        with self._lock:
            counters = {n: c._value for n, c in self._counters.items()}
            gauges = {n: g._value for n, g in self._gauges.items()
                      if g._value is not None}
            hists = list(self._histograms.items())
        return {"counters": counters, "gauges": gauges,
                "histograms": {n: h.stats() for n, h in hists}}

    def reset(self) -> None:
        """Zero every instrument IN PLACE (module-held references stay
        valid) -- test isolation, not production use."""
        with self._lock:
            tables = (list(self._counters.values())
                      + list(self._gauges.values())
                      + list(self._histograms.values()))
        for inst in tables:
            inst._reset()


def diff_counters(base: dict, now: dict) -> dict:
    """Counter deltas ``now - base`` of two snapshots (both from
    :meth:`MetricsRegistry.snapshot`) -- how a traced region renders
    its *own* totals out of the process-global monotone counters."""
    out = {}
    for name, v in now.get("counters", {}).items():
        out[name] = v - base.get("counters", {}).get(name, 0)
    return out


#: the process-global registry every subsystem records into
REGISTRY = MetricsRegistry()
