"""The program's spans in the device trace of a traced run's window.

While ``torch.profiler`` records, the program mirrors each span of its
tracer into the trace as a ``user_annotation`` range named
``repro_torch/<span name>``, on the profiler's clock (the host events of
:class:`bench.trace.Summary`).  :func:`idle_pct` reads the share of the
window in which the card is idle while the host is inside the ranges of
some spans.  A trace that holds no ``repro_torch/`` range, of a program
that does not mirror its spans, reads nothing.
"""
from __future__ import annotations

from typing import Iterable, List, Optional, Sequence, Tuple

PREFIX = "repro_torch/"

Intervals = List[Tuple[float, float]]


def has_spans(summary) -> bool:
    return any(name.startswith(PREFIX) for _, _, name in summary.host)


def intervals(summary, names: Iterable[str]) -> Intervals:
    """The union of the ranges of the spans ``names`` inside the window:
    sorted, disjoint intervals (ranges that nest or overlap count once)."""
    wanted = {PREFIX + n for n in names}
    t0, t1 = summary.window
    merged: Intervals = []
    for s, e in sorted((max(s, t0), min(e, t1))
                       for s, e, name in summary.host if name in wanted):
        if e <= s:
            continue
        if merged and s <= merged[-1][1]:
            merged[-1] = (merged[-1][0], max(merged[-1][1], e))
        else:
            merged.append((s, e))
    return merged


def overlap(a: Sequence[Tuple[float, float]],
            b: Sequence[Tuple[float, float]]) -> float:
    """The length of the intersection of two lists of sorted, disjoint
    intervals."""
    i = j = 0
    total = 0.0
    while i < len(a) and j < len(b):
        s, e = max(a[i][0], b[j][0]), min(a[i][1], b[j][1])
        if e > s:
            total += e - s
        if a[i][1] < b[j][1]:
            i += 1
        else:
            j += 1
    return total


def idle_pct(summary, devices, names: Iterable[str]) -> Optional[float]:
    """Share of the window, in %, in which the card is idle while the
    host is inside a range of one of the spans ``names``, averaged over
    ``devices``; ``None`` where the trace holds no ``repro_torch/``
    range."""
    if not has_spans(summary):
        return None
    under = intervals(summary, names)
    idle = sum(overlap(summary.gaps(d), under) for d in devices)
    width = summary.window[1] - summary.window[0]
    return 100.0 * idle / len(devices) / width
