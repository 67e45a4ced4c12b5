"""Reading the device trace of a traced run's window.

The window runs under ``torch.profiler`` with the CPU and CUDA
activities, inside a ``record_function`` range named :data:`WINDOW`;
the trace is exported in the Chrome trace format and read back here.
A device operation is an event of category ``kernel``, ``gpu_memcpy``
or ``gpu_memset``, on the card its ``args.device`` names; times are
microseconds.

The sweep kernels are the kernels that PyTorch does not provide: every
``kernel`` event whose name names none of PyTorch's own kernel
namespaces (:data:`LIBRARY_MARKS`).  The port's sweeps are its only
hand-written kernels on the paths the cells drive; the rule keeps
working where a kernel is renamed, split or rewritten, and counts a
hand-written kernel that is not a sweep as one (``PERF.md`` says so).
"""
from __future__ import annotations

import dataclasses
import json
from bisect import bisect_right
from typing import Dict, Iterable, List, Optional, Tuple

WINDOW = "bench.window"
KERNEL_CATS = {"kernel"}
COPY_CATS = {"gpu_memcpy", "gpu_memset"}
HOST_CATS = {"cpu_op", "cuda_runtime", "cuda_driver", "python_function",
             "user_annotation"}
#: name fragments of kernels that come with PyTorch (ATen, its CUB and
#: cuBLAS/CUTLASS products, Triton code it generates)
LIBRARY_MARKS = ("at::", "cub::", "cutlass", "gemm", "cublas", "triton_")
NAME_CHARS = 120


@dataclasses.dataclass(frozen=True)
class Op:
    device: int
    name: str
    cat: str
    start: float
    end: float

    @property
    def sweep(self) -> bool:
        return self.cat in KERNEL_CATS and is_sweep_kernel(self.name)


def is_sweep_kernel(name: str) -> bool:
    return not any(mark in name for mark in LIBRARY_MARKS)


def load(path) -> List[dict]:
    with open(path) as f:
        doc = json.load(f)
    return doc["traceEvents"] if isinstance(doc, dict) else doc


@dataclasses.dataclass
class Summary:
    """The window's device work, by card."""

    window: Tuple[float, float]
    devices: Tuple[int, ...]
    ops: Dict[int, List[Op]]
    host: List[Tuple[float, float, str]]

    @property
    def window_s(self) -> float:
        return (self.window[1] - self.window[0]) * 1e-6

    def busy_s(self, device: int) -> float:
        """Seconds of the window in which some operation ran on the
        card."""
        t0, t1 = self.window
        total, cur_s, cur_e = 0.0, None, None
        for op in self.ops.get(device, []):
            s, e = max(op.start, t0), min(op.end, t1)
            if e <= s:
                continue
            if cur_e is None or s > cur_e:
                if cur_e is not None:
                    total += cur_e - cur_s
                cur_s, cur_e = s, e
            else:
                cur_e = max(cur_e, e)
        if cur_e is not None:
            total += cur_e - cur_s
        return total * 1e-6

    def mean_busy_s(self) -> float:
        return sum(self.busy_s(d) for d in self.devices) / len(self.devices)

    def op_seconds(self, device: int, sweep: Optional[bool] = None) -> float:
        """Summed durations of the card's operations (``sweep``: only
        the sweep kernels, or only the others)."""
        return sum(op.end - op.start for op in self.ops.get(device, [])
                   if sweep is None or op.sweep == sweep) * 1e-6

    def count(self) -> int:
        return sum(len(v) for v in self.ops.values())

    def top_ops(self, n: int = 10) -> List[list]:
        by: Dict[str, float] = {}
        for ops in self.ops.values():
            for op in ops:
                key = op.name[:NAME_CHARS]
                by[key] = by.get(key, 0.0) + (op.end - op.start) * 1e-6
        return [[k, v] for k, v in sorted(by.items(), key=lambda kv: -kv[1])
                [:n]]

    def gaps(self, device: int) -> List[Tuple[float, float]]:
        """Idle intervals of the card inside the window."""
        t0, t1 = self.window
        out, cursor = [], t0
        for op in self.ops.get(device, []):
            if op.start > cursor:
                out.append((cursor, min(op.start, t1)))
            cursor = max(cursor, op.end)
            if cursor >= t1:
                break
        if cursor < t1:
            out.append((cursor, t1))
        return [(s, e) for s, e in out if e > s]

    def host_at(self, t: float) -> str:
        """The innermost host event running at ``t``."""
        starts = [h[0] for h in self.host]
        i = bisect_right(starts, t)
        best = None
        for s, e, name in reversed(self.host[max(0, i - 4096):i]):
            if e >= t and (best is None or e - s < best[1] - best[0]):
                best = (s, e, name)
        return best[2][:NAME_CHARS] if best else "host: no traced event"

    def top_gaps(self, n: int = 10) -> List[list]:
        gaps = [(e - s, s, e) for d in self.devices for s, e in self.gaps(d)]
        gaps.sort(reverse=True)
        return [[self.host_at((s + e) / 2), length * 1e-6]
                for length, s, e in gaps[:n]]

    def breakdown(self) -> dict:
        return {"device_ops": self.top_ops(), "idle_gaps": self.top_gaps()}


def summarize(events: Iterable[dict], devices: Iterable[int]) -> Summary:
    """The window's device operations of ``devices``, sorted by start,
    and its host events."""
    events = [e for e in events if e.get("ph") == "X"]
    marks = [e for e in events if e.get("name") == WINDOW
             and str(e.get("cat", "")).lower() in ("user_annotation",
                                                  "cpu_op")]
    if not marks:
        raise ValueError(f"the trace has no {WINDOW!r} range")
    w = marks[0]
    window = (float(w["ts"]), float(w["ts"]) + float(w["dur"]))
    devices = tuple(devices)
    ops: Dict[int, List[Op]] = {d: [] for d in devices}
    host = []
    for e in events:
        cat = str(e.get("cat", "")).lower()
        ts, dur = float(e.get("ts", 0.0)), float(e.get("dur", 0.0))
        if cat in KERNEL_CATS or cat in COPY_CATS:
            d = (e.get("args") or {}).get("device")
            if d in ops and ts + dur > window[0] and ts < window[1]:
                ops[d].append(Op(d, str(e.get("name", "")), cat, ts,
                                 ts + dur))
        elif cat in HOST_CATS and e is not w:
            host.append((ts, ts + dur, str(e.get("name", ""))))
    for v in ops.values():
        v.sort(key=lambda op: op.start)
    host.sort()
    return Summary(window, devices, ops, host)
