"""RunRecorder: results in the EXPERIMENTS.md CSV schema, plus JSON.

Counterpart of ``repro.analysis.recorder``, with the same CSV header,
row format and JSON layout, so that a record of either package reads as
the other's.  One row per measurement: ``name,us_per_call,derived``
where ``derived`` is ``;``-separated ``key=value`` pairs.  The figure
(``repro_torch.analysis.figures``) and ``python -m repro_torch run
--record`` write through it: rows can be echoed to stdout as they
arrive, written to a ``.csv``, and dumped as a JSON record.
"""
from __future__ import annotations

import json
import os
import time
from typing import Dict, List, Optional, Sequence

HEADER = "name,us_per_call,derived"


def _percentile(sorted_vals: Sequence[float], q: float) -> float:
    """Linear-interpolation percentile of an already-sorted sequence."""
    n = len(sorted_vals)
    if n == 1:
        return float(sorted_vals[0])
    pos = q * (n - 1)
    lo = int(pos)
    hi = min(lo + 1, n - 1)
    frac = pos - lo
    return float(sorted_vals[lo] * (1.0 - frac) + sorted_vals[hi] * frac)


def timing_stats(times_us: Sequence[float]) -> Dict[str, object]:
    """``n_trials`` / ``median_us_per_call`` / ``iqr_us_per_call`` from
    per-trial wall-clock samples (microseconds).

    A single trial records ``n_trials=1`` with NO iqr field -- one
    sample says nothing about spread, and consumers (the perf gate)
    must fall back to their legacy tolerance rather than read a
    zero-IQR row as perfectly stable.
    """
    ts = sorted(float(t) for t in times_us)
    if not ts:
        return {}
    out: Dict[str, object] = {"n_trials": len(ts),
                              "median_us_per_call": _percentile(ts, 0.5)}
    if len(ts) >= 2:
        out["iqr_us_per_call"] = (_percentile(ts, 0.75)
                                  - _percentile(ts, 0.25))
    return out


def _fmt(v) -> str:
    if isinstance(v, float):
        return f"{v:.6g}"
    return str(v)


def parse_derived(derived: str) -> Dict[str, object]:
    """'k1=v1;k2=v2' -> dict, floating values parsed where possible."""
    out: Dict[str, object] = {}
    for part in derived.split(";"):
        if not part or "=" not in part:
            continue
        k, v = part.split("=", 1)
        try:
            out[k] = float(v)
        except ValueError:
            out[k] = v
    return out


class RunRecorder:
    """Accumulates ``(name, us_per_call, derived)`` rows."""

    def __init__(self, echo: bool = False, meta: Optional[dict] = None):
        self.rows: List[dict] = []
        self.echo = echo
        self.meta = dict(meta or {})
        if echo:
            print(HEADER)

    def record(self, name: str, us_per_call: float = 0.0,
               spec: Optional[str] = None,
               times_us: Optional[Sequence[float]] = None,
               **derived) -> dict:
        """One row; ``spec`` (a serialized ``RunSpec`` JSON string)
        rides along in the JSON record -- not the CSV -- so a row is
        replayable with ``python -m repro_torch run`` from the record
        alone.  ``times_us`` (per-trial wall-clock samples) adds the
        noise-model fields ``n_trials`` / ``median_us_per_call`` /
        ``iqr_us_per_call``; rows without it stay in the single-number
        format, which every consumer tolerates."""
        row = {"name": name, "us_per_call": float(us_per_call),
               "derived": {k: v for k, v in derived.items()}}
        if times_us is not None:
            row.update(timing_stats(times_us))
        if spec is not None:
            row["spec"] = spec
        self.rows.append(row)
        if self.echo:
            print(self.format_row(row))
        return row

    @staticmethod
    def format_row(row: dict) -> str:
        derived = ";".join(f"{k}={_fmt(v)}"
                           for k, v in row["derived"].items())
        return f"{row['name']},{row['us_per_call']:.1f},{derived}"

    def write_csv(self, path: str) -> str:
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        with open(path, "w") as f:
            f.write(HEADER + "\n")
            for row in self.rows:
                f.write(self.format_row(row) + "\n")
        return path

    def write_json(self, path: str) -> str:
        """Full record (meta + rows) as JSON.  Any path not ending in
        ``.json`` is treated as a directory (created if missing) and
        gets a ``BENCH_<stamp>.json`` filename, the perf-record
        convention -- so ``--json results`` works in a fresh checkout."""
        if not path.endswith(".json"):
            stamp = self.meta.get("stamp") or time.strftime(
                "%Y%m%d_%H%M%S")
            path = os.path.join(path, f"BENCH_{stamp}.json")
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        with open(path, "w") as f:
            json.dump({"meta": self.meta, "rows": self.rows}, f,
                      indent=1, sort_keys=True)
        return path
