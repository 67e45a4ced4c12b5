"""Schema of the JSON perf records (EXPERIMENTS.md S Bench).

Counterpart of ``repro.perf.schema`` as far as ``python -m repro_torch
run --record`` needs it: :func:`validate_record` and
:func:`validate_row`, which accept and reject the same records as the
JAX package's.  Two row formats are valid:

* single-number: ``{"name", "us_per_call", "derived"}``;
* noise-model rows additionally carry ``n_trials`` (>= 1) and
  ``median_us_per_call``, plus ``iqr_us_per_call`` when ``n_trials >=
  2`` -- a single trial must NOT record an IQR (one sample says nothing
  about spread; recording 0 would read as "perfectly stable").

A row's ``spec`` must parse back as a ``repro_torch.api.RunSpec``.
"""
from __future__ import annotations

import json
import math
from typing import Dict

#: meta keys every record must carry (run provenance)
REQUIRED_META = ("stamp", "backend", "device_count")

#: the full set of keys a row may carry
ROW_KEYS = frozenset({"name", "us_per_call", "derived", "spec",
                      "n_trials", "median_us_per_call",
                      "iqr_us_per_call"})

#: derived keys that, when present, must be finite non-negative numbers
#: (they are rates/percentages -- a negative one is always a harness bug)
NONNEG_DERIVED = ("flips_per_ns", "replica_flips_per_ns",
                  "pct_of_roofline", "dispatches", "us_per_sample")


class SchemaError(ValueError):
    """A BENCH record violates the perf-record schema."""


def _fail(ctx: str, msg: str) -> None:
    raise SchemaError(f"{ctx}: {msg}")


def _check_num(ctx: str, key: str, v, *, nonneg: bool = True) -> float:
    if isinstance(v, bool) or not isinstance(v, (int, float)):
        _fail(ctx, f"{key} must be a number, got {type(v).__name__}")
    f = float(v)
    if not math.isfinite(f):
        _fail(ctx, f"{key} must be finite, got {v!r}")
    if nonneg and f < 0:
        _fail(ctx, f"{key} must be >= 0, got {v!r}")
    return f


def validate_row(row: dict, ctx: str = "row") -> None:
    """Raise :class:`SchemaError` unless ``row`` is a valid perf row."""
    if not isinstance(row, dict):
        _fail(ctx, f"row must be a dict, got {type(row).__name__}")
    name = row.get("name")
    if not isinstance(name, str) or not name:
        _fail(ctx, f"name must be a non-empty string, got {name!r}")
    ctx = f"{ctx} {name!r}"
    extra = set(row) - ROW_KEYS
    if extra:
        _fail(ctx, f"unknown row keys {sorted(extra)}")
    for req in ("us_per_call", "derived"):
        if req not in row:
            _fail(ctx, f"missing required key {req!r}")
    _check_num(ctx, "us_per_call", row["us_per_call"])
    derived = row["derived"]
    if not isinstance(derived, dict):
        _fail(ctx, "derived must be a dict")
    for k, v in derived.items():
        if not isinstance(k, str):
            _fail(ctx, f"derived key {k!r} must be a string")
        if not isinstance(v, (str, int, float)) or isinstance(v, bool):
            _fail(ctx, f"derived[{k!r}] must be str or number")
        if k in NONNEG_DERIVED:
            _check_num(ctx, f"derived[{k!r}]", v)
    # noise-model fields: all-or-nothing, and IQR only with n >= 2
    if "n_trials" in row:
        n = row["n_trials"]
        if isinstance(n, bool) or not isinstance(n, int) or n < 1:
            _fail(ctx, f"n_trials must be an int >= 1, got {n!r}")
        if "median_us_per_call" not in row:
            _fail(ctx, "n_trials without median_us_per_call")
        _check_num(ctx, "median_us_per_call", row["median_us_per_call"])
        if n >= 2:
            if "iqr_us_per_call" not in row:
                _fail(ctx, f"n_trials={n} requires iqr_us_per_call")
            _check_num(ctx, "iqr_us_per_call", row["iqr_us_per_call"])
        elif "iqr_us_per_call" in row:
            _fail(ctx, "iqr_us_per_call recorded from a single trial")
    else:
        for k in ("median_us_per_call", "iqr_us_per_call"):
            if k in row:
                _fail(ctx, f"{k} without n_trials")
    if "spec" in row:
        spec = row["spec"]
        if not isinstance(spec, str):
            _fail(ctx, "spec must be a JSON string")
        try:
            parsed = json.loads(spec)
        except json.JSONDecodeError as e:
            _fail(ctx, f"spec is not valid JSON: {e}")
        if not isinstance(parsed, dict):
            _fail(ctx, "spec JSON must be an object")
        # a recorded spec that does not parse back is an unreplayable
        # perf number
        from repro_torch.api import RunSpec
        try:
            RunSpec.from_json(spec)
        except Exception as e:
            _fail(ctx, f"spec does not parse as a RunSpec: {e}")


def validate_record(record: dict, ctx: str = "record") -> None:
    """Raise :class:`SchemaError` unless ``record`` is a valid perf
    record (meta + non-empty uniquely-named rows)."""
    if not isinstance(record, dict):
        _fail(ctx, f"record must be a dict, got {type(record).__name__}")
    extra = set(record) - {"meta", "rows"}
    if extra:
        _fail(ctx, f"unknown top-level keys {sorted(extra)}")
    meta = record.get("meta")
    if not isinstance(meta, dict):
        _fail(ctx, "missing/invalid meta")
    for k in REQUIRED_META:
        if k not in meta:
            _fail(ctx, f"meta missing {k!r}")
    rows = record.get("rows")
    if not isinstance(rows, list) or not rows:
        _fail(ctx, "rows must be a non-empty list")
    seen: Dict[str, int] = {}
    for i, row in enumerate(rows):
        validate_row(row, ctx=f"{ctx} rows[{i}]")
        name = row["name"]
        if name in seen:
            _fail(ctx, f"duplicate row name {name!r} "
                       f"(rows {seen[name]} and {i})")
        seen[name] = i
