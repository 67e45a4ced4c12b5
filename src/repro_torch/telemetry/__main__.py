"""``python -m repro_torch.telemetry`` -- inspect exported traces.

    python -m repro_torch.telemetry summarize trace.json
    python -m repro_torch.telemetry validate  trace.jsonl

``summarize`` renders the per-phase breakdown (span type -> count,
total/mean/min/max ms), the counters, and the gauges of a trace written
by ``python -m repro_torch run --trace`` (or by the JAX package's
launcher: the schema is shared).  Both subcommands validate against
:mod:`repro_torch.telemetry.schema` first and exit 1 on a malformed
document.

Reads both export formats: Chrome trace-event JSON (``traceEvents``)
and the JSONL stream (one ``kind``-tagged object per line).
"""
from __future__ import annotations

import argparse
import json
import sys

from .schema import TelemetryError, validate_snapshot, validate_trace


def _load(path: str) -> dict:
    """Either format -> the Chrome-document shape ``{traceEvents,
    metrics?, meta?}`` (JSONL spans/instants are re-rendered as X/i
    events so downstream code has one shape)."""
    if not path.endswith(".jsonl"):
        with open(path) as f:
            return json.load(f)
    doc: dict = {"traceEvents": [], "displayTimeUnit": "ms"}
    with open(path) as f:
        for lineno, line in enumerate(f, 1):
            line = line.strip()
            if not line:
                continue
            try:
                obj = json.loads(line)
            except json.JSONDecodeError as e:
                raise TelemetryError(f"{path}:{lineno}: not JSON: {e}")
            kind = obj.pop("kind", None)
            if kind == "meta":
                doc["meta"] = obj
            elif kind == "metrics":
                doc["metrics"] = obj
            elif kind in ("span", "instant"):
                ev = {"name": obj["name"], "cat": "repro",
                      "ph": "X" if kind == "span" else "i",
                      "ts": obj["ts_us"], "pid": 0,
                      "tid": obj.get("tid", 0),
                      "args": dict(obj.get("args", {}),
                                   depth=obj.get("depth", 0))}
                if kind == "span":
                    ev["dur"] = obj["dur_us"]
                else:
                    ev["s"] = "t"
                doc["traceEvents"].append(ev)
            else:
                raise TelemetryError(
                    f"{path}:{lineno}: unknown kind {kind!r}")
    doc["traceEvents"].sort(key=lambda ev: ev["ts"])
    return doc


def _validate(doc: dict) -> None:
    validate_trace(doc)
    if "metrics" in doc:
        validate_snapshot(doc["metrics"], ctx="metrics")


def _fmt_ms(us: float) -> str:
    return f"{us / 1e3:10.3f}"


def summarize(doc: dict, out=None) -> None:
    out = out if out is not None else sys.stdout
    spans: dict = {}
    instants: dict = {}
    for ev in doc["traceEvents"]:
        if ev["ph"] == "X":
            durs = spans.setdefault(ev["name"], [])
            durs.append(ev["dur"])
        else:
            instants[ev["name"]] = instants.get(ev["name"], 0) + 1

    print("== spans ==", file=out)
    if spans:
        print(f"{'phase':<24}{'count':>7}{'total ms':>11}{'mean ms':>11}"
              f"{'min ms':>11}{'max ms':>11}", file=out)
        for name in sorted(spans, key=lambda n: -sum(spans[n])):
            d = spans[name]
            print(f"{name:<24}{len(d):>7}{_fmt_ms(sum(d))}"
                  f"{_fmt_ms(sum(d) / len(d))}{_fmt_ms(min(d))}"
                  f"{_fmt_ms(max(d))}", file=out)
    else:
        print("(no spans -- was tracing enabled?)", file=out)
    if instants:
        print("== instants ==", file=out)
        for name in sorted(instants):
            print(f"{name:<24}{instants[name]:>7}", file=out)

    metrics = doc.get("metrics")
    if metrics:
        if metrics.get("counters"):
            print("== counters ==", file=out)
            for name, v in sorted(metrics["counters"].items()):
                print(f"{name:<24}{v:>18}", file=out)
        if metrics.get("gauges"):
            print("== gauges ==", file=out)
            for name, v in sorted(metrics["gauges"].items()):
                print(f"{name:<24}{v:>18.6g}", file=out)
    meta = doc.get("meta")
    if meta:
        print("== meta ==", file=out)
        for k, v in sorted(meta.items()):
            print(f"{k:<24}{v}", file=out)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.telemetry",
        description="Inspect telemetry trace exports")
    sub = ap.add_subparsers(dest="cmd", required=True)
    for name, help_ in (("summarize", "validate + per-phase breakdown"),
                        ("validate", "schema check only (exit 0/1)")):
        p = sub.add_parser(name, help=help_)
        p.add_argument("trace", help="trace .json (Chrome) or .jsonl")
    args = ap.parse_args(argv)
    try:
        doc = _load(args.trace)
        _validate(doc)
    except (TelemetryError, OSError, KeyError,
            json.JSONDecodeError) as e:
        print(f"INVALID {args.trace}: {e}", file=sys.stderr)
        return 1
    if args.cmd == "summarize":
        summarize(doc)
    else:
        n = len(doc["traceEvents"])
        print(f"OK {args.trace}: {n} events, "
              f"{len({e['name'] for e in doc['traceEvents']})} span "
              f"types, metrics={'yes' if 'metrics' in doc else 'no'}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
