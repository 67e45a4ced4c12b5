"""Statistical perf gate: candidate perf record vs baseline + budgets
(counterpart of ``repro.perf.gate``; pure Python, the port's own copy).

* Per shared row, the baseline's recorded spread sets the tolerance:
  ``tol = clamp(noise_mult * IQR/median, rel_floor, rel_cap)``.  A
  candidate median outside ``[median/(1+tol), median*(1+tol)]`` is a
  statistically real change -- slower fails the gate, faster is flagged
  as a suspicious improvement (advisory: refresh the baseline so the
  gate keeps teeth against the new level).  Legacy baseline rows with
  no recorded spread fall back to ``legacy_rel_tol`` (a flat 25%).
* A budgets file adds absolute per-row flips/ns floors
  (``min_flips_per_ns``), so a slow regression that creeps in across
  several baseline refreshes still trips the gate.
* Baseline rows missing from an unfiltered candidate run fail (a bench
  silently dropped is a regression in coverage); a filtered run
  (``only``/``engines``/``spec_file`` in the candidate's meta, as
  ``python -m repro_torch.dist.weakscale --json`` writes) skips them.
  Candidate rows with no baseline (new engines) are advisory ``new`` --
  they need a baseline refresh, not a red build.

Gate the port's records against the port's own baselines, taken on the
card: the JAX package's committed records are CPU-interpreter rows.

CLI::

    python -m repro_torch.perf.gate BASELINE.json CANDIDATE.json \
        [--budgets BUDGETS.json] [--advisory] [--out gate.md]
    python -m repro_torch.perf.gate --init-budgets BUDGETS.json \
        BASELINE.json [--safety 0.4]

Exit 1 on a failing row (regression, missing, budget), else 0;
``--advisory`` reports and exits 0.
"""
from __future__ import annotations

import argparse
import json
import os
from dataclasses import asdict, dataclass, field
from typing import Dict, List, Optional, Tuple

@dataclass(frozen=True)
class GateConfig:
    """Noise-model knobs (persisted in a budgets file under "gate")."""

    #: tolerance = noise_mult * (baseline IQR / baseline median) ...
    noise_mult: float = 4.0
    #: ... floored (quiet rows still get slack for scheduler jitter) ...
    rel_floor: float = 0.10
    #: ... and capped (a wildly noisy baseline row must not disable
    #: the gate outright)
    rel_cap: float = 0.75
    #: tolerance for legacy baseline rows with no recorded spread --
    #: the old flat 25% threshold, now only a fallback
    legacy_rel_tol: float = 0.25

    @classmethod
    def from_dict(cls, d: dict) -> "GateConfig":
        known = {k: float(v) for k, v in d.items()
                 if k in cls.__dataclass_fields__}
        unknown = set(d) - set(known)
        if unknown:
            raise ValueError(f"unknown gate config keys {sorted(unknown)}")
        return cls(**known)


@dataclass
class RowVerdict:
    name: str
    status: str                 # ok|regression|improvement|missing|new|budget
    base_us: Optional[float] = None
    cand_us: Optional[float] = None
    ratio: Optional[float] = None   # cand/base median time (>1 = slower)
    tol: Optional[float] = None
    detail: str = ""

    @property
    def fails(self) -> bool:
        return self.status in ("regression", "missing", "budget")


@dataclass
class GateResult:
    baseline: str
    candidate: str
    filtered: bool
    rows: List[RowVerdict] = field(default_factory=list)

    def by_status(self, *statuses: str) -> List[RowVerdict]:
        return [r for r in self.rows if r.status in statuses]

    @property
    def failed(self) -> bool:
        return any(r.fails for r in self.rows)

    def to_markdown(self) -> str:
        out = [f"### Perf gate — {self.baseline} → {self.candidate}"
               + (" (filtered candidate: unselected baseline rows "
                  "skipped)" if self.filtered else ""), ""]
        out.append("| row | status | base us | cand us | ratio | tol |"
                   " detail |")
        out.append("|---|---|---|---|---|---|---|")

        def fmt(v, spec="{:.1f}"):
            return "-" if v is None else spec.format(v)

        order = {"regression": 0, "budget": 1, "missing": 2,
                 "improvement": 3, "new": 4, "ok": 5}
        for r in sorted(self.rows, key=lambda r: (order[r.status],
                                                  r.name)):
            mark = {"regression": "**REGRESSION**", "budget": "**BUDGET**",
                    "missing": "**MISSING**",
                    "improvement": "improvement?"}.get(r.status, r.status)
            out.append(f"| {r.name} | {mark} | {fmt(r.base_us)} |"
                       f" {fmt(r.cand_us)} | {fmt(r.ratio, '{:.3f}')} |"
                       f" {fmt(r.tol, '{:.3f}')} | {r.detail} |")
        n_fail = sum(r.fails for r in self.rows)
        n_imp = len(self.by_status("improvement"))
        out.append("")
        out.append(f"**{'FAIL' if self.failed else 'PASS'}** — "
                   f"{len(self.rows)} rows checked, {n_fail} failing, "
                   f"{n_imp} suspicious improvements"
                   + (" (refresh the baseline: EXPERIMENTS.md "
                      "S Perf-gate)" if n_imp else ""))
        return "\n".join(out)


def row_stats(row: dict) -> Tuple[float, Optional[float], int]:
    """(median_us, iqr_us or None, n_trials) tolerating both formats.

    Legacy rows (and single-trial rows, which record no IQR) return
    ``iqr=None`` -- the caller must fall back to ``legacy_rel_tol``,
    never treat the absence of spread as zero spread.
    """
    if "n_trials" in row:
        return (float(row["median_us_per_call"]),
                (float(row["iqr_us_per_call"])
                 if "iqr_us_per_call" in row else None),
                int(row["n_trials"]))
    return float(row["us_per_call"]), None, 1


def tolerance(base_row: dict, cfg: GateConfig) -> float:
    """Relative tolerance band for one baseline row."""
    median, iqr, _ = row_stats(base_row)
    if iqr is None or median <= 0.0:
        return cfg.legacy_rel_tol
    rel = iqr / median
    return min(max(cfg.noise_mult * rel, cfg.rel_floor), cfg.rel_cap)


def classify(ratio: float, tol: float) -> str:
    """'regression' | 'improvement' | 'ok' for a cand/base time ratio.

    The band is multiplicative-symmetric: ``[1/(1+tol), 1+tol]`` --
    so ``classify(r, t) == 'regression'`` iff ``classify(1/r, t) ==
    'improvement'`` (property-tested)."""
    if ratio > 1.0 + tol:
        return "regression"
    if ratio < 1.0 / (1.0 + tol):
        return "improvement"
    return "ok"


def throughput(row: dict) -> Tuple[Optional[str], Optional[float]]:
    d = row.get("derived", {})
    for key in ("replica_flips_per_ns", "flips_per_ns"):
        v = d.get(key)
        if isinstance(v, (int, float)) and v > 0:
            return key, float(v)
    return None, None


def _is_filtered(record: dict) -> bool:
    meta = record.get("meta", {})
    return bool(meta.get("only") or meta.get("engines")
                or meta.get("spec_file"))


def gate(baseline: dict, candidate: dict,
         budgets: Optional[dict] = None,
         cfg: Optional[GateConfig] = None) -> GateResult:
    """Compare two perf records (parsed JSON) under the noise model."""
    if cfg is None:
        cfg = GateConfig.from_dict((budgets or {}).get("gate", {}))
    base_rows = {r["name"]: r for r in baseline["rows"]}
    cand_rows = {r["name"]: r for r in candidate["rows"]}
    filtered = _is_filtered(candidate)
    res = GateResult(baseline=str(baseline.get("meta", {}).get("stamp")),
                     candidate=str(candidate.get("meta", {}).get("stamp")),
                     filtered=filtered)
    floors = (budgets or {}).get("rows", {})

    for name in sorted(set(base_rows) | set(cand_rows)):
        b, c = base_rows.get(name), cand_rows.get(name)
        if c is None:
            if not filtered:
                res.rows.append(RowVerdict(
                    name, "missing", base_us=row_stats(b)[0],
                    detail="baseline row absent from unfiltered "
                           "candidate run"))
            continue
        if b is None:
            res.rows.append(RowVerdict(
                name, "new", cand_us=row_stats(c)[0],
                detail="no baseline row (new engine/bench?) -- refresh "
                       "the baseline to start gating it"))
            continue
        b_med, _, _ = row_stats(b)
        c_med, _, _ = row_stats(c)
        tol = tolerance(b, cfg)
        if b_med <= 0.0:
            res.rows.append(RowVerdict(name, "ok", b_med, c_med,
                                       detail="untimed row"))
            continue
        ratio = c_med / b_med
        status = classify(ratio, tol)
        detail = ""
        if status == "regression":
            detail = (f"median {ratio:+.1%} vs baseline, outside the "
                      f"±{tol:.0%} noise band")
        elif status == "improvement":
            detail = (f"median {ratio - 1.0:+.1%} -- faster than the "
                      f"noise band; real win or broken bench?")
        res.rows.append(RowVerdict(name, status, b_med, c_med,
                                   ratio=ratio, tol=tol, detail=detail))

    # absolute throughput floors (survive baseline refreshes)
    for name, budget in sorted(floors.items()):
        c = cand_rows.get(name)
        if c is None:
            continue
        floor = budget.get("min_flips_per_ns")
        if floor is None:
            continue
        key, measured = throughput(c)
        if measured is None:
            res.rows.append(RowVerdict(
                name, "budget", detail="budget row carries no "
                "flips/ns metric in candidate"))
        elif measured < float(floor):
            res.rows.append(RowVerdict(
                name, "budget",
                detail=f"{key}={measured:.4g} below budget floor "
                       f"{floor:.4g}"))
    return res


# ---------------------------------------------------------------------------
# budgets file
# ---------------------------------------------------------------------------

def load_budgets(path: str) -> dict:
    with open(path) as f:
        budgets = json.load(f)
    extra = set(budgets) - {"gate", "rows"}
    if extra:
        raise ValueError(f"budgets {path}: unknown keys {sorted(extra)}")
    GateConfig.from_dict(budgets.get("gate", {}))  # validate
    return budgets


def dump_budgets(budgets: dict, path: str) -> str:
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path, "w") as f:
        json.dump(budgets, f, indent=1, sort_keys=True)
        f.write("\n")
    return path


def make_budgets(baseline: dict, safety: float = 0.4,
                 cfg: Optional[GateConfig] = None) -> dict:
    """Budgets from a baseline record: per-row flips/ns floors at
    ``safety`` x the measured value (generous on purpose -- the floor
    catches slow multi-refresh creep, the noise band catches per-PR
    regressions), plus the gate config so CI and dev runs share one
    noise model."""
    cfg = cfg or GateConfig()
    rows = {}
    for row in baseline["rows"]:
        _, measured = throughput(row)
        if measured is not None:
            rows[row["name"]] = {
                "min_flips_per_ns": float(f"{measured * safety:.4g}")}
    return {"gate": asdict(cfg), "rows": rows}


# ---------------------------------------------------------------------------
# CLI
# ---------------------------------------------------------------------------

def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.perf.gate", description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("baseline", help="baseline perf record (JSON)")
    ap.add_argument("candidate", nargs="?", default=None,
                    help="candidate perf record (omit with "
                         "--init-budgets)")
    ap.add_argument("--budgets", default=None,
                    help="budgets file (from --init-budgets)")
    ap.add_argument("--advisory", action="store_true",
                    help="report but exit 0 -- the escape hatch for "
                         "intentional perf changes pending a baseline "
                         "refresh")
    ap.add_argument("--out", default=None,
                    help="also write the markdown report here")
    ap.add_argument("--init-budgets", default=None, metavar="PATH",
                    help="write a budgets file derived from BASELINE "
                         "and exit")
    ap.add_argument("--safety", type=float, default=0.4,
                    help="--init-budgets floor = safety * measured "
                         "flips/ns (default 0.4)")
    args = ap.parse_args(argv)

    with open(args.baseline) as f:
        baseline = json.load(f)

    if args.init_budgets:
        budgets = make_budgets(baseline, safety=args.safety)
        path = dump_budgets(budgets, args.init_budgets)
        print(f"# wrote {path}: {len(budgets['rows'])} row floors at "
              f"{args.safety}x baseline")
        return 0

    if args.candidate is None:
        ap.error("candidate record required (or use --init-budgets)")
    with open(args.candidate) as f:
        candidate = json.load(f)
    budgets = load_budgets(args.budgets) if args.budgets else None

    result = gate(baseline, candidate, budgets=budgets)
    report = result.to_markdown()
    print(report)
    if args.out:
        os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
        with open(args.out, "w") as f:
            f.write(report + "\n")
    if result.failed and args.advisory:
        print("\n(advisory mode: failures reported, exit 0)")
        return 0
    return 1 if result.failed else 0


if __name__ == "__main__":
    raise SystemExit(main())
