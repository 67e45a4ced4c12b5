"""The port's perf gate (``repro_torch.perf.gate``) against the JAX
package's: the same verdicts, report, exit codes and budgets files on
every committed ``benchmarks/BENCH_*.json`` pair (read as data) and on
synthetic records with injected regressions, improvements, missing, new,
untimed and legacy rows and budget floors; and the JAX property suite
run against the port."""
import dataclasses
import glob
import json
import os
import subprocess
import sys

import numpy as np
import pytest

import repro.perf.gate as jgate
import repro_torch.perf.gate as pgate

sys.path.insert(0, os.path.dirname(__file__))
from _hypothesis_compat import given, settings, st  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BENCH = sorted(glob.glob(os.path.join(REPO, "benchmarks", "BENCH_*.json")))
BUDGETS = os.path.join(REPO, "benchmarks", "budgets.json")


def _load(path):
    with open(path) as f:
        return json.load(f)


def _row(name, median, iqr=None, n=5, flips=None, legacy=False):
    derived = {} if flips is None else {"flips_per_ns": flips}
    if legacy:
        return {"name": name, "us_per_call": median, "derived": derived}
    row = {"name": name, "us_per_call": median, "derived": derived,
           "n_trials": n, "median_us_per_call": median}
    if n >= 2:
        row["iqr_us_per_call"] = median * 0.02 if iqr is None else iqr
    return row


def _record(rows, **meta):
    m = {"stamp": "20260807_000000", "backend": "cpu",
         "device_count": 1, "only": "", "engines": ""}
    m.update(meta)
    return {"meta": m, "rows": rows}


def _base():
    return _record([
        _row("t1_a", 100.0, iqr=2.0, flips=10.0),
        _row("t1_b", 50.0, iqr=1.0, flips=4.0),
        _row("t1_legacy", 200.0, legacy=True, flips=1.0),
        _row("t1_single", 80.0, n=1, flips=2.0),
    ])


def _scenario(kind, seed):
    """(baseline, candidate, budgets) of one synthetic case; ``seed``
    draws the injected factors."""
    r = np.random.default_rng(seed)
    base, cand, budgets = _base(), _base(), None
    rows = cand["rows"]
    if kind == "regression":
        f = float(r.uniform(1.2, 4.0))
        rows[0]["median_us_per_call"] *= f
        rows[0]["us_per_call"] *= f
    elif kind == "improvement":
        rows[1]["median_us_per_call"] /= float(r.uniform(1.2, 4.0))
    elif kind == "noise":
        for row in rows[:2]:
            row["median_us_per_call"] *= float(r.uniform(0.95, 1.05))
    elif kind == "legacy":
        rows[2]["us_per_call"] *= float(r.uniform(1.0, 1.5))
    elif kind == "missing":
        del rows[int(r.integers(0, len(rows)))]
    elif kind == "filtered":
        del rows[int(r.integers(0, len(rows)))]
        cand["meta"]["only"] = "t1"
    elif kind == "spec_file":
        del rows[0]
        cand["meta"]["spec_file"] = "spec.json"
    elif kind == "new":
        rows.append(_row("t1_new", 10.0, flips=float(r.uniform(1, 99))))
    elif kind == "untimed":
        for rec in (base, cand):
            rec["rows"].append({"name": "untimed", "us_per_call": 0.0,
                                "derived": {}})
    elif kind == "budget":
        budgets = jgate.make_budgets(base, safety=float(r.uniform(0.3, 0.9)))
        rows[0]["derived"]["flips_per_ns"] = float(r.uniform(0.5, 5.0))
    elif kind == "budget_no_metric":
        budgets = {"rows": {"t1_a": {"min_flips_per_ns": 1.0}}}
        del rows[0]["derived"]["flips_per_ns"]
    elif kind == "replica_metric":
        rows[1]["derived"]["replica_flips_per_ns"] = 64.0
        budgets = {"rows": {"t1_b": {"min_flips_per_ns": 100.0}}}
    elif kind == "gate_config":
        rows[0]["median_us_per_call"] = 300.0
        budgets = {"gate": {"noise_mult": 100.0, "rel_cap": 5.0},
                   "rows": {}}
    return base, cand, budgets


SCENARIOS = ("regression", "improvement", "noise", "legacy", "missing",
             "filtered", "spec_file", "new", "untimed", "budget",
             "budget_no_metric", "replica_metric", "gate_config")


def _same_result(base, cand, budgets):
    j = jgate.gate(base, cand, budgets=budgets)
    p = pgate.gate(base, cand, budgets=budgets)
    assert [dataclasses.asdict(v) for v in p.rows] == \
        [dataclasses.asdict(v) for v in j.rows]
    assert (p.baseline, p.candidate, p.filtered, p.failed) == \
        (j.baseline, j.candidate, j.filtered, j.failed)
    assert p.to_markdown() == j.to_markdown()
    return p


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("kind", SCENARIOS)
def test_synthetic_records_give_jax_verdicts_and_report(kind, seed):
    res = _same_result(*_scenario(kind, seed))
    if kind in ("missing", "budget_no_metric", "replica_metric"):
        assert res.failed


@pytest.mark.parametrize("use_budgets", [False, True])
@pytest.mark.parametrize("cand_path", BENCH, ids=os.path.basename)
@pytest.mark.parametrize("base_path", BENCH, ids=os.path.basename)
def test_committed_records_give_jax_verdicts_and_report(base_path,
                                                        cand_path,
                                                        use_budgets):
    budgets = pgate.load_budgets(BUDGETS) if use_budgets else None
    assert budgets == (jgate.load_budgets(BUDGETS) if use_budgets
                       else None)
    _same_result(_load(base_path), _load(cand_path), budgets)


def _write(tmp_path, name, record):
    p = tmp_path / name
    p.write_text(json.dumps(record))
    return str(p)


@pytest.mark.parametrize("advisory", [False, True])
@pytest.mark.parametrize("kind", SCENARIOS)
def test_cli_exit_codes_and_reports_equal_jax(tmp_path, capsys, kind,
                                              advisory):
    base, cand, budgets = _scenario(kind, 7)
    args = [_write(tmp_path, "base.json", base),
            _write(tmp_path, "cand.json", cand)]
    if budgets is not None:
        args += ["--budgets", _write(tmp_path, "budgets.json", budgets)]
    if advisory:
        args.append("--advisory")
    out = {}
    for name, mod in (("jax", jgate), ("port", pgate)):
        md = str(tmp_path / f"{name}.md")
        code = mod.main(args + ["--out", md])
        out[name] = (code, capsys.readouterr().out, open(md).read())
    assert out["port"] == out["jax"]
    assert out["port"][0] == (0 if advisory else
                              int(pgate.gate(base, cand, budgets).failed))


@pytest.mark.parametrize("safety", [0.4, 0.5, 2.0])
@pytest.mark.parametrize("path", BENCH + [None],
                         ids=lambda p: os.path.basename(p or "synthetic"))
def test_cli_init_budgets_files_equal_jax(tmp_path, capsys, path, safety):
    path = path or _write(tmp_path, "base.json", _base())
    files = {}
    for name, mod in (("jax", jgate), ("port", pgate)):
        out = str(tmp_path / name / "budgets.json")
        assert mod.main(["--init-budgets", out, path, "--safety",
                         str(safety)]) == 0
        files[name] = open(out).read()
    assert files["port"] == files["jax"]
    outs = capsys.readouterr().out.splitlines()
    assert outs[0].replace("jax", "port") == outs[1]


def test_self_gate_with_own_budgets_then_above_measured_fails(tmp_path):
    """What ``chip_smoke.py`` phase 12 asserts on the card's records:
    exit 0 against itself with ``--init-budgets``' floors; 1 with floors
    at twice the measured rates, every throughput row ``budget``; 0
    under ``--advisory``."""
    rec = _write(tmp_path, "rec.json", _base())
    low, high = str(tmp_path / "low.json"), str(tmp_path / "high.json")
    assert pgate.main(["--init-budgets", low, rec]) == 0
    assert pgate.main([rec, rec, "--budgets", low]) == 0
    assert pgate.main(["--init-budgets", high, rec, "--safety", "2.0"]) == 0
    assert pgate.main([rec, rec, "--budgets", high]) == 1
    res = pgate.gate(_base(), _base(), pgate.load_budgets(high))
    assert sorted(v.name for v in res.by_status("budget")) == \
        sorted(r["name"] for r in _base()["rows"])
    assert pgate.main([rec, rec, "--budgets", high, "--advisory"]) == 0


def test_cli_requires_a_candidate(tmp_path):
    rec = _write(tmp_path, "rec.json", _base())
    with pytest.raises(SystemExit):
        pgate.main([rec])


def test_module_runs_without_runpy_warning(tmp_path):
    rec = _write(tmp_path, "rec.json", _base())
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"))
    proc = subprocess.run(
        [sys.executable, "-W", "error::RuntimeWarning", "-m",
         "repro_torch.perf.gate", rec, rec], capture_output=True,
        text=True, env=env, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert "**PASS**" in proc.stdout and "Warning" not in proc.stderr
    assert "benchmarks" not in subprocess.run(
        [sys.executable, "-m", "repro_torch.perf.gate", "--help"],
        capture_output=True, text=True, env=env, timeout=120).stdout


def test_gate_module_imports_from_the_package():
    """``from repro_torch.perf import gate`` names the module (the JAX
    package's lazy re-export recurses there; the port's does not)."""
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"))
    proc = subprocess.run(
        [sys.executable, "-c", "from repro_torch.perf import gate; "
         "print(gate.__name__, callable(gate.gate))"],
        capture_output=True, text=True, env=env, timeout=120)
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert proc.stdout.split() == ["repro_torch.perf.gate", "True"]


def test_lazy_reexports():
    import repro_torch.perf as perf
    assert perf.GateConfig is pgate.GateConfig
    assert perf.classify is pgate.classify
    from repro_torch.perf import schema
    assert perf.validate_record is schema.validate_record
    with pytest.raises(AttributeError):
        perf.not_a_name


# ---------------------------------------------------------------------------
# the JAX property suite, against the port
# ---------------------------------------------------------------------------

@settings(max_examples=60)
@given(rel=st.floats(min_value=0.0, max_value=2.0),
       floor=st.floats(min_value=0.01, max_value=0.5))
def test_tolerance_monotone_and_clamped(rel, floor):
    cfg = pgate.GateConfig(noise_mult=4.0, rel_floor=floor, rel_cap=0.75)
    base = _row("x", 100.0, iqr=100.0 * rel)
    tol = pgate.tolerance(base, cfg)
    assert floor <= tol <= max(0.75, floor)
    # monotone in the relative spread
    wider = pgate.tolerance(_row("x", 100.0, iqr=100.0 * (rel + 0.1)), cfg)
    assert wider >= tol
    assert tol == jgate.tolerance(base, jgate.GateConfig(
        noise_mult=4.0, rel_floor=floor, rel_cap=0.75))


@settings(max_examples=60)
@given(ratio=st.floats(min_value=0.05, max_value=20.0),
       tol=st.floats(min_value=0.01, max_value=0.75))
def test_classify_band_is_multiplicatively_symmetric(ratio, tol):
    a, b = pgate.classify(ratio, tol), pgate.classify(1.0 / ratio, tol)
    flip = {"regression": "improvement", "improvement": "regression",
            "ok": "ok"}
    assert b == flip[a]
    assert a == jgate.classify(ratio, tol)


@settings(max_examples=40)
@given(median=st.floats(min_value=1.0, max_value=1e6),
       n=st.integers(min_value=2, max_value=50),
       safety=st.floats(min_value=0.1, max_value=0.9))
def test_make_budgets_round_trips_and_floors_below_measured(
        median, n, safety):
    import tempfile
    flips = 1e3 / median
    base = _record([_row("t1_p", median, n=n, flips=flips)])
    budgets = pgate.make_budgets(base, safety=safety)
    floor = budgets["rows"]["t1_p"]["min_flips_per_ns"]
    assert floor <= flips            # the floor never exceeds measured
    assert budgets == jgate.make_budgets(base, safety=safety)
    with tempfile.TemporaryDirectory() as tmp:
        path = pgate.dump_budgets(budgets, os.path.join(tmp, "b.json"))
        assert pgate.load_budgets(path) == budgets
    # the baseline itself always passes its own budgets
    assert not pgate.gate(base, base, budgets=budgets).failed
