"""The port's telemetry (``repro_torch.telemetry``) against the JAX
package's, on the CPU.

The behaviours of ``tests/test_telemetry.py`` on the port: metrics
primitives, span nesting and fencing, both export formats, the schema
validators (the JAX package's golden trace, the violation catalogue,
property round-trips), the summarize/validate CLI, the counter
semantics of every engine family and the traced CLI run.  Against the
JAX package: the six canonical counters of the same spec through both
``Session``s are equal (single mode for every engine, ``measure()``, a
``BatchSpec``, meshes on both sharded tiers, in process on 1 x 1 meshes
and on 2 x 2 with four JAX host devices in a subprocess), and the port's
trace validates under ``repro.telemetry.validate_trace``.
"""
import io
import json
import os
import subprocess
import sys

import pytest

import repro.telemetry as jtel
import repro_torch.telemetry as tel
from _hypothesis_compat import given, settings, st
from repro_torch.api import (BatchSpec, EngineSpec, LatticeSpec, MeshSpec,
                             RunSpec, Session, SweepSpec, describe)
from repro_torch.kernels.resident import decision_attrs
from repro_torch.telemetry import trace as trace_mod
from repro_torch.telemetry.__main__ import _load, main as telemetry_cli
from repro_torch.telemetry.metrics import MetricsRegistry, diff_counters
from repro_torch.telemetry.schema import (TelemetryError, validate_event,
                                          validate_snapshot, validate_trace)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GOLDEN = os.path.join(REPO, "tests", "data", "trace_golden.json")
CANONICAL = ("dispatches", "sweeps", "spin_flips", "philox_draws",
             "halo_exchanges", "halo_bytes")


@pytest.fixture
def traced():
    """Tracing on with a clean event list; always off again afterwards."""
    tel.TRACER.clear()
    tel.enable()
    yield tel.TRACER
    tel.disable()
    tel.TRACER.clear()


def _counters():
    return tel.REGISTRY.snapshot()


def _canonical(d: dict) -> dict:
    return {k: d.get(k, 0) for k in CANONICAL}


# ---------------------------------------------------------------------------
# metrics primitives
# ---------------------------------------------------------------------------


def test_counter_monotone_and_rejects_negative():
    reg = MetricsRegistry()
    c = reg.counter("c")
    c.inc()
    c.inc(41)
    assert c.value == 42
    with pytest.raises(ValueError):
        c.inc(-1)
    assert c.value == 42


def test_gauge_set_and_rejects_nonfinite():
    reg = MetricsRegistry()
    g = reg.gauge("g")
    assert g.value is None
    g.set(2.5)
    assert g.value == 2.5
    for bad in (float("nan"), float("inf")):
        with pytest.raises(ValueError):
            g.set(bad)


def test_histogram_stats():
    reg = MetricsRegistry()
    h = reg.histogram("h")
    assert h.stats() == {"count": 0}
    for v in (1.0, 3.0, 2.0):
        h.observe(v)
    assert h.stats() == {"count": 3, "sum": 6.0, "min": 1.0, "max": 3.0,
                         "mean": 2.0}


def test_histogram_mean_clamped_into_range():
    """Three equal observations whose float sum / 3 lands an ulp above
    them (the JAX package's histogram reports that mean, which its
    schema then rejects): the port's mean stays in [min, max]."""
    v = 699050.9333094994
    assert (v + v + v) / 3 > v            # the arithmetic the clamp fixes
    reg = MetricsRegistry()
    h = reg.histogram("h")
    for _ in range(3):
        h.observe(v)
    s = h.stats()
    assert s["min"] <= s["mean"] <= s["max"] and s["mean"] == v
    validate_snapshot(reg.snapshot())


def test_registry_kind_collision_and_identity():
    reg = MetricsRegistry()
    c = reg.counter("x")
    assert reg.counter("x") is c
    with pytest.raises(ValueError):
        reg.gauge("x")
    with pytest.raises(ValueError):
        reg.histogram("x")


def test_registry_reset_zeroes_in_place():
    """reset() zeroes the *existing* instruments: module-held references
    like tel.DISPATCHES survive."""
    reg = MetricsRegistry()
    c, g, h = reg.counter("c"), reg.gauge("g"), reg.histogram("h")
    c.inc(5)
    g.set(1.0)
    h.observe(2.0)
    reg.reset()
    assert reg.counter("c") is c and c.value == 0
    assert reg.gauge("g") is g and g.value is None
    assert reg.histogram("h") is h and h.stats() == {"count": 0}


def test_snapshot_shape_and_diff_counters():
    reg = MetricsRegistry()
    reg.counter("a").inc(3)
    base = reg.snapshot()
    validate_snapshot(base)
    assert set(base) == {"counters", "gauges", "histograms"}
    assert base["gauges"] == {}
    reg.counter("a").inc(4)
    reg.counter("b").inc(1)
    assert diff_counters(base, reg.snapshot()) == {"a": 4, "b": 1}


# ---------------------------------------------------------------------------
# tracer
# ---------------------------------------------------------------------------


def test_span_nesting_depth_and_close_order(traced):
    with tel.span("outer", tag="o"):
        with tel.span("inner"):
            pass
        tel.instant("mark", x=1)
    names = [e["name"] for e in traced.events]
    assert names == ["inner", "mark", "outer"]
    by_name = {e["name"]: e for e in traced.events}
    assert by_name["outer"]["depth"] == 0
    assert by_name["inner"]["depth"] == 1
    assert by_name["mark"]["kind"] == "instant"
    assert by_name["outer"]["args"] == {"tag": "o"}
    o, i = by_name["outer"], by_name["inner"]
    assert o["ts_us"] <= i["ts_us"]
    assert i["ts_us"] + i["dur_us"] <= o["ts_us"] + o["dur_us"] + 1e-3


def test_span_attrs_normalized_and_set(traced):
    with tel.span("s", lattice=(16, 16)) as sp:
        sp.set(batch=2, obj=object())
    (e,) = traced.events
    assert e["args"]["lattice"] == [16, 16]
    assert e["args"]["batch"] == 2
    assert isinstance(e["args"]["obj"], str)
    assert sp.duration_ns is not None and sp.duration_ns >= 0


def test_span_error_attr(traced):
    with pytest.raises(RuntimeError):
        with tel.span("boom"):
            raise RuntimeError("x")
    (e,) = traced.events
    assert e["args"]["error"] is True


def test_disabled_tracing_is_inert():
    """Disabled, with no profiler recording: no event, and every span is
    the shared no-op handle."""
    tel.TRACER.clear()
    assert not tel.enabled() and not trace_mod.profiling()
    with tel.span("ghost") as sp:
        sp.set(a=1)
    assert sp is tel.NULL_SPAN and sp.duration_ns is None
    tel.instant("ghost")
    assert tel.TRACER.events == []


@pytest.mark.parametrize("enabled", [False, True],
                         ids=["disabled", "enabled"])
def test_no_profiler_range_without_a_profiler(enabled, monkeypatch):
    """With no profiler recording, no ``record_function`` is entered,
    whether or not tracing is on."""
    import torch.profiler

    def refuse(*args, **kwargs):
        raise AssertionError("record_function entered")

    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    tel.TRACER.clear()
    if enabled:
        tel.enable()
    try:
        with tel.span("quiet", k=1):
            tel.instant("quiet.mark")
    finally:
        tel.disable()
    assert [e["name"] for e in tel.TRACER.events] == \
        (["quiet.mark", "quiet"] if enabled else [])
    tel.TRACER.clear()


def _profiled(tmp_path, body):
    """``body()`` under a CPU ``torch.profiler`` inside an ``outer``
    range; the exported trace's complete events by name."""
    from torch.profiler import ProfilerActivity, profile, record_function
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with record_function("outer"):
            body()
    path = str(tmp_path / "profile.json")
    prof.export_chrome_trace(path)
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    by_name = {}
    for e in events:
        if e.get("ph") == "X":
            by_name.setdefault(e["name"], []).append(e)
    return by_name


def _inside(inner, outer) -> bool:
    return outer["ts"] <= inner["ts"] \
        and inner["ts"] + inner["dur"] <= outer["ts"] + outer["dur"]


@pytest.mark.parametrize("enabled", [False, True],
                         ids=["profiler-only", "enabled"])
def test_spans_enter_the_profiler_trace(enabled, tmp_path):
    """While a profiler records, a span and an instant are
    ``repro_torch/<name>`` ``user_annotation`` events on its clock,
    nested in the range around them; the tracer's own event list holds
    them only while tracing is on."""
    import torch
    tel.TRACER.clear()
    if enabled:
        tel.enable()

    def body():
        with tel.span("phase", k=2):
            torch.ones(4).sum()
            tel.instant("mark")

    try:
        by_name = _profiled(tmp_path, body)
    finally:
        tel.disable()
    (outer,) = by_name["outer"]
    (phase,) = by_name[trace_mod.RANGE_PREFIX + "phase"]
    (mark,) = by_name[trace_mod.RANGE_PREFIX + "mark"]
    assert phase["cat"] == mark["cat"] == "user_annotation"
    assert _inside(phase, outer) and _inside(mark, phase)
    assert any(_inside(op, phase) for op in by_name["aten::sum"])
    assert [e["name"] for e in tel.TRACER.events] == \
        (["mark", "phase"] if enabled else [])
    tel.TRACER.clear()


# ---------------------------------------------------------------------------
# export round-trips
# ---------------------------------------------------------------------------


def test_export_chrome_and_jsonl_agree(tmp_path, traced):
    with tel.span("a", k=3):
        tel.instant("p", family="stencil")
    cj = str(tmp_path / "t.json")
    jl = str(tmp_path / "t.jsonl")
    tel.export(cj, meta={"who": "test"})
    tel.export(jl, meta={"who": "test"})
    chrome = json.load(open(cj))
    validate_trace(chrome)
    jtel.validate_trace(chrome)          # the JAX package's rules too
    stream = _load(jl)
    validate_trace(stream)
    strip = lambda evs: [{k: e[k] for k in ("name", "ph", "ts", "args")}
                         for e in evs]
    assert strip(chrome["traceEvents"]) == strip(stream["traceEvents"])
    assert chrome["meta"]["who"] == stream["meta"]["who"] == "test"
    assert chrome["metrics"] == stream["metrics"]
    assert {e["name"]: e["ph"] for e in chrome["traceEvents"]} == \
        {"a": "X", "p": "i"}


# ---------------------------------------------------------------------------
# schema: the JAX package's golden file, violations, property round-trips
# ---------------------------------------------------------------------------


def test_golden_trace_validates():
    """The JAX package's committed trace (``python -m repro run --n 16
    --engine multispin --n-measure 3 --measure-every 2 --thermalize 2
    --trace``) validates and summarizes under the port's schema."""
    doc = json.load(open(GOLDEN))
    validate_trace(doc)
    names = {e["name"] for e in doc["traceEvents"]}
    assert {"session.open", "session.measure", "measure_scan",
            "dispatch", "spec.validate"} <= names
    assert doc["metrics"]["counters"] == {
        "dispatches": 1, "sweeps": 8,
        "spin_flips": 2048, "philox_draws": 2048}
    spec = RunSpec.from_json(doc["meta"]["spec_json"])
    assert spec.engine.name == "multispin"
    assert spec.sweep.total_sweeps == 8
    buf = io.StringIO()
    from repro_torch.telemetry.__main__ import summarize
    summarize(doc, out=buf)
    assert "dispatches" in buf.getvalue()


_BAD_SNAPSHOTS = [
    ("not-a-dict", []),
    ("unknown-key", {"counters": {}, "gauges": {}, "histograms": {},
                     "extra": {}}),
    ("missing-section", {"counters": {}, "gauges": {}}),
    ("negative-counter", {"counters": {"c": -1}, "gauges": {},
                          "histograms": {}}),
    ("bool-counter", {"counters": {"c": True}, "gauges": {},
                      "histograms": {}}),
    ("float-counter", {"counters": {"c": 1.5}, "gauges": {},
                       "histograms": {}}),
    ("nonfinite-gauge", {"counters": {}, "gauges": {"g": float("inf")},
                         "histograms": {}}),
    ("empty-name", {"counters": {"": 1}, "gauges": {},
                    "histograms": {}}),
    ("empty-hist-extra-keys", {"counters": {}, "gauges": {},
                               "histograms": {"h": {"count": 0,
                                                    "sum": 0.0}}}),
    ("hist-missing-mean", {"counters": {}, "gauges": {},
                           "histograms": {"h": {"count": 1, "sum": 1.0,
                                                "min": 1.0,
                                                "max": 1.0}}}),
    ("hist-order-violated", {"counters": {}, "gauges": {},
                             "histograms": {"h": {"count": 2, "sum": 3.0,
                                                  "min": 2.0, "max": 1.0,
                                                  "mean": 1.5}}}),
]


@pytest.mark.parametrize(
    "snap", [s for _, s in _BAD_SNAPSHOTS],
    ids=[n for n, _ in _BAD_SNAPSHOTS])
def test_snapshot_violations_rejected(snap):
    with pytest.raises(TelemetryError):
        validate_snapshot(snap)


def _ev(**over):
    ev = {"name": "s", "cat": "repro", "ph": "X", "ts": 1.0, "dur": 2.0,
          "pid": 0, "tid": 1, "args": {}}
    ev.update(over)
    return {k: v for k, v in ev.items() if v is not ...}


_BAD_EVENTS = [
    ("bad-ph", _ev(ph="B")),
    ("no-name", _ev(name="")),
    ("unknown-key", _ev(bogus=1)),
    ("complete-missing-dur", _ev(dur=...)),
    ("instant-with-dur", _ev(ph="i", s="t")),
    ("negative-ts", _ev(ts=-1.0)),
    ("nonfinite-dur", _ev(dur=float("nan"))),
    ("tid-not-int", _ev(tid="main")),
    ("args-nested-dict", _ev(args={"k": {"nested": 1}})),
    ("args-list-of-dicts", _ev(args={"k": [{"nested": 1}]})),
]


@pytest.mark.parametrize(
    "ev", [e for _, e in _BAD_EVENTS], ids=[n for n, _ in _BAD_EVENTS])
def test_event_violations_rejected(ev):
    with pytest.raises(TelemetryError):
        validate_event(ev)
    with pytest.raises(TelemetryError):
        validate_trace({"traceEvents": [ev]})


def test_trace_document_violations_rejected():
    with pytest.raises(TelemetryError):
        validate_trace([])
    with pytest.raises(TelemetryError):
        validate_trace({"traceEvents": [], "bogus": 1})
    with pytest.raises(TelemetryError):
        validate_trace({"traceEvents": {}})
    with pytest.raises(TelemetryError):
        validate_trace({"traceEvents": [], "meta": "not-a-dict"})
    with pytest.raises(TelemetryError):
        validate_trace({"traceEvents": [],
                        "metrics": {"counters": {"c": -1}, "gauges": {},
                                    "histograms": {}}})


@settings(max_examples=30)
@given(a=st.integers(min_value=0, max_value=2 ** 62),
       b=st.integers(min_value=0, max_value=2 ** 62),
       g=st.floats(min_value=-1e12, max_value=1e12))
def test_port_snapshot_roundtrip_property(a, b, g):
    # (named apart from the JAX test's: hypothesis keys its example
    # database on a test's name and source)
    reg = MetricsRegistry()
    reg.counter("a").inc(a)
    reg.counter("b").inc(b)
    reg.gauge("g").set(g)
    snap = reg.snapshot()
    validate_snapshot(snap)
    back = json.loads(json.dumps(snap))
    validate_snapshot(back)
    assert back["counters"] == {"a": a, "b": b}


@settings(max_examples=30)
@given(xs=st.tuples(st.floats(min_value=-1e6, max_value=1e6),
                    st.floats(min_value=-1e6, max_value=1e6),
                    st.floats(min_value=-1e6, max_value=1e6)))
def test_port_histogram_summary_property(xs):
    # the JAX test's property, which the JAX histogram fails on three
    # equal values (tests/test_telemetry.py): the port's clamp holds it
    reg = MetricsRegistry()
    h = reg.histogram("h")
    for v in xs:
        h.observe(v)
    validate_snapshot(reg.snapshot())
    s = h.stats()
    assert s["min"] <= s["mean"] <= s["max"]
    assert s["count"] == len(xs)


@settings(max_examples=30)
@given(ts=st.floats(min_value=0.0, max_value=1e12),
       dur=st.floats(min_value=0.0, max_value=1e9),
       instant=st.booleans())
def test_port_event_roundtrip_property(ts, dur, instant):
    # (named apart from the JAX test's, as above)
    ev = {"name": "s", "cat": "repro", "ts": ts, "pid": 0, "tid": 7,
          "args": {"k": 1}}
    if instant:
        ev.update(ph="i", s="t")
    else:
        ev.update(ph="X", dur=dur)
    validate_trace(json.loads(json.dumps({"traceEvents": [ev]})))


# ---------------------------------------------------------------------------
# engine families: counters and span nesting, and the JAX package's counts
# ---------------------------------------------------------------------------

FAMILIES = [("stencil_pallas", {}), ("multispin", {}),
            ("bitplane", {}), ("tensorcore", {"tc_block": 4})]


@pytest.mark.parametrize("engine,params", FAMILIES,
                         ids=[f for f, _ in FAMILIES])
def test_session_run_counters_and_spans(engine, params, traced):
    spec = RunSpec(lattice=LatticeSpec(n=16, m=16),
                   engine=EngineSpec(name=engine, params=params),
                   temperature=2.0, seed=3)
    info = describe(spec)
    base = _counters()
    session = Session.open(spec, device="cpu")
    session.run(2)
    d = diff_counters(base, _counters())
    sites = 16 * 16
    assert d["dispatches"] == 1, engine
    assert d["sweeps"] == 2, engine
    assert d["spin_flips"] == 2 * sites * info["replicas"], engine
    assert d["philox_draws"] == \
        (2 * sites if info["counter_based"] else 0), engine
    by_name = {}
    for e in traced.events:
        by_name.setdefault(e["name"], []).append(e)
    assert {"session.open", "session.run", "dispatch",
            "spec.validate"} <= set(by_name)
    dsp, run = by_name["dispatch"][-1], by_name["session.run"][-1]
    assert dsp["args"]["engine"] == engine
    assert dsp["args"]["k"] == 2
    assert dsp["args"]["lattice"] == [16, 16]
    assert run["ts_us"] <= dsp["ts_us"]
    assert dsp["ts_us"] + dsp["dur_us"] \
        <= run["ts_us"] + run["dur_us"] + 1e-3


def _jax_counts(spec_json: str, action) -> dict:
    """The JAX package's canonical counter deltas of ``action(session)``
    on a fresh session of the spec."""
    import repro.api as japi
    session = japi.Session.open(japi.RunSpec.from_json(spec_json))
    base = jtel.REGISTRY.snapshot()
    action(session)
    return _canonical(jtel.diff_counters(base, jtel.REGISTRY.snapshot()))


def _port_counts(spec, action) -> dict:
    session = Session.open(spec, device="cpu")
    base = _counters()
    action(session)
    return _canonical(diff_counters(base, _counters()))


#: (engine, params, lattice): single-mode run(3) of every engine
SINGLE_CASES = [("basic_philox", {}, (16, 16)), ("basic", {}, (16, 16)),
                ("stencil_pallas", {}, (16, 16)), ("multispin", {}, (16, 32)),
                ("multispin_pallas", {}, (16, 32)), ("bitplane", {}, (16, 16)),
                ("bitplane_pallas", {}, (16, 16)),
                ("tensorcore", {"tc_block": 4}, (16, 16)),
                ("wolff", {}, (16, 16)),
                ("spinglass", {"p_ferro": 0.5}, (16, 16))]


@pytest.mark.parametrize("engine,params,lattice", SINGLE_CASES,
                         ids=[c[0] for c in SINGLE_CASES])
def test_counters_equal_jax_single_mode(engine, params, lattice):
    spec = RunSpec(lattice=LatticeSpec(*lattice),
                   engine=EngineSpec(engine, params), temperature=2.0,
                   seed=5)

    def act(s):
        s.run(3)
        s.run(3)

    got = _port_counts(spec, act)
    assert got == _jax_counts(spec.to_json(), act)
    assert got["dispatches"] == 2 and got["sweeps"] == 6


#: measure() and ensembles: (spec, action)
PLAN_CASES = {
    "measure": (RunSpec(lattice=LatticeSpec(16, 32),
                        engine=EngineSpec("multispin"), temperature=2.2,
                        seed=5, sweep=SweepSpec(thermalize=4,
                                                measure_every=3,
                                                n_measure=5)),
                lambda s: s.measure()),
    "measure-tensorcore": (RunSpec(lattice=LatticeSpec(16, 16),
                                   engine=EngineSpec("tensorcore",
                                                     {"tc_block": 4}),
                                   temperature=2.2, seed=5,
                                   sweep=SweepSpec(measure_every=2,
                                                   n_measure=2)),
                           lambda s: s.measure()),
    "ensemble-run": (RunSpec(lattice=LatticeSpec(16, 32),
                             engine=EngineSpec("multispin_pallas"),
                             temperature=2.0, seed=5,
                             batch=BatchSpec(temperatures=(2.0, 2.2, 2.4))),
                     lambda s: s.run(3)),
    "ensemble-measure": (RunSpec(lattice=LatticeSpec(16, 16),
                                 engine=EngineSpec("bitplane"),
                                 temperature=2.0, seed=5,
                                 batch=BatchSpec(temperatures=(2.0, 3.0)),
                                 sweep=SweepSpec(thermalize=1,
                                                 measure_every=2,
                                                 n_measure=2)),
                         lambda s: s.measure()),
}


@pytest.mark.parametrize("case", sorted(PLAN_CASES))
def test_counters_equal_jax_measure_and_ensemble(case):
    """A measured trajectory is ONE dispatch in both packages (the JAX
    package's compiled scan; the port's sweeps and graph replays), and an
    ensemble's run is one dispatch of batch B."""
    spec, act = PLAN_CASES[case]
    got = _port_counts(spec, act)
    assert got == _jax_counts(spec.to_json(), act)
    assert got["dispatches"] == 1


#: meshes: (engine, lattice, mesh shape); both sharded tiers.  The
#: lattices are sized so that both packages' shard planners take k = 2
#: (the port's planner caps k at 2, the JAX planner's at 4 where its
#: overlap rule allows)
MESH_CASES = [("stencil_pallas", (24, 48), (1, 1)),
              ("multispin_pallas", (24, 384), (1, 1)),
              ("bitplane_pallas", (24, 48), (1, 1)),
              ("basic_philox", (16, 16), (1, 1)),
              ("multispin", (16, 32), (1, 1)),
              ("bitplane", (16, 16), (1, 1))]


def _mesh_spec(engine, lattice, shape):
    return RunSpec(lattice=LatticeSpec(*lattice), engine=EngineSpec(engine),
                   temperature=2.2, seed=5,
                   mesh=MeshSpec(shape, ("data", "model")))


@pytest.mark.parametrize("engine,lattice,shape", MESH_CASES,
                         ids=[c[0] for c in MESH_CASES])
def test_counters_equal_jax_mesh(engine, lattice, shape):
    """The per-half-sweep tier counts 2 exchanges a sweep, the sharded
    resident tier ceil(n / k); their bytes are the JAX package's."""
    spec = _mesh_spec(engine, lattice, shape)

    def act(s):
        s.run(3)
        s.run(3)

    got = _port_counts(spec, act)
    assert got == _jax_counts(spec.to_json(), act)
    plan = describe(spec)["dist"]
    want_ex = 2 * 2 if plan.get("sharded_resident") else 2 * 6
    assert got["halo_exchanges"] == want_ex and got["dispatches"] == 2


_JAX_MESH_COUNTS = r"""
import json, os, sys
import repro.api as japi
import repro.telemetry as jtel
out = {}
for spec_json in json.loads(sys.argv[1]):
    s = japi.Session.open(japi.RunSpec.from_json(spec_json))
    base = jtel.REGISTRY.snapshot()
    s.run(3)
    s.run(3)
    out[spec_json] = jtel.diff_counters(base, jtel.REGISTRY.snapshot())
print(json.dumps(out))
"""

#: 2 x 2 meshes: the JAX package needs four host devices, so its counts
#: come from a subprocess
MESH_2X2_CASES = [("stencil_pallas", (48, 96)), ("multispin", (16, 64))]


def test_counters_equal_jax_on_2x2_meshes():
    specs = [_mesh_spec(e, lat, (2, 2)) for e, lat in MESH_2X2_CASES]
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"),
               XLA_FLAGS="--xla_force_host_platform_device_count=4",
               JAX_PLATFORMS="cpu")
    proc = subprocess.run(
        [sys.executable, "-c", _JAX_MESH_COUNTS,
         json.dumps([s.to_json() for s in specs])], env=env,
        capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-3000:]
    jax_counts = json.loads(proc.stdout.strip().splitlines()[-1])
    for spec in specs:
        got = _port_counts(spec, lambda s: (s.run(3), s.run(3)))
        assert got == _canonical(jax_counts[spec.to_json()]), \
            spec.engine.name
        assert got["halo_bytes"] > 0


def test_session_measure_counts_one_fused_dispatch(traced):
    spec = PLAN_CASES["measure"][0]
    base = _counters()
    session = Session.open(spec, device="cpu")
    session.measure()
    d = diff_counters(base, _counters())
    assert d["dispatches"] == 1
    assert d["sweeps"] == spec.sweep.total_sweeps == 4 + 5 * 3
    names = {e["name"] for e in traced.events}
    assert {"session.measure", "measure_scan", "dispatch"} <= names
    scan = [e for e in traced.events if e["name"] == "measure_scan"][-1]
    assert scan["args"]["n_measure"] == 5
    assert scan["args"]["sweeps_between"] == 3
    assert scan["args"]["thermalize"] == 4
    # the trajectory's dispatch span nests inside measure_scan's
    dsp = [e for e in traced.events if e["name"] == "dispatch"][-1]
    assert dsp["depth"] == scan["depth"] + 1 and dsp["args"]["k"] == 19


def test_no_span_synchronizes(traced, tmp_path, monkeypatch):
    """A span is a host interval: with every CUDA event and synchronize
    refused, a traced run and measure (under a profiler too) pass."""
    import torch

    def refuse(*args, **kwargs):
        raise AssertionError("a span waited for the card")

    monkeypatch.setattr(torch.cuda, "Event", refuse)
    monkeypatch.setattr(torch.cuda, "synchronize", refuse)
    spec = PLAN_CASES["measure"][0]
    session = Session.open(spec, device="cpu")
    session.run(2)
    traj = session.measure()
    by_name = _profiled(tmp_path, lambda: (session.run(2),
                                           session.measure()))
    assert traj["m"].shape == (5,)
    names = {e["name"] for e in traced.events}
    assert {"session.run", "session.measure", "dispatch",
            "measure.sweeps"} <= names
    assert {trace_mod.RANGE_PREFIX + n
            for n in ("session.run", "session.measure")} <= set(by_name)


def test_measure_phases_are_spanned_in_order(traced):
    """``measure_scan_batched`` on the CPU (the loop): the buffers, each
    block of sweeps, each sample's observables, the copy to the host."""
    from repro_torch.analysis.measure import (MeasurementPlan,
                                              measure_scan_batched)
    spec = RunSpec(lattice=LatticeSpec(16, 16), engine=EngineSpec("bitplane"),
                   temperature=2.0, seed=5,
                   batch=BatchSpec(temperatures=(2.0, 3.0)))
    session = Session.open(spec, device="cpu")
    runner = session._runner
    plan = MeasurementPlan(3, 2, thermalize=1)
    tel.TRACER.clear()
    _, traj, step = measure_scan_batched(runner.engine, runner.state,
                                         runner.inv_temps, runner.seeds,
                                         plan, loop=True)
    assert traj["m"].shape == (3, 2, 32) and step == 7
    phases = [e for e in traced.events if e["name"].startswith("measure.")]
    assert [e["name"] for e in phases] == (
        ["measure.alloc", "measure.sweeps"]
        + ["measure.sweeps", "measure.observe"] * 3 + ["measure.to_host"])
    assert [e["args"].get("k") for e in phases
            if e["name"] == "measure.sweeps"] == [1, 2, 2, 2]
    dsp = [e for e in traced.events if e["name"] == "dispatch"][-1]
    assert all(e["depth"] == dsp["depth"] + 1 for e in phases[1:-1])
    assert phases[0]["depth"] == phases[-1]["depth"] == dsp["depth"] - 1


def test_halo_gather_is_spanned_on_a_mesh(traced):
    """The sharded resident tier's gather is one ``dist.extend`` span a
    block of sweeps, inside the dispatch."""
    spec = _mesh_spec("multispin_pallas", (32, 256), (2, 2))
    plan = describe(spec)["dist"]
    assert plan["sharded_resident"] and plan["halo_k"] == 1
    session = Session.open(spec, device="cpu")
    tel.TRACER.clear()
    session.run(3)
    extends = [e for e in traced.events if e["name"] == "dist.extend"]
    (dsp,) = [e for e in traced.events if e["name"] == "dispatch"]
    assert len(extends) == 3 == dsp["args"]["halo_exchanges"]
    assert all(e["args"] == {"halo": 2, "shards": 4} for e in extends)
    assert all(dsp["ts_us"] <= e["ts_us"] and e["depth"] > dsp["depth"]
               for e in extends)


def test_planner_decision_instant_matches_dry_run(traced):
    """The planner.decide instant, describe()['resident'] (the --dry-run
    plan) and decision_attrs() are one rendering; a sharded spec's
    planner.decide_shard instant is describe()['dist']."""
    spec = RunSpec(lattice=LatticeSpec(n=16, m=16),
                   engine=EngineSpec(name="stencil_pallas"),
                   temperature=2.0, seed=1)
    plan = describe(spec)
    decides = [e for e in traced.events
               if e["name"] == "planner.decide" and e["kind"] == "instant"]
    assert decides and decides[-1]["args"] == plan["resident"]
    assert plan["resident"] == decision_attrs("stencil", 16, 16)
    assert plan["resident"]["fits_smem"] is True
    sharded = describe(_mesh_spec("stencil_pallas", (24, 48), (1, 1)))
    shard = [e for e in traced.events if e["name"] == "planner.decide_shard"]
    assert shard and shard[-1]["args"] == sharded["dist"]


def test_graph_replay_counter_is_read_as_dispatches():
    """``measure.DISPATCHES`` reads the registry's
    ``measure.graph_replays``: a live view, not a copy."""
    from repro_torch.analysis import measure as msr
    counter = tel.REGISTRY.counter("measure.graph_replays")
    assert msr.GRAPH_REPLAYS is counter
    before = msr.DISPATCHES
    assert before == counter.value
    counter.inc(2)
    assert msr.DISPATCHES == before + 2
    with pytest.raises(AttributeError):
        msr.NO_SUCH_NAME


# ---------------------------------------------------------------------------
# CLI: python -m repro_torch run --trace / python -m repro_torch.telemetry
# ---------------------------------------------------------------------------


def test_telemetry_cli_validate_rejects_malformed(tmp_path, capsys):
    bad = tmp_path / "bad.json"
    bad.write_text(json.dumps({"traceEvents": [{"name": "x"}]}))
    assert telemetry_cli(["validate", str(bad)]) == 1
    assert "INVALID" in capsys.readouterr().err
    notjson = tmp_path / "nope.jsonl"
    notjson.write_text("{malformed\n")
    assert telemetry_cli(["validate", str(notjson)]) == 1


def test_telemetry_cli_summarize_golden(capsys):
    assert telemetry_cli(["summarize", GOLDEN]) == 0
    out = capsys.readouterr().out
    assert "== spans ==" in out and "== counters ==" in out
    assert "measure_scan" in out and "dispatches" in out
    assert telemetry_cli(["validate", GOLDEN]) == 0


@pytest.mark.slow
def test_cli_traced_run_acceptance(tmp_path):
    """One traced CLI run (the golden trace's command, on the CPU): >= 5
    span types, counters exactly the spec's plan and the JAX run's, the
    trace valid under both packages' schemas."""
    trace = str(tmp_path / "t.json")
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"))
    subprocess.run(
        [sys.executable, "-m", "repro_torch", "run", "--device", "cpu",
         "--n", "16", "--engine", "multispin", "--n-measure", "3",
         "--measure-every", "2", "--thermalize", "2", "--trace", trace],
        check=True, env=env, timeout=600, cwd=str(tmp_path))
    doc = json.load(open(trace))
    validate_trace(doc)
    jtel.validate_trace(doc)
    assert len({e["name"] for e in doc["traceEvents"]}) >= 5
    counters = doc["metrics"]["counters"]
    recovery = {k: v for k, v in counters.items()
                if k.startswith(("resilience.", "resident.", "ckpt."))}
    assert recovery and all(v == 0 for v in recovery.values()), recovery
    assert {k: v for k, v in counters.items() if k not in recovery} == {
        "dispatches": 1, "sweeps": 8,
        "spin_flips": 2048, "philox_draws": 2048,
        "halo_exchanges": 0, "halo_bytes": 0,
        # the CPU measures through the loop: no graph, no replay
        "measure.graph_replays": 0}
    golden = json.load(open(GOLDEN))["metrics"]["counters"]
    assert all(counters[k] == v for k, v in golden.items())
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.telemetry", "summarize", trace],
        check=True, env=env, timeout=120, capture_output=True, text=True)
    assert "dispatches" in out.stdout
