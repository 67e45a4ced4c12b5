"""The port's recorder and perf-record schema against the JAX package's:
the same CSV bytes and JSON layout for the same rows, and the same
records accepted and rejected."""
import copy
import json
import os

import pytest

from repro.analysis import recorder as jrec
from repro.api import RunSpec as JaxRunSpec
from repro.perf import schema as jschema
from repro_torch.analysis import recorder as rec
from repro_torch.api import EngineSpec, LatticeSpec, RunSpec, SweepSpec
from repro_torch.perf import schema

SPEC = RunSpec(lattice=LatticeSpec(64, 64), engine=EngineSpec("multispin"),
               temperature=2.27, seed=7,
               sweep=SweepSpec(thermalize=5, measure_every=2, n_measure=3))
META = {"stamp": "20261017_000000", "backend": "cuda", "device_count": 1,
        "device_name": "card", "power_limit": "700.00 W"}


def fill(recorder):
    """The same rows on either package's recorder: single-number rows,
    noise-model rows of one and of several trials, a spec row, floats
    that print in exponent form, strings and ints."""
    recorder.record("legacy_row", 12.5, flips_per_ns=0.5, engine="multispin")
    recorder.record("noisy_row", 10.0, times_us=[9.0, 10.0, 11.0, 10.5, 9.5],
                    flips_per_ns=1.0, m=-0.123456789, tiny=1.25e-9)
    recorder.record("single_trial", 20.0, spec=SPEC.to_json(),
                    times_us=[20.0], sweeps=200, big=123456789.0)
    recorder.record("fig6_tc_estimate", 0.0, tc=2.2645949144388067,
                    exact=2.269185, rel_err=0.00202279)
    return recorder


def test_write_csv_gives_the_jax_bytes(tmp_path):
    ours = fill(rec.RunRecorder(meta=META)).write_csv(
        str(tmp_path / "a" / "ours.csv"))
    theirs = fill(jrec.RunRecorder(meta=META)).write_csv(
        str(tmp_path / "b" / "theirs.csv"))
    with open(ours, "rb") as a, open(theirs, "rb") as b:
        assert a.read() == b.read()
    with open(ours) as f:
        assert f.readline().rstrip("\n") == rec.HEADER == jrec.HEADER


def test_echo_prints_the_jax_lines(capsys):
    fill(rec.RunRecorder(echo=True))
    ours = capsys.readouterr().out
    fill(jrec.RunRecorder(echo=True))
    assert ours == capsys.readouterr().out


@pytest.mark.parametrize("where", ["file", "dir"])
def test_json_round_trips(tmp_path, where):
    """The JSON record reads back as meta + rows; a path not ending in
    .json is a directory that gets BENCH_<stamp>.json; the layout is the
    JAX recorder's."""
    ours = fill(rec.RunRecorder(meta=META))
    target = str(tmp_path / "r.json") if where == "file" \
        else str(tmp_path / "results")
    path = ours.write_json(target)
    if where == "dir":
        assert path == os.path.join(target, f"BENCH_{META['stamp']}.json")
    with open(path) as f:
        back = json.load(f)
    assert back == {"meta": META, "rows": ours.rows}
    theirs = fill(jrec.RunRecorder(meta=META))
    with open(theirs.write_json(str(tmp_path / "j.json"))) as f:
        assert json.load(f) == back
    schema.validate_record(back)
    jschema.validate_record(back)
    assert RunSpec.from_json(back["rows"][2]["spec"]) == SPEC


@pytest.mark.parametrize("times", [[42.0], [], [1.0, 2.0, 3.0, 4.0],
                                   [5.0, 1.0], [3.0, 9.0, 1.0, 7.0, 5.0]])
def test_timing_stats_equal_jax(times):
    got = rec.timing_stats(times)
    assert got == jrec.timing_stats(times)
    if len(times) == 1:
        assert got == {"n_trials": 1, "median_us_per_call": times[0]}
    if len(times) >= 2:
        assert "iqr_us_per_call" in got


@pytest.mark.parametrize("derived", ["a=1;b=x;c=2.5e-3", "", "k=v=w;;x",
                                     "nan=nan;n=-4"])
def test_parse_derived_equals_jax(derived):
    got, want = rec.parse_derived(derived), jrec.parse_derived(derived)
    assert got.keys() == want.keys()
    for k in got:
        assert got[k] == want[k] or (got[k] != got[k] and want[k] != want[k])


def _valid_row(**over):
    row = {"name": "t1_x", "us_per_call": 10.0,
           "derived": {"flips_per_ns": 1.5, "engine": "multispin"}}
    row.update(over)
    return row


def _valid_record(rows=None):
    return {"meta": {"stamp": "20260807_000000", "backend": "cpu",
                     "device_count": 1},
            "rows": rows if rows is not None else [_valid_row()]}


#: the row cases of tests/test_bench_schema.py, and valid ones
ROW_CASES = [
    (lambda r: r.pop("name"), "name"),
    (lambda r: r.update(name=""), "name"),
    (lambda r: r.update(typo_key=1), "unknown row keys"),
    (lambda r: r.pop("us_per_call"), "us_per_call"),
    (lambda r: r.update(us_per_call=-1.0), ">= 0"),
    (lambda r: r.update(us_per_call=float("nan")), "finite"),
    (lambda r: r.update(us_per_call="fast"), "number"),
    (lambda r: r.update(derived=[1, 2]), "derived must be a dict"),
    (lambda r: r.update(derived={"flips_per_ns": -2.0}), ">= 0"),
    (lambda r: r.update(derived={"note": None}), "str or number"),
    (lambda r: r.update(n_trials=0, median_us_per_call=1.0), ">= 1"),
    (lambda r: r.update(n_trials=True, median_us_per_call=1.0), "int"),
    (lambda r: r.update(n_trials=3, median_us_per_call=1.0),
     "requires iqr"),
    (lambda r: r.update(n_trials=5), "median"),
    (lambda r: r.update(n_trials=1, median_us_per_call=1.0,
                        iqr_us_per_call=0.0), "single trial"),
    (lambda r: r.update(median_us_per_call=1.0), "without n_trials"),
    (lambda r: r.update(iqr_us_per_call=1.0), "without n_trials"),
    (lambda r: r.update(spec=123), "JSON string"),
    (lambda r: r.update(spec="not json"), "not valid JSON"),
    (lambda r: r.update(spec="[1, 2]"), "object"),
    (lambda r: r.update(spec='{"lattice": "nope"}'), "RunSpec"),
    (lambda r: None, None),
    (lambda r: r.update(spec=SPEC.to_json()), None),
    (lambda r: r.update(n_trials=1, median_us_per_call=3.0), None),
    (lambda r: r.update(n_trials=2, median_us_per_call=3.0,
                        iqr_us_per_call=0.5), None),
]


@pytest.mark.parametrize("case", range(len(ROW_CASES)))
def test_validate_row_agrees_with_jax(case):
    mutate, match = ROW_CASES[case]
    row = _valid_row()
    mutate(row)
    if match is None:
        schema.validate_row(copy.deepcopy(row))
        jschema.validate_row(copy.deepcopy(row))
        return
    with pytest.raises(schema.SchemaError, match=match):
        schema.validate_row(copy.deepcopy(row))
    with pytest.raises(jschema.SchemaError, match=match):
        jschema.validate_row(copy.deepcopy(row))


RECORD_CASES = [
    (lambda r: r.pop("meta"), "meta"),
    (lambda r: r["meta"].pop("stamp"), "stamp"),
    (lambda r: r["meta"].pop("backend"), "backend"),
    (lambda r: r["meta"].pop("device_count"), "device_count"),
    (lambda r: r.update(rows=[]), "non-empty"),
    (lambda r: r.update(rows={}), "non-empty"),
    (lambda r: r.update(extra_top=1), "unknown top-level"),
    (lambda r: r.update(rows=[_valid_row(), _valid_row()]),
     "duplicate row name"),
    (lambda r: r.update(rows=[_valid_row(), _valid_row(us_per_call=-1)]),
     ">= 0"),
    (lambda r: None, None),
    (lambda r: r["meta"].update(device_name="card", power_limit="700 W"),
     None),
]


@pytest.mark.parametrize("case", range(len(RECORD_CASES)))
def test_validate_record_agrees_with_jax(case):
    mutate, match = RECORD_CASES[case]
    record = _valid_record()
    mutate(record)
    if match is None:
        schema.validate_record(copy.deepcopy(record))
        jschema.validate_record(copy.deepcopy(record))
        return
    with pytest.raises(schema.SchemaError, match=match):
        schema.validate_record(copy.deepcopy(record))
    with pytest.raises(jschema.SchemaError, match=match):
        jschema.validate_record(copy.deepcopy(record))


def test_a_port_spec_row_is_a_jax_spec():
    """A row's spec written by the port parses in the JAX package as the
    same spec."""
    row = fill(rec.RunRecorder()).rows[2]
    assert JaxRunSpec.from_json(row["spec"]).to_dict() == SPEC.to_dict()
