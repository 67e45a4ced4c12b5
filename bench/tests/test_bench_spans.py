"""The readers of the program's spans (``bench/spans.py`` and the
``*_idle_pct`` metrics that read it) on synthetic profiler events.
Run: ``python -m pytest -q bench/tests``."""
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
sys.path[:0] = [str(ROOT), str(ROOT / "src")]

from bench import harness, spans, trace  # noqa: E402

KERNEL = "void bitplane_sweeps_kernel<false, true, false>(unsigned)"


def _ev(name, cat, ts, dur, device=None):
    args = {} if device is None else {"device": device}
    return {"ph": "X", "name": name, "cat": cat, "ts": ts, "dur": dur,
            "pid": 0, "tid": 0, "args": args}


def _span(name, ts, dur):
    return _ev(spans.PREFIX + name, "user_annotation", ts, dur)


def _events(with_spans=True):
    """A window of 100 us; card 0 busy 0-40, 50-60 and 80-90, so idle
    40-50, 60-80 and 90-100.  ``session.measure`` covers 35-70: the first
    gap wholly, the second in part, the third not; the graph's ranges
    nest in it and overlap each other (instantiate 42-48 and reset 45-55,
    a capture 62-66 named twice, once nested in itself); ``session.run``
    covers 85-97; a launch call 39-41."""
    events = [
        _ev(trace.WINDOW, "user_annotation", 0, 100),
        _ev(KERNEL, "kernel", 0, 40, 0),
        _ev(KERNEL, "kernel", 50, 10, 0),
        _ev(KERNEL, "kernel", 80, 10, 0),
        _ev("cudaLaunchKernel", "cuda_runtime", 39, 2),
    ]
    if with_spans:
        events += [
            _span("session.measure", 35, 35),
            _span("measure.graph_instantiate", 42, 6),
            _span("measure.graph_reset", 45, 10),
            _span("measure.graph_capture", 62, 4),
            _span("measure.graph_capture", 63, 2),
            _span("session.run", 85, 12),
        ]
    return events


def _summary(with_spans=True, devices=(0,)):
    return trace.summarize(_events(with_spans), devices)


class _Cell:
    def __init__(self, entry):
        self.traffic = {"entry": entry, "n_measure": 10}


def _read(name, entry, summary, devices=(0,)):
    ctx = harness.Context(_Cell(entry), 10.0, 1e-4, 1, 0, len(devices),
                          devices, summary)
    return harness.load_metric(name).read(ctx)


def test_intervals_merge_nested_and_overlapping_ranges():
    s = _summary()
    assert spans.intervals(s, ("measure.graph_instantiate",
                               "measure.graph_reset",
                               "measure.graph_capture")) == [
        (42.0, 55.0), (62.0, 66.0)]
    assert spans.intervals(s, ("session.measure",
                               "measure.graph_reset")) == [(35.0, 70.0)]
    assert spans.intervals(s, ("no.such.span",)) == []


def test_overlap_of_interval_lists():
    assert spans.overlap([(0, 10), (20, 30)], [(5, 25)]) == 10
    assert spans.overlap([(0, 10)], [(10, 20)]) == 0
    assert spans.overlap([], [(0, 1)]) == 0


def test_gap_wholly_partly_and_not_under_a_range():
    s = _summary()
    # gap 40-50 wholly, 60-80 for 60-70, 90-100 not at all
    assert spans.idle_pct(s, (0,), ("session.measure",)) == \
        pytest.approx(20.0)
    # 42-50 of the first gap, 62-66 of the second, each counted once
    assert spans.idle_pct(s, (0,), ("measure.graph_instantiate",
                                    "measure.graph_reset",
                                    "measure.graph_capture")) == \
        pytest.approx(12.0)
    assert spans.idle_pct(s, (0,), ("no.such.span",)) == 0.0


def test_idle_is_averaged_over_cards():
    s = _summary(devices=(0, 1))     # card 1 holds nothing: idle 0-100
    assert spans.idle_pct(s, (0, 1), ("session.measure",)) == \
        pytest.approx((20.0 + 35.0) / 2)


def test_metric_readers():
    s = _summary()
    assert _read("program_idle_pct.sample", "measure", s) == \
        pytest.approx(20.0)
    assert _read("graph_idle_pct.sample", "measure", s) == \
        pytest.approx(12.0)
    assert _read("program_idle_pct.sweep", "run", s) == pytest.approx(7.0)
    # each reads at or below the window's whole idle share
    whole = _read("device_idle_pct.sample", "measure", s)
    assert _read("graph_idle_pct.sample", "measure", s) \
        <= _read("program_idle_pct.sample", "measure", s) <= whole
    assert _read("program_idle_pct.sweep", "measure", s) is None
    assert _read("program_idle_pct.sample", "run", s) is None
    assert _read("graph_idle_pct.sample", "run", s) is None


@pytest.mark.parametrize("name,entry", [
    ("graph_idle_pct.sample", "measure"),
    ("program_idle_pct.sample", "measure"),
    ("program_idle_pct.sweep", "run")])
def test_nothing_to_read_without_the_programs_ranges(name, entry):
    """A program that does not mirror its spans (no ``repro_torch/``
    range), or an untraced run, reads nothing."""
    assert not spans.has_spans(_summary(with_spans=False))
    assert spans.idle_pct(_summary(with_spans=False), (0,),
                          ("session.run",)) is None
    assert _read(name, entry, _summary(with_spans=False)) is None
    assert _read(name, entry, None) is None


def test_host_at_names_the_programs_range():
    """Where no runtime call covers a gap, the innermost ``repro_torch/``
    range names it."""
    s = _summary()
    assert s.host_at(40.5) == "cudaLaunchKernel"
    assert s.host_at(46) == spans.PREFIX + "measure.graph_instantiate"
    assert s.host_at(64) == spans.PREFIX + "measure.graph_capture"
    assert s.host_at(75) == "host: no traced event"
    assert s.host_at(68) == spans.PREFIX + "session.measure"
    assert s.host_at(95) == spans.PREFIX + "session.run"
    assert _summary(with_spans=False).host_at(46) == \
        "host: no traced event"
