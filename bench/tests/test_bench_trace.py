"""The trace reader and the metric readers on synthetic profiler events.
Run: ``python -m pytest -q bench/tests``."""
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
sys.path[:0] = [str(ROOT), str(ROOT / "src")]

from bench import harness, trace  # noqa: E402

SWEEP = "void (anonymous namespace)::multispin_sweeps_kernel<false>(unsigned)"
ATEN = "void at::native::vectorized_elementwise_kernel<4, at::native::AbsFunctor>"


def _ev(name, cat, ts, dur, device=None, corr=None):
    args = {}
    if device is not None:
        args["device"] = device
    if corr is not None:
        args["correlation"] = corr
    return {"ph": "X", "name": name, "cat": cat, "ts": ts, "dur": dur,
            "pid": 0, "tid": 0, "args": args}


def _events():
    """A window of 100 us on card 0: sweep kernels 0-40 and 55-80, an ATen
    kernel 40-45, a copy 80-90 overlapping a set 85-88; card 1 holds one
    sweep kernel 10-30."""
    return [
        _ev(trace.WINDOW, "user_annotation", 0, 100),
        _ev("aten::index", "cpu_op", 60, 30),
        _ev("cudaLaunchKernel", "cuda_runtime", 46, 1, corr=7),
        _ev(SWEEP, "kernel", 0, 40, 0),
        _ev(ATEN, "kernel", 40, 5, 0),
        _ev(SWEEP, "kernel", 55, 25, 0, corr=7),
        _ev("Memcpy DtoD (Device -> Device)", "gpu_memcpy", 80, 10, 0),
        _ev("Memset (Device)", "gpu_memset", 85, 3, 0),
        _ev(SWEEP, "kernel", 10, 20, 1),
        _ev(SWEEP, "kernel", 200, 5, 0),      # after the window
    ]


def _summary(devices=(0,)):
    return trace.summarize(_events(), devices)


def test_sweep_kernel_rule():
    assert trace.is_sweep_kernel(SWEEP)
    assert trace.is_sweep_kernel("bitplane_shard_kernel_v2")
    assert not trace.is_sweep_kernel(ATEN)
    assert not trace.is_sweep_kernel(
        "void cub::DeviceReduceKernel<int>(int*)")


def test_busy_idle_and_op_times():
    s = _summary()
    assert s.window_s == pytest.approx(100e-6)
    # busy: 0-45 and 55-90
    assert s.busy_s(0) == pytest.approx(80e-6)
    assert s.op_seconds(0, sweep=True) == pytest.approx(65e-6)
    assert s.op_seconds(0, sweep=False) == pytest.approx(18e-6)
    assert s.count() == 5
    assert s.gaps(0) == [(45.0, 55.0), (90.0, 100.0)]
    assert s.top_gaps(1)[0][1] == pytest.approx(1e-5)
    assert s.host_at(46.5) == "cudaLaunchKernel"
    assert s.host_at(70) == "aten::index"


def test_breakdown_is_bounded():
    b = _summary().breakdown()
    assert b["device_ops"][0] == [SWEEP[:trace.NAME_CHARS],
                                  pytest.approx(65e-6)]
    assert len(b["device_ops"]) <= 10 and len(b["idle_gaps"]) <= 10


class _Cell:
    def __init__(self, entry, config=None):
        self.traffic = {"entry": entry, "n_measure": 10}
        self.config = config or {"family": "multispin"}
        self.sweeps_per_call = 200 if entry == "run" else 100
        self.flips_per_call = 200 * 32768 ** 2

    @property
    def geometry(self):
        from bench.lattice import Geometry
        return Geometry("multispin", 32768, 32768, (1, 1))


def _ctx(entry="run", calls=3, window_s=2.0, summary=None, devices=(0,)):
    return harness.Context(_Cell(entry), 10.0, window_s, calls, 2 ** 31, 1,
                           devices, summary)


def _read(name, ctx):
    return harness.load_metric(name).read(ctx)


def test_rates_are_all_work_over_all_time():
    """An end-to-end rate is the window's work over the window's time,
    not a median of calls."""
    ctx = _ctx(calls=3, window_s=2.0)
    assert _read("flips_per_ns", ctx) == 3 * 200 * 32768 ** 2 / 2e9
    assert _read("samples_per_s", ctx) is None
    sample = _ctx("measure", calls=3, window_s=12.0)
    assert _read("samples_per_s", sample) == 30 / 12.0
    assert _read("flips_per_ns", sample) is None
    assert _read("peak_mem_gib", ctx) == 2.0
    assert _read("setup_s", ctx) == 10.0


def test_layer_metrics_from_the_trace():
    s = _summary()
    run = _ctx(calls=1, summary=s)
    assert _read("device_idle_pct.sweep", run) == pytest.approx(20.0)
    assert _read("device_idle_pct.sample", run) is None
    assert _read("launches_per_sweep", run) == pytest.approx(5 / 200)
    assert _read("sweep_roofline", run) > 100   # a synthetic 65 us
    sample = _ctx("measure", summary=s)
    assert _read("observables_pct.sample", sample) == pytest.approx(
        100 * 18 / 83)


def test_idle_share_is_averaged_over_cards():
    s = _summary((0, 1))
    ctx = _ctx(summary=s, devices=(0, 1))
    assert s.busy_s(1) == pytest.approx(20e-6)
    assert _read("device_idle_pct.sweep", ctx) == pytest.approx(
        100 * (1 - (80 + 20) / 2 / 100))


def test_no_trace_reads_nothing():
    ctx = _ctx()
    for name in ("sweep_roofline", "launches_per_sweep",
                 "device_idle_pct.sweep", "observables_pct.sample",
                 "device_idle_pct.sample"):
        assert _read(name, ctx) is None


def test_trace_without_window_fails():
    with pytest.raises(ValueError):
        trace.summarize([e for e in _events()
                         if e["name"] != trace.WINDOW], (0,))
