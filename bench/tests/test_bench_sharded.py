"""The readers of the sharded tier's metrics (``halo_pct.sweep`` and
``exchange_idle_pct.sweep``) on a synthetic four-card trace.
Run: ``python -m pytest -q bench/tests``."""
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
sys.path[:0] = [str(ROOT), str(ROOT / "src")]

from bench import harness, spans, trace  # noqa: E402

SHARD = ("void (anonymous namespace)::multispin_sweeps_kernel<true>("
         "unsigned int const*, unsigned int const*)")
COPY = ("void at::native::elementwise_kernel<128, 2, at::native::"
        "direct_copy_kernel_cuda>")
CARDS = (0, 1, 2, 3)


def _ev(name, cat, ts, dur, device=None):
    args = {} if device is None else {"device": device}
    return {"ph": "X", "name": name, "cat": cat, "ts": ts, "dur": dur,
            "pid": 0, "tid": 0, "args": args}


def _copy_us(d):
    """Card ``d``'s strip copies, in us: 2, 4, 6 and 8."""
    return 2 * (d + 1)


def _events(gather=True, kernel=SHARD):
    """A window of 100 us on four cards: on each, the shard kernel 0-60
    and 70-90, a strip copy from 60 for ``_copy_us(d)`` and a 0.5 us
    peer copy at 95, so card ``d`` is idle from 60 + copy to 70, 90-95
    and 95.5-100; the host inside ``dist.extend`` 58-75 (``gather``)
    and inside ``session.run`` 0-100."""
    events = [_ev(trace.WINDOW, "user_annotation", 0, 100),
              _ev(spans.PREFIX + "session.run", "user_annotation", 0, 100)]
    for d in CARDS:
        events += [_ev(kernel, "kernel", 0, 60, d),
                   _ev(kernel, "kernel", 70, 20, d),
                   _ev(COPY, "kernel", 60, _copy_us(d), d),
                   _ev("Memcpy PtoP (Device -> Device)", "gpu_memcpy", 95,
                       0.5, d)]
    if gather:
        events.append(_ev(spans.PREFIX + "dist.extend", "user_annotation",
                          58, 17))
    return events


class _Cell:
    def __init__(self, entry):
        self.traffic = {"entry": entry}


def _read(name, events, entry="run"):
    summary = None if events is None else trace.summarize(events, CARDS)
    ctx = harness.Context(_Cell(entry), 10.0, 1e-4, 1, 0, len(CARDS),
                          CARDS, summary)
    return harness.load_metric(name).read(ctx)


def test_halo_pct_is_the_cards_mean_share_outside_the_shard_kernel():
    want = sum(100.0 * (_copy_us(d) + 0.5) / (80 + _copy_us(d) + 0.5)
               for d in CARDS) / len(CARDS)
    assert _read("halo_pct.sweep", _events()) == pytest.approx(want)
    # it does not read the trace's spans
    assert _read("halo_pct.sweep", _events(gather=False)) == \
        pytest.approx(want)


def test_exchange_idle_pct_is_the_idle_under_the_gather():
    """Idle under 58-75: from the end of the strip copy to 70, 8, 6, 4
    and 2 us on the four cards, a mean of 5 us of the 100 us window."""
    assert _read("exchange_idle_pct.sweep", _events()) == pytest.approx(5.0)


def test_no_gather_range_reads_nothing():
    assert _read("exchange_idle_pct.sweep", _events(gather=False)) is None


@pytest.mark.parametrize("name", ["halo_pct.sweep",
                                  "exchange_idle_pct.sweep"])
def test_nothing_to_read(name):
    """No trace, or traffic of ``Session.measure``: nothing; a trace
    without the shard kernel: no halo share."""
    assert _read(name, None) is None
    assert _read(name, _events(), entry="measure") is None
    other = _read(name, _events(kernel="void bitplane_sweeps_kernel<true>"))
    assert (other is None) == (name == "halo_pct.sweep")
