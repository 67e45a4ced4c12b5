"""The control (``bench/control.py``: the reference in bfloat16 in the
program's place) reads above every limit it is compared with, at a size
the CPU holds.  Run: ``python -m pytest -q bench/tests``."""
import copy
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
sys.path[:0] = [str(ROOT), str(ROOT / "src")]

from bench import check, control, harness  # noqa: E402

CELLS = [w["name"] for w in harness.load_benchmark()["workloads"]]


def _cell(name):
    """The cell at 128^2 with calls of 40 sweeps: enough decisions near
    the bfloat16 thresholds' rounding for some to differ."""
    cell = harness.Cell.load(harness.load_benchmark(), name)
    cell.config = copy.deepcopy(cell.config)
    cell.config["spec"]["lattice"].update(n=128, m=128)
    t = dict(cell.traffic)
    if t["entry"] == "run":
        t["sweeps"] = 40
    else:
        t.update(n_measure=4, sweeps_between=10)
    cell.traffic = t
    return cell


@pytest.mark.parametrize("name", CELLS)
@pytest.mark.parametrize("seed", [3, 2 ** 32 + 11, 2 ** 31 + 999])
def test_control_fails_the_checks(name, seed):
    readings = control.readings(_cell(name), seed, "cpu")
    limits = check.LIMITS
    assert readings
    assert all(v > limits[k] for k, v in readings.items()), readings
