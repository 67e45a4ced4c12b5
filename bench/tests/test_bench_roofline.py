"""The frozen work counts against the kernel bounds of ``chip_smoke.py``.
Run: ``python -m pytest -q bench/tests``."""
import ast
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
sys.path[:0] = [str(ROOT), str(ROOT / "src")]

from bench import roofline  # noqa: E402

FAMILIES = ("stencil", "multispin", "bitplane")


def _smoke_constants() -> dict:
    """``PIPE_OPS`` and its slot counts, read from ``chip_smoke.py``
    without running it."""
    tree = ast.parse((ROOT / "chip_smoke.py").read_text())
    wanted = {"PIPE_OPS", "FMA_WIDE_SLOTS", "WIDE_ALU_SLOTS"}
    body = [n for n in tree.body if isinstance(n, ast.Assign)
            and any(getattr(t, "id", None) in wanted for t in n.targets)]
    scope: dict = {}
    exec(compile(ast.Module(body=body, type_ignores=[]), "chip_smoke",
                 "exec"), scope)
    return scope


def _pipe_ops_clocks(family: str, c: dict) -> float:
    """SM clocks an element by ``chip_smoke.clocks_per_element``."""
    from repro_torch.launch import roofline as card
    ops = dict(c["PIPE_OPS"][family])
    wide = ops.pop("wide")
    ops["fma"] += c["FMA_WIDE_SLOTS"] * wide
    ops["alu"] += c["WIDE_ALU_SLOTS"] * wide
    pipes = max(ops[p] / card.H100_PIPE_PER_CLOCK_PER_SM[p] for p in ops)
    issued = wide + sum(v for p, v in c["PIPE_OPS"][family].items()
                        if p not in ("tensor", "wide"))
    return max(pipes, issued / card.H100_DISPATCH_PER_CLOCK_PER_SM)


@pytest.mark.parametrize("family", FAMILIES)
def test_least_time_at_or_below_pipe_ops_bound(family):
    """At the same SM clock (``chip_smoke.py`` bounds at the card's
    maximum, 1980 MHz), the frozen count needs no more clocks than the
    bound of today's kernels, so no kernel that meets that bound reads
    over 100 %."""
    counts = roofline.family(family)
    assert roofline.clocks_per_update(counts) <= _pipe_ops_clocks(
        family, _smoke_constants())


def test_counts_follow_the_derivation():
    ms, bp, st = (roofline.family(f) for f in ("multispin", "bitplane",
                                                "stencil"))
    assert (ms["fma"], ms["alu"]) == (2 + 2 * 16, (1 + 2 * 18) + 3 + 8 * 3 + 1)
    assert (bp["fma"], bp["alu"]) == (18 / 4, 19 / 4 + 5 + 4 + 3 * 2)
    assert (st["fma"], st["alu"]) == (16 + 1, 17 + 2 + 1 + 1)
    assert (ms["sites_per_update"], bp["replicas"]) == (8, 32)


def test_least_seconds():
    """One multispin call of 200 sweeps of 32768^2 on one card: the ALU
    bound, 65/64 clocks a word, far above the bytes' 0.32 ms."""
    counts = roofline.family("multispin")
    flips = 200 * 32768 ** 2
    t = roofline.least_seconds(counts, flips, 2 * 32768 * 2048 * 4, 1, 1)
    words = flips / 8
    assert t == pytest.approx(words * 65 / 64 / (132 * 1.98e9))
    assert roofline.least_seconds(counts, flips, 2 * 32768 * 2048 * 4, 1,
                                  4) == pytest.approx(t / 4)
