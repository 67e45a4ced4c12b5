"""The reference against known Philox vectors and the port's CPU
trajectory.  Run: ``python -m pytest -q bench/tests``."""
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parents[2]
sys.path[:0] = [str(ROOT), str(ROOT / "src")]

from bench import check, lattice  # noqa: E402
from bench.reference import ising  # noqa: E402

T_C = 2.269185
SEED = 2 ** 33 + 7   # both key lanes in use


@pytest.mark.parametrize("counter, key, expected", [
    ((0, 0, 0, 0), (0, 0),
     (0x6627E8D5, 0xE169C58D, 0xBC57AC4C, 0x9B00DBD8)),
    ((0xFFFFFFFF,) * 4, (0xFFFFFFFF, 0xFFFFFFFF),
     (0x408F276D, 0x41C83B0E, 0xA20BC7C6, 0x6D5451FD)),
    ((0x243F6A88, 0x85A308D3, 0x13198A2E, 0x03707344),
     (0xA4093822, 0x299F31D0),
     (0xD16CFE09, 0x94FDCCEB, 0x5001E420, 0x24126EA1)),
])
def test_philox_known_answers(counter, key, expected):
    """Random123's known-answer vectors of Philox4x32-10."""
    lanes = ising.philox(*(torch.tensor([c], dtype=torch.int64)
                           for c in counter), *key)
    assert tuple(int(x[0]) for x in lanes) == expected


def test_thresholds_at_tc():
    """exp(-4 beta) and exp(-8 beta) at T_c, scaled to 2^32; classes that
    lower the energy always flip; bfloat16 moves the two others."""
    t = ising.thresholds(T_C)
    beta = np.float32(1 / T_C)
    assert t[0] == int(np.float32(np.exp(np.float64(np.float32(-8) * beta)))
                       * 2.0 ** 32)
    assert t[1] == int(np.float32(np.exp(np.float64(np.float32(-4) * beta)))
                       * 2.0 ** 32)
    assert t[2:8] == [ising.MASK32] * 6
    low = ising.thresholds(T_C, "bfloat16")
    assert (low[0], low[1], low[8], low[9]) != (t[0], t[1], t[8], t[9])
    assert low[2:8] == t[2:8]


def _unpacked(words):
    """Per-replica 0/1 planes of replica-bit words: (32, h, w)."""
    return (words[None].to(torch.int64) >> torch.arange(32)[:, None, None]) & 1


def test_counts_match_per_replica_sums():
    g = torch.Generator().manual_seed(3)
    planes = [torch.randint(-2 ** 31, 2 ** 31, (5, 7), dtype=torch.int32,
                            generator=g) for _ in range(4)]
    n0, n1, n2 = (_unpacked(x) for x in ising._counts(*planes))
    total = sum(_unpacked(p) for p in planes)
    assert torch.equal(n0 + 2 * n1 + 4 * n2, total)


@pytest.mark.parametrize("layout", ["multispin", "bitplane"])
def test_block_equals_whole_lattice(layout):
    """Tiles followed without wrap equal the same tiles of the periodic
    whole lattice, tiles that cross the wrap included."""
    geom = lattice.Geometry(layout, 32, 64, (1, 1))
    state = lattice.fresh(geom, SEED, ["cpu"])
    whole = _compact(state, geom)
    thr = ising.thresholds(T_C)
    sweeps, step = 3, 11
    tiles = check.tiles(geom, SEED, sweeps, drawn=3)
    regions = tiles.read(state, tiles.pad, "cpu")
    ours = check.follow(tiles, regions, step, sweeps, SEED, thr)
    after = ising.sweeps_full(layout, *whole, step, sweeps, SEED, thr)
    rows, cols = tiles.row_index(0), tiles.col_index(0)
    for mine, full in zip(ours, after):
        assert torch.equal(mine, full[rows[:, :, None], cols[:, None, :]])


def _compact(state, geom):
    """The compact replica-bit planes of a single state."""
    tiles = lattice.Tiles(geom, ((0, 0),), geom.n, geom.width, 0)
    return tuple(p[0] for p in tiles.read(state, 0, "cpu"))


def _session(engine, n, m, step_fill=True):
    from repro_torch.api.session import Session
    from repro_torch.api.spec import RunSpec
    spec = RunSpec.from_dict({
        "lattice": {"n": n, "m": m, "init_p_up": 0.5},
        "engine": {"name": engine, "params": {}},
        "temperature": T_C, "seed": SEED, "mesh": None})
    return Session.open(spec, "cpu")


@pytest.mark.parametrize("engine, layout", [
    ("multispin_pallas", "multispin"), ("bitplane_pallas", "bitplane")])
def test_reference_follows_the_port_on_the_cpu(engine, layout):
    """The port's CPU session and the reference, from one lattice, give
    the same state after three calls; the port's digest of the reference's
    state is the port's own."""
    n, m = 32, 64
    geom = lattice.Geometry(layout, n, m, (1, 1))
    session = _session(engine, n, m)
    lattice.fill(session.state, geom, SEED)
    start = _compact(session.state, geom)
    for _ in range(3):
        session.run(2)
    ref = ising.sweeps_full(layout, *start, 0, 6, SEED,
                            ising.thresholds(T_C))
    assert all(torch.equal(a, b) for a, b in
               zip(_compact(session.state, geom), ref))
    other = _session(engine, n, m)
    other.state = tuple(_pack(p, layout) for p in ref)
    other.step_count = session.step_count
    assert other.state_digest() == session.state_digest()


def _pack(plane, layout):
    if layout == "bitplane":
        return plane.clone()
    h, w = plane.shape
    nib = plane.to(torch.int64).reshape(h, w // 8, 8) << (
        torch.arange(8) * 4)
    v = nib.sum(-1) & ising.MASK32
    return torch.where(v >= 2 ** 31, v - 2 ** 32, v).to(torch.int32)


def test_observables_match_the_port():
    from repro_torch.core import bitplane as bp
    geom = lattice.Geometry("bitplane", 16, 32, (1, 1))
    black, white = lattice.fresh(geom, SEED, ["cpu"])
    ours = ising.observables("bitplane", black, white)
    theirs = bp.replica_observables(black, white)
    for k in ("m", "e"):
        assert np.array_equal(ours[k], theirs[k].numpy())
