"""What decides ``correct``: the program's outputs against the reference.

Every number compared is a count of disagreements, and every limit is
0: the draws are counter-based and every observable is an integer count
divided once, so a sound run equals the reference bit for bit.

* ``start_tiles`` (traffic of ``Session.run``): the set-up's first call
  from the benchmark's own lattice; the reference follows tiles of that
  lattice (:func:`tiles`: the shards' corners and edges, the k-sweep
  kernel's block seams, places drawn from the seed) through the call's
  sweeps, and the sites of the call's output that differ in any replica
  are counted.
* ``start_samples`` (traffic of ``Session.measure``): every sample of
  the first call against the reference's sweeps of the whole lattice
  from the benchmark's own: the values of ``m`` and ``e`` (a replica
  each) that differ.
* ``last_tiles``: the check call, one more call of the same program
  once the window has closed, followed from the program's state before
  it (read into tiles with their margin), against its output.
* ``last_sample`` (``Session.measure``): the check call's last sample
  against the reference's observables of the state it left.
"""
from __future__ import annotations

from typing import Dict, Sequence

import numpy as np
import torch

from bench import lattice
from bench.reference import ising

#: tiles drawn from the seed for each tile check, besides the shards'
#: corners and edges
TILES_DRAWN = 10
#: tiles across the k-sweep kernel's block seams, at blocks drawn from
#: the seed
SEAM_TILES = 3
TILE_ROWS = 16
TILE_COLS = 32
#: every comparison's limit: exact
LIMITS = {"start_tiles": 0, "start_samples": 0, "last_tiles": 0,
          "last_sample": 0}


def pad_for(sweeps: int) -> int:
    """Margin that ``sweeps`` sweeps need: one row and one compact column
    a half-sweep, rounded up to a whole multispin word."""
    return -(-2 * int(sweeps) // 8) * 8


def tiles(geometry: lattice.Geometry, seed: int, sweeps: int, block=None,
          drawn: int = TILES_DRAWN) -> lattice.Tiles:
    """The tiles a cell's checks follow; ``block`` is the k-sweep
    kernel's ``(rows, words)`` (its family's file), if known."""
    return lattice.choose_tiles(geometry, seed, drawn, TILE_ROWS, TILE_COLS,
                                pad_for(sweeps), block, SEAM_TILES)


def follow(tiles_: lattice.Tiles, regions, step: int, sweeps: int,
           seed: int, thr: Sequence[int]):
    """The reference's tiles after ``sweeps`` sweeps from sweep ``step``,
    from ``regions`` (both colours, read with the margin)."""
    g = tiles_.geometry
    pad = tiles_.pad
    device = regions[0].device
    rows = tiles_.row_index(pad).to(device)
    cols = tiles_.col_index(pad).to(device)
    black, white = ising.sweeps_block(g.layout, regions[0], regions[1],
                                      rows, cols, g.width, step, sweeps,
                                      seed, thr)
    cut = (..., slice(pad - 2 * sweeps or None, None),
           slice(pad - 2 * sweeps or None, None))
    black, white = black[cut], white[cut]
    keep = (..., slice(0, tiles_.rows), slice(0, tiles_.cols))
    return black[keep], white[keep]


def differing_sites(ours, theirs) -> int:
    """Sites (both colours) where any replica differs."""
    return int(sum(int((a.to(b.device) != b).sum())
                   for a, b in zip(ours, theirs)))


def differing_values(ours: Dict[str, np.ndarray],
                     theirs: Dict[str, np.ndarray], fields) -> int:
    """Values of ``fields`` that are not equal bit for bit."""
    return int(sum(int(np.sum(np.asarray(ours[k], np.float32).view(np.int32)
                              != np.asarray(theirs[k], np.float32)
                              .view(np.int32)))
                   for k in fields))


def reference_samples(layout: str, state, first_step: int, sweeps_between: int,
                      thermalize: int, count: int, seed: int,
                      thr: Sequence[int]) -> list:
    """The first ``count`` samples of a ``measure`` call from the whole
    lattice ``state`` ``(black, white)`` at sweep ``first_step``."""
    black, white = state
    step = first_step
    if thermalize:
        black, white = ising.sweeps_full(layout, black, white, step,
                                         thermalize, seed, thr)
        step += thermalize
    out = []
    for _ in range(count):
        black, white = ising.sweeps_full(layout, black, white, step,
                                         sweeps_between, seed, thr)
        step += sweeps_between
        out.append(ising.observables(layout, black, white))
    return out


def whole(state, geometry: lattice.Geometry, device) -> tuple:
    """A state's colour planes as whole ``(N, M/2)`` compact planes of
    replica bits on ``device`` (the layouts that hold a word a site)."""
    if geometry.layout != "bitplane":
        raise ValueError("whole planes are read for the bitplane layout")
    out = []
    for shards in lattice.planes(state):
        plane = torch.empty((geometry.n, geometry.words), dtype=torch.int32,
                            device=device)
        h, w = geometry.shard_shape
        for i, shard in enumerate(shards):
            r0, c0 = geometry.origin(i)
            plane[r0:r0 + h, c0:c0 + w] = shard.to(device)
        out.append(plane)
    return tuple(out)


def as_dict(samples: Dict[str, np.ndarray], index: int, fields) -> dict:
    return {k: np.asarray(samples[k])[index] for k in fields}


