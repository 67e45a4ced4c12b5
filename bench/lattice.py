"""The benchmark's lattice: made from the seed, cut into tiles, read back.

The program's state (``Session.state``) is a pair of colour planes of
uint32 words held in int32 tensors, or in sharded mode a pair of lists
of shards, shard ``i`` the ``i``-th position of the mesh in row-major
order (rows over every mesh axis but the last, columns over the last).
The word layouts:

* multispin: ``(N, M / 16)``, nibble ``q`` of word ``v`` holds compact
  column ``8 v + q`` (0 or 1);
* bitplane: ``(N, M / 2)``, bit ``r`` of a word holds replica ``r``.

This module makes the first lattice of a run from the seed with a
``torch.Generator`` on the card (a hot start: every spin up or down with
probability 1/2, every replica its own), writes it into the session's
own planes, and cuts tiles out of any state as compact planes of
replica bits, the form the reference takes.
"""
from __future__ import annotations

import dataclasses
import math
from typing import List, Sequence, Tuple

import numpy as np
import torch

#: bits a word holds of the spins it packs: multispin keeps bit 0 of a
#: nibble
_SPIN_BITS = {"multispin": 0x11111111, "bitplane": -1}
#: compact columns a word
_COLS_PER_WORD = {"multispin": 8, "bitplane": 1}


@dataclasses.dataclass(frozen=True)
class Geometry:
    """The lattice of a configuration and how its mesh cuts it."""

    layout: str
    n: int
    m: int
    mesh: Tuple[int, ...]

    @classmethod
    def of(cls, config: dict) -> "Geometry":
        spec = config["spec"]
        mesh = spec.get("mesh")
        return cls(config["layout"], int(spec["lattice"]["n"]),
                   int(spec["lattice"]["m"]),
                   tuple(mesh["shape"]) if mesh else (1, 1))

    @property
    def width(self) -> int:
        """Compact columns of a colour plane."""
        return self.m // 2

    @property
    def words(self) -> int:
        """Words a row of a colour plane."""
        return self.width // _COLS_PER_WORD[self.layout]

    @property
    def grid(self) -> Tuple[int, int]:
        """Shards along the rows and along the columns."""
        return math.prod(self.mesh[:-1]), self.mesh[-1]

    @property
    def shards(self) -> int:
        return math.prod(self.mesh)

    @property
    def shard_shape(self) -> Tuple[int, int]:
        rows, cols = self.grid
        return self.n // rows, self.words // cols

    def origin(self, i: int) -> Tuple[int, int]:
        """Global (row, word column) of shard ``i``'s first word."""
        rows, cols = self.grid
        h, w = self.shard_shape
        return (i // cols) * h, (i % cols) * w

    def state_bytes(self) -> int:
        return 2 * self.n * self.words * 4


def planes(state) -> Tuple[List[torch.Tensor], List[torch.Tensor]]:
    """``(black shards, white shards)`` of a single or sharded state."""
    black, white = state[0], state[1]
    if isinstance(black, torch.Tensor):
        return [black], [white]
    return list(black), list(white)


def _generator_seed(seed: int, shard: int, colour: int) -> int:
    return (int(seed) * 64 + 2 * shard + colour) % (1 << 64)


def fill(state, geometry: Geometry, seed: int) -> None:
    """Write the run's first lattice into the planes of ``state`` in
    place: each plane of each shard from a generator on its own device,
    seeded from (seed, shard, colour)."""
    mask = _SPIN_BITS[geometry.layout]
    for colour, shards in enumerate(planes(state)):
        for i, plane in enumerate(shards):
            g = torch.Generator(device=plane.device)
            g.manual_seed(_generator_seed(seed, i, colour))
            plane.random_(-(1 << 31), 1 << 31, generator=g)
            if mask != -1:
                plane &= mask


def fresh(geometry: Geometry, seed: int, devices: Sequence) -> tuple:
    """The run's first lattice anew, in the program's layout: a
    ``(black, white)`` pair, of shard lists on a mesh."""
    h, w = geometry.shard_shape
    black = [torch.empty((h, w), dtype=torch.int32,
                         device=devices[i % len(devices)])
             for i in range(geometry.shards)]
    white = [torch.empty_like(b) for b in black]
    state = (black, white) if geometry.shards > 1 else (black[0], white[0])
    fill(state, geometry, seed)
    return state


@dataclasses.dataclass(frozen=True)
class Tiles:
    """Blocks of ``rows`` x ``cols`` compact sites at ``corners`` (global
    row, compact column; columns a multiple of 8), read with a margin of
    ``pad`` rows and compact columns around each (periodic)."""

    geometry: Geometry
    corners: Tuple[Tuple[int, int], ...]
    rows: int
    cols: int
    pad: int
    _plans: dict = dataclasses.field(default_factory=dict, compare=False,
                                     repr=False)

    def row_index(self, pad: int) -> torch.Tensor:
        """(tiles, rows + 2 pad) global rows."""
        g = self.geometry
        base = torch.tensor([r for r, _ in self.corners], dtype=torch.int64)
        return (base[:, None] - pad
                + torch.arange(self.rows + 2 * pad)) % g.n

    def col_index(self, pad: int) -> torch.Tensor:
        """(tiles, cols + 2 pad) global compact columns."""
        g = self.geometry
        base = torch.tensor([c for _, c in self.corners], dtype=torch.int64)
        return (base[:, None] - pad
                + torch.arange(self.cols + 2 * pad)) % g.width

    def _plan(self, shards, pad: int, device) -> list:
        """For each shard that holds part of the blocks: its device's
        row and word-column indices and where the part goes, on
        ``device``; made once, so that a read in the window copies
        nothing from the host."""
        key = (pad, str(device), tuple(str(s.device) for s in shards))
        if key not in self._plans:
            g = self.geometry
            per = _COLS_PER_WORD[g.layout]
            rows = self.row_index(pad)
            words = self.col_index(pad)[:, ::per] // per
            h, w = g.shard_shape
            plan = []
            for i, shard in enumerate(shards):
                r0, c0 = g.origin(i)
                lr, lc = rows - r0, words - c0
                inside = (((lr >= 0) & (lr < h))[:, :, None]
                          & ((lc >= 0) & (lc < w))[:, None, :])
                if bool(inside.any()):
                    dev = shard.device
                    plan.append((i, lr.clamp(0, h - 1).to(dev)[:, :, None],
                                 lc.clamp(0, w - 1).to(dev)[:, None, :],
                                 inside.to(device)))
            self._plans[key] = (plan, (rows.shape[0], rows.shape[1],
                                       words.shape[1]))
        return self._plans[key]

    def read(self, state, pad: int, device) -> Tuple[torch.Tensor, ...]:
        """The blocks with a margin of ``pad`` of both colours of
        ``state``, as compact planes of replica bits ``(tiles, rows + 2
        pad, cols + 2 pad)`` on ``device``; ``pad`` and the corners'
        columns multiples of 8 for the multispin layout."""
        per = _COLS_PER_WORD[self.geometry.layout]
        out = []
        for shards in planes(state):
            plan, shape = self._plan(shards, pad, device)
            block = torch.zeros(shape, dtype=torch.int32, device=device)
            for i, lr, lc, inside in plan:
                block = torch.where(inside, shards[i][lr, lc].to(device),
                                    block)
            if per > 1:
                shifts = torch.arange(per, device=device) * 4
                block = ((block[..., None] >> shifts) & 1).reshape(
                    *block.shape[:-1], -1)
            out.append(block)
        return tuple(out)


def choose_tiles(geometry: Geometry, seed: int, count: int, rows: int,
                 cols: int, pad: int, block=None, seams: int = 0) -> Tiles:
    """Tiles of ``rows`` x ``cols`` compact sites placed so that the
    checks cross every place where a fault likes to hide: one where the
    shards' corners meet at each corner of the shard grid (on one card:
    the lattice's periodic corner); one across the middle of each
    shard's upper and left edge (on one card: of the periodic wrap);
    ``seams`` across corners of the k-sweep kernel's blocks, ``block``
    = (rows, words) from a shard's origin, at blocks drawn from the
    seed; and ``count`` at places drawn from the seed."""
    g = geometry
    rng = np.random.default_rng(int(seed) % (1 << 63))
    grid_rows, grid_cols = g.grid
    h, _ = g.shard_shape
    shard_cols = g.width // grid_cols
    per = _COLS_PER_WORD[g.layout]
    half_r, half_c = rows // 2, cols // 2

    def at(r, c):
        return (r % g.n, (c - c % 8) % g.width)
    corners = []
    for a in range(grid_rows):
        for b in range(grid_cols):
            r0, c0 = a * h, b * shard_cols
            corners += [at(r0 - half_r, c0 - half_c),
                        at(r0 - half_r, c0 + shard_cols // 2 - half_c),
                        at(r0 + h // 2 - half_r, c0 - half_c)]
    if block is not None and seams:
        block_rows, block_cols = block[0], block[1] * per
        for _ in range(seams):
            i = int(rng.integers(g.shards))
            r0, c0 = i // grid_cols * h, i % grid_cols * shard_cols
            r = r0 + block_rows * int(rng.integers(1, max(2, h // block_rows)))
            c = c0 + block_cols * int(rng.integers(
                1, max(2, shard_cols // block_cols)))
            corners.append(at(r - half_r, c - half_c))
    for _ in range(count):
        corners.append((int(rng.integers(g.n)),
                        int(rng.integers(g.width // 8)) * 8))
    return Tiles(g, tuple(corners), rows, cols, pad)
