"""The per-half-sweep distributed tier: shards of a mesh, 1-wide halos.

Counterpart of ``repro.core.distributed``.  The JAX package runs one
program per device under ``shard_map`` and exchanges halos with
``ppermute``; the port is one controller that holds a mesh's shards as
a list of tensors (shard ``i`` at position ``i`` of the mesh in
row-major order, on ``mesh.device_of(i)``), and a halo is a slice of
the neighbour shard copied to the shard's device (no copy where both
live on one device).  The two colour planes are cut into a 2-D grid of
shards: rows over ``row_axes`` (default: every mesh axis but the last),
columns over ``col_axes`` (the last).

Each half-sweep of :func:`make_ising_step` ("basic", int8 planes),
:func:`make_packed_ising_step` (8-spin words) and
:func:`make_bitplane_ising_step` (32-replica words) exchanges one row
halo in each vertical and one column halo in each horizontal direction
of the opposite-colour plane, and updates every shard with the plain
PyTorch operations of the single-device plain versions, on the card
too: the JAX package has no Pallas kernel here.  The "basic" step draws
its uniforms with ``repro_torch.kernels.draws`` (the kernel
``philox_fill`` on the card, one launch a shard a half-sweep), as the
single-device ``basic_philox`` engine does.  This is the tier that
the ``multispin`` and ``bitplane`` engines run on a mesh, and the
fallback of the others where no shard plan fits.  The draws are keyed
on global positions, so the trajectory is the single-device one on any
mesh.
"""
from __future__ import annotations

import dataclasses
from typing import Sequence

import torch

from . import bitplane as bp
from . import lattice as lat
from . import metropolis as metro
from . import multispin as ms
from . import observables as obs
from . import rng


# -- the grid of shards ------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class ShardGrid:
    """How a mesh cuts an ``(n, width)`` plane: rows over ``row_axes``,
    columns over ``col_axes``."""

    mesh: object
    row_axes: tuple
    col_axes: tuple
    n: int
    width: int

    @classmethod
    def of(cls, mesh, n: int, width: int, row_axes=None,
           col_axes=None) -> "ShardGrid":
        """The grid of ``mesh`` over an ``(n, width)`` plane; raises
        unless the plane tiles it with an even number of rows a shard
        (so that every shard's first row has the global parity 0)."""
        names = list(mesh.axis_names)
        grid = cls(mesh, tuple(row_axes if row_axes is not None
                               else names[:-1]),
                   tuple(col_axes if col_axes is not None
                         else names[-1:]), n, width)
        if n % grid.rows_devs or (n // grid.rows_devs) % 2 \
                or width % grid.cols_devs:
            raise ValueError(
                f"a ({n}, {width}) plane does not tile a {grid.rows_devs} x "
                f"{grid.cols_devs} grid of shards with an even number of "
                f"rows each")
        return grid

    @property
    def rows_devs(self) -> int:
        return self.mesh.axis_size(self.row_axes)

    @property
    def cols_devs(self) -> int:
        return self.mesh.axis_size(self.col_axes)

    @property
    def n_loc(self) -> int:
        return self.n // self.rows_devs

    @property
    def w_loc(self) -> int:
        return self.width // self.cols_devs

    def origin(self, i: int):
        """Global (row, column) of shard ``i``'s first cell."""
        return (self.mesh.axis_index(i, self.row_axes) * self.n_loc,
                self.mesh.axis_index(i, self.col_axes) * self.w_loc)

    def gather(self, shards, device=None) -> torch.Tensor:
        """The shards -> the whole plane on ``device`` (default: shard
        0's)."""
        device = shards[0].device if device is None else device
        plane = torch.empty((self.n, self.width), dtype=shards[0].dtype,
                            device=device)
        for i, x in enumerate(shards):
            r0, c0 = self.origin(i)
            plane[r0:r0 + self.n_loc, c0:c0 + self.w_loc] = x.to(device)
        return plane

    def split(self, plane: torch.Tensor) -> list:
        """The whole plane -> its shards (copies), shard ``i`` on
        ``mesh.device_of(i)``: the inverse of :meth:`gather`."""
        shards = []
        for i in range(self.mesh.size):
            r0, c0 = self.origin(i)
            block = plane[r0:r0 + self.n_loc, c0:c0 + self.w_loc]
            shards.append(block.to(self.mesh.device_of(i)).clone(
                memory_format=torch.contiguous_format))
        return shards

    def positions(self, i: int, h: int = 0):
        """Global (row, column) int64 vectors of shard ``i``'s cells,
        extended by ``h`` on each side, modulo the plane (the periodic
        wrap)."""
        r0, c0 = self.origin(i)
        device = self.mesh.device_of(i)
        rows = torch.arange(r0 - h, r0 + self.n_loc + h, dtype=torch.int64,
                            device=device) % self.n
        cols = torch.arange(c0 - h, c0 + self.w_loc + h, dtype=torch.int64,
                            device=device) % self.width
        return rows, cols


# -- halo exchange -----------------------------------------------------------

def ring_shift(xs, mesh, axis_names: Sequence[str], shift: int) -> list:
    """Shift the per-shard values ``xs`` by one position around the ring
    formed by the product of ``axis_names`` (most significant first):
    ``shift=+1`` receives from the previous position (a top or left
    halo), ``-1`` from the next.  Each value lands on its shard's
    device."""
    if shift not in (+1, -1):
        raise ValueError(f"shift must be +1 or -1, got {shift}")
    return [xs[mesh.neighbor(i, axis_names, shift)].to(mesh.device_of(i))
            for i in range(mesh.size)]


def _exchange_halos(ops, grid: ShardGrid) -> list:
    """Per shard, the (top, bottom, left, right) halos of the
    opposite-colour plane."""
    mesh = grid.mesh
    top = ring_shift([o[-1:, :] for o in ops], mesh, grid.row_axes, +1)
    bottom = ring_shift([o[:1, :] for o in ops], mesh, grid.row_axes, -1)
    left = ring_shift([o[:, -1:] for o in ops], mesh, grid.col_axes, +1)
    right = ring_shift([o[:, :1] for o in ops], mesh, grid.col_axes, -1)
    return list(zip(top, bottom, left, right))


def _haloed_taps(op, halos):
    """(up, down, nxt, prv) neighbour taps of one shard, the exchanged
    halo rows and columns spliced in: ``up[i] = op[i-1]``, ``nxt[:, k]
    = op[:, k+1]``."""
    top, bottom, left, right = halos
    return (torch.cat([top, op[:-1]], 0), torch.cat([op[1:], bottom], 0),
            torch.cat([op[:, 1:], right], 1), torch.cat([left, op[:, :-1]], 1))


def _side(nxt, prv, is_black: bool):
    """The same-row tap: black targets take (i, k+1) on odd rows, (i, k-1)
    on even ones; white the reverse.  A shard's first row is even."""
    odd = (torch.arange(nxt.shape[0], device=nxt.device) % 2 == 1)[:, None]
    return torch.where(odd, nxt, prv) if is_black \
        else torch.where(odd, prv, nxt)


def _half_sweeps(update, grid: ShardGrid):
    """The step of a per-half-sweep factory: ``step(black, white, table,
    start, n_sweeps)`` with ``update(i, target, op, taps, table, is_black,
    offset)``, offsets ``half_sweep_offset(start, j, colour)``."""
    def half(targets, ops, table, is_black, offset):
        halos = _exchange_halos(ops, grid)
        return [update(i, t, o, _haloed_taps(o, halos[i]), table, is_black,
                       offset)
                for i, (t, o) in enumerate(zip(targets, ops))]

    def step(black, white, table, start, n_sweeps: int):
        for j in range(n_sweeps):
            black = half(black, white, table, True,
                         rng.half_sweep_offset(start, j, 0))
            white = half(white, black, table, False,
                         rng.half_sweep_offset(start, j, 1))
        return black, white
    return step


def make_ising_step(mesh, *, n: int, m: int, seed: int = 0, row_axes=None,
                    col_axes=None):
    """The basic engine's distributed sweep on int8 shards:
    ``step(black, white, table, sweep0, n_sweeps)`` advances the lists of
    shards by ``n_sweeps`` sweeps at offsets ``half_sweep_offset(0, sweep0
    + j, colour)`` (``sweep0`` in sweep units, as in the JAX package) and
    returns new lists; ``table`` is ``metropolis.acceptance_table``.
    Each shard's uniforms come from ``kernels.draws.index_uniforms`` at
    its cells' global indices."""
    from repro_torch.kernels.draws import index_uniforms
    grid = ShardGrid.of(mesh, n, m // 2, row_axes, col_axes)

    def update(i, target, op, taps, table, is_black, offset):
        up, down, nxt, prv = taps
        nn = up + down + op + _side(nxt, prv, is_black)
        rows, cols = grid.positions(i)
        gidx = (rows[:, None] * grid.width + cols[None, :]) & rng.MASK32
        return metro.accept_flips(
            target, nn, index_uniforms(gidx, seed, offset), table)

    half_sweeps = _half_sweeps(update, grid)

    def step(black, white, table, sweep0: int, n_sweeps: int):
        return half_sweeps(black, white, table, 2 * int(sweep0), n_sweeps)
    return step


def make_packed_ising_step(mesh, *, n: int, m: int, seed: int = 0,
                           row_axes=None, col_axes=None):
    """The multispin distributed sweep on 8-spin word shards:
    ``step(black, white, thresholds, start, n_sweeps)`` with ``start`` in
    half-sweep units; the column halo carries the nibble of the side
    word's funnel shift."""
    grid = ShardGrid.of(mesh, n, m // (2 * lat.SPINS_PER_WORD), row_axes,
                        col_axes)
    nib = lat.NIBBLE_BITS

    def update(i, target, op, taps, thresholds, is_black, offset):
        up, down, nxt, prv = (lat.words_to_u32(t) for t in taps)
        center = lat.words_to_u32(op)
        plus = (center >> nib) | ((nxt << (32 - nib)) & rng.MASK32)
        minus = ((center << nib) & rng.MASK32) | (prv >> (32 - nib))
        nn = up + down + center + _side(plus, minus, is_black)
        rows, cols = grid.positions(i)
        widx = (rows[:, None] * grid.width + cols[None, :]) & rng.MASK32
        return ms.update_words(target, nn, thresholds, seed, offset,
                               widx=widx)

    return _half_sweeps(update, grid)


def make_bitplane_ising_step(mesh, *, n: int, m: int, seed: int = 0,
                             row_axes=None, col_axes=None):
    """The bitplane distributed sweep on 32-replica word shards:
    ``step(black, white, thresholds, start, n_sweeps)`` with ``start`` in
    half-sweep units.  Where every shard's columns start on a 4-site
    group, one Philox call serves a group, as in the single-device
    ``bitplane.site_randoms``; otherwise each site draws its lane of its
    group's call (``bitplane.lane_draws``, 4 times the Philox work, the
    same bits)."""
    half = m // 2
    if half % 4:
        raise ValueError("bitplane planes need a multiple-of-4 width")
    grid = ShardGrid.of(mesh, n, half, row_axes, col_axes)
    aligned = grid.w_loc % 4 == 0
    k0, k1 = rng.seed_keys(seed)

    def update(i, target, op, taps, thresholds, is_black, offset):
        up, down, nxt, prv = taps
        counts = bp.bit_count_neighbors(up, down, op,
                                        _side(nxt, prv, is_black))
        rows, cols = grid.positions(i)
        if aligned:
            groups = cols[::4] // 4

            def draws_of(r0, r1):
                g = (rows[r0:r1, None] * (half // 4) + groups[None, :]) \
                    & rng.MASK32
                lanes = rng.philox4x32(offset, 0, g, 0, k0, k1)
                return torch.stack(lanes, dim=-1).reshape(r1 - r0, -1)
        else:
            def draws_of(r0, r1):
                g = (rows[r0:r1, None] * (half // 4) + cols[None, :] // 4) \
                    & rng.MASK32
                return bp.lane_draws(seed, g, (cols % 4).expand_as(g),
                                     offset)
        return bp.update_bits(target, counts, thresholds, draws_of)

    return _half_sweeps(update, grid)


# -- observables from per-shard exact sums -----------------------------------

def _extended_taps(x, hr: int, hc: int, n: int, w: int):
    """(up, down, center, nxt, prv) of the ``(n, w)`` interior of a plane
    extended by ``hr`` rows and ``hc`` columns on each side."""
    return (x[hr - 1:hr - 1 + n, hc:hc + w], x[hr + 1:hr + 1 + n, hc:hc + w],
            x[hr:hr + n, hc:hc + w], x[hr:hr + n, hc + 1:hc + 1 + w],
            x[hr:hr + n, hc - 1:hc - 1 + w])


def shard_observables(kind: str, grid: ShardGrid, black, white,
                      fields=("m", "e")) -> dict:
    """``{field: value}`` of a sharded state, from exact integer sums per
    shard added on shard 0's device and divided once, as the
    single-device observables are (the same float32 values): ``kind``
    is the engine's ``dist_factory``, "basic" (int8 planes), "packed"
    (8-spin words, unpacked a shard at a time) or "bitplane" (per-replica
    ``(32,)`` vectors).  The energy takes a 1-wide halo of the white
    plane through the tier's gather (``repro_torch.dist.driver.extend``),
    so no device ever holds the whole lattice."""
    from repro_torch.dist.driver import extend
    device = black[0].device
    count = sum(b.numel() + w.numel() for b, w in zip(black, white))
    if kind == "packed":
        count *= lat.SPINS_PER_WORD
    white_x = extend(white, grid, 1) if "e" in fields else [None] * len(black)
    up = bonds = 0
    for b, w, wx in zip(black, white, white_x):
        if kind == "bitplane":
            if "m" in fields:
                up = up + (bp.bit_counts(b) + bp.bit_counts(w)).to(device)
            if wx is not None:
                u, d, c, nxt, prv = _extended_taps(wx, 1, 1, *b.shape)
                for nb in (u, d, c, _side(nxt, prv, True)):
                    bonds = bonds + bp.bit_counts(b ^ nb).to(device)
            continue
        hc = 1
        if kind == "packed":
            b, w = ms.unpack_plane(b), ms.unpack_plane(w)
            hc = lat.SPINS_PER_WORD
            wx = None if wx is None else ms.unpack_plane(wx)
        if "m" in fields:
            up = up + (obs._int_sum(b) + obs._int_sum(w)).to(device)
        if wx is not None:
            u, d, c, nxt, prv = _extended_taps(wx, 1, hc, *b.shape)
            nn = u + d + c + _side(nxt, prv, True)
            bonds = bonds + obs._int_sum(b * nn).to(device)
    out = {}
    if kind == "bitplane":
        # bonds counts the disagreeing bonds D_r: the bond sum is 2N - 2D_r
        if "m" in fields:
            out["m"] = bp._means(2 * up - count, count)
        if "e" in fields:
            out["e"] = bp._means(-(2 * count - 2 * bonds), count)
    else:
        if "m" in fields:
            out["m"] = obs._mean(up, count)
        if "e" in fields:
            out["e"] = obs._mean(-bonds, count)
    return out


def magnetization_dist(kind: str, black, white) -> torch.Tensor:
    """Mean spin of a sharded state (per replica for "bitplane"), from
    exact per-shard sums; ``kind`` as in :func:`shard_observables`."""
    return shard_observables(kind, None, black, white, fields=("m",))["m"]
