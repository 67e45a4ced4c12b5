"""Shard-aware planner of the sharded resident tier: fit, halo and k.

Counterpart of ``repro.dist.planner``.  A shard owns ``(n_loc, w_loc)``
plane cells of the lattice and runs k sweeps per halo exchange on its
*extended* plane: the owned cells plus a ring of ``h = 2k`` halo cells
on every side.  The rules are the JAX package's:

* **halo fit** ``h <= min(n_loc, w_loc)``: the gather takes the
  outermost ``h`` rows and columns of each neighbour shard;
* **overlap cap**: the extended area at most :data:`MAX_OVERLAP` times
  the owned area, since the halo cells are swept again on every shard;
* **parity**: ``n_loc`` even, so that the extended plane's first row
  has the global parity 0 and the kernels' local row parity is right;
* the largest k up to the cap that passes them all, else ``None`` (the
  per-half-sweep distributed tier, ``repro_torch.core.distributed``).

The JAX planner's VMEM fit (the whole extended shard in 8 MiB of TPU
VMEM) has no Hopper counterpart.  As for the single-device k-sweep tier
(``repro_torch.kernels.resident``), the shard kernels
(``csrc/{stencil,multispin,bitplane}.cu``, ``*_shard_sweeps``) block in
time on tiles of the extended plane, so the fit is one block's shared
memory: the family's shard tile (:data:`SHARD_TILES`) with a halo of
2k cells, both planes and the tile's index planes (uint32 site or word
indices; for bitplane, per 4-word group, the uint32 group index and an
aligned flag as a byte), within the budget of one block.  By default k
is capped at the family's ``max_k`` in ``GEOMETRY`` (the fastest k of
its single-device kernel) as well as :data:`K_CAP`.

Left out: the JAX planner's demotion hook (``resilience.degrade``),
which is not ported.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional

from repro_torch.kernels.resident import (GEOMETRY, SMEM_BUDGET_BYTES,
                                         col_halo, extended_tile)

#: cap on sweeps per halo exchange: past it the redundant halo sweeps
#: cost more than the exchanges they save
K_CAP: int = 4

#: largest extended / owned area before the redundant halo sweeps rule a
#: k out
MAX_OVERLAP: float = 2.0

#: bytes of index planes in a shard kernel's shared memory per extended
#: cell: the uint32 site (stencil) or word (multispin) index; and for
#: bitplane per 4-word group: the uint32 group index of the group's
#: first word and a byte that says whether the group is one Philox group
#: (4 words of one group index, lanes 0, 1, 2, 3)
INDEX_BYTES = {"stencil": 4, "multispin": 4, "bitplane": 5}

#: tile (rows, columns of the extended plane) of each family's shard
#: kernel: the fastest k = 2 candidate of ``python -m
#: repro_torch.analysis.tune_resident --shard`` at the 2 x 2 main paths
#: (``PERF.md``).  Staging the index planes too, the single-device tiles
#: (``GEOMETRY``) leave one block an SM.  The bitplane kernel's columns
#: are whole 4-word groups, rows of 64 groups with the halo at k = 2;
#: the multispin kernel's make rows of 128 words with the halo at k = 2
SHARD_TILES = {"stencil": (64, 248), "multispin": (64, 120),
               "bitplane": (32, 248)}

#: threads of a shard-kernel block, by family (the same measurements):
#: the bitplane kernel's registers (a thread per group) fit 256
SHARD_THREADS = {"stencil": 512, "multispin": 512, "bitplane": 256}


@dataclasses.dataclass(frozen=True)
class ShardPlan:
    """A positive fit: this (family, lattice, grid) runs the sharded
    resident tier with ``k`` sweeps per halo exchange, on tiles of
    ``tile_rows`` x ``tile_cols`` of the extended plane."""

    family: str
    n: int                  # global plane rows
    m: int                  # global lattice columns
    rows_devs: int          # shard-grid rows
    cols_devs: int          # shard-grid columns
    n_loc: int              # owned plane rows per shard
    w_loc: int              # owned plane cells per shard row
    k: int                  # full sweeps per halo exchange
    halo: int               # halo ring width = 2k (always even)
    tile_rows: int
    tile_cols: int
    threads: int            # threads of a block
    smem_bytes: int         # one block's shared memory at k
    budget_bytes: int

    @property
    def width(self) -> int:
        """Global plane cells per row (sites or words)."""
        return self.m // GEOMETRY[self.family].col_divisor

    @property
    def cell_bytes(self) -> int:
        return GEOMETRY[self.family].element_bytes

    def exchanges(self, n_sweeps: int) -> int:
        """Halo exchanges of ``n_sweeps`` sweeps: one per block of k
        sweeps, and one for the remainder block."""
        return max(1, math.ceil(n_sweeps / self.k))

    @property
    def halo_bytes_per_exchange(self) -> int:
        """Bytes gathered per exchange over all shards: both colour
        planes, each 2 column strips ``(n_loc, h)`` and then 2 row strips
        ``(h, w_loc + 2h)`` of the column-extended plane (the corners
        ride on the row strips)."""
        h = self.halo
        per_plane = 2 * self.n_loc * h + 2 * h * (self.w_loc + 2 * h)
        return (2 * per_plane * self.cell_bytes
                * self.rows_devs * self.cols_devs)


def shard_smem_bytes(family: str, tile_rows: int, tile_cols: int,
                     k: int) -> int:
    """Shared memory of one shard-kernel block for k sweeps: the
    acceptance table where the kernel keeps one there (stencil: its draw
    bounds; multispin: its threshold pairs), the tile's index planes and
    both extended planes (the layout of the family's shard kernel)."""
    g = GEOMETRY[family]
    if family == "bitplane":
        # rows of whole 4-word groups: the tile's columns rounded up and a
        # column halo of 2k rounded up; index planes per group
        er = tile_rows + 4 * k
        ec = -(-tile_cols // 4) * 4 + 2 * col_halo(k, family)
        return (2 * g.element_bytes * er * ec
                + INDEX_BYTES[family] * er * (ec // 4))
    # stencil and multispin: rows of whole words (and of 4 words), as
    # their k-sweep kernels
    er, ec = extended_tile(tile_rows, tile_cols, k, family)
    return (g.table_bytes
            + (INDEX_BYTES[family] + 2 * g.element_bytes) * er * ec)


def shard_tile(family: str, ext_rows: int, ext_cols: int):
    """``(tile_rows, tile_cols, threads)`` of the shard kernel on an
    extended plane: the family's shard tile, shrunk to the plane."""
    tile_r, tile_c = SHARD_TILES[family]
    return (min(tile_r, ext_rows), min(tile_c, ext_cols),
            SHARD_THREADS[family])


def plan_shard_resident(family: str, n: int, m: int, rows_devs: int,
                        cols_devs: int, *,
                        budget_bytes: Optional[int] = None,
                        k_cap: Optional[int] = None,
                        max_overlap: Optional[float] = None
                        ) -> Optional[ShardPlan]:
    """The :class:`ShardPlan` with the largest feasible k, or ``None``
    (the per-half-sweep distributed tier).  ``budget_bytes`` is one
    block's shared memory (``None``: the card's); ``k_cap`` (``None``:
    the smaller of :data:`K_CAP` and the family's ``max_k``) and
    ``max_overlap`` (``None``: :data:`MAX_OVERLAP`) let tests pin k on
    small shards: the driver is exact at any feasible k."""
    if family not in GEOMETRY:
        raise ValueError(f"unknown resident family {family!r}; "
                         f"known: {sorted(GEOMETRY)}")
    g = GEOMETRY[family]
    budget = SMEM_BUDGET_BYTES if budget_bytes is None else budget_bytes
    overlap = MAX_OVERLAP if max_overlap is None else max_overlap
    cap = min(K_CAP, g.max_k) if k_cap is None else k_cap
    width = m // g.col_divisor
    if n % rows_devs or width % cols_devs:
        return None
    n_loc, w_loc = n // rows_devs, width // cols_devs
    if n_loc % 2:
        return None
    for k in range(max(1, cap), 0, -1):
        h = 2 * k
        if h > min(n_loc, w_loc):
            continue
        if (n_loc + 2 * h) * (w_loc + 2 * h) > overlap * n_loc * w_loc:
            continue
        tile_r, tile_c, threads = shard_tile(family, n_loc + 2 * h,
                                             w_loc + 2 * h)
        smem = shard_smem_bytes(family, tile_r, tile_c, k)
        if smem > budget:
            continue
        return ShardPlan(family=family, n=n, m=m, rows_devs=rows_devs,
                         cols_devs=cols_devs, n_loc=n_loc, w_loc=w_loc,
                         k=k, halo=h, tile_rows=tile_r, tile_cols=tile_c,
                         threads=threads, smem_bytes=smem,
                         budget_bytes=budget)
    return None


def shard_decision_attrs(family: str, n: int, m: int, rows_devs: int,
                         cols_devs: int, *,
                         budget_bytes: Optional[int] = None,
                         k_cap: Optional[int] = None) -> dict:
    """The shard planner's decision as one flat dict of JSON scalars."""
    budget = SMEM_BUDGET_BYTES if budget_bytes is None else budget_bytes
    plan = plan_shard_resident(family, n, m, rows_devs, cols_devs,
                               budget_bytes=budget, k_cap=k_cap)
    attrs = {"family": family, "grid": f"{rows_devs}x{cols_devs}",
             "sharded_resident": plan is not None, "budget_bytes": budget}
    if plan is not None:
        attrs.update(halo_k=plan.k, halo_width=plan.halo, n_loc=plan.n_loc,
                     w_loc=plan.w_loc, tile_rows=plan.tile_rows,
                     tile_cols=plan.tile_cols, smem_bytes=plan.smem_bytes,
                     halo_bytes_per_exchange=plan.halo_bytes_per_exchange)
    elif n % rows_devs or (m // GEOMETRY[family].col_divisor) % cols_devs \
            or (n // rows_devs) % 2:
        attrs["reason"] = ("lattice does not tile the device grid "
                           "evenly: per-half-sweep distributed tier")
    else:
        attrs["reason"] = ("no k satisfies halo/shared-memory/overlap "
                           "constraints: per-half-sweep distributed tier")
    return attrs
