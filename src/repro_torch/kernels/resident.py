"""Planner of the k-sweep ("resident") tier, re-derived for Hopper.

The JAX package's planner (``repro/kernels/resident.py``) asks whether
both whole planes fit a TPU core's VMEM.  A Hopper block has at most
227 KB of shared memory, far less than a lattice, so the CUDA kernels
block in time on tiles instead (``csrc/stencil.cu``, ``multispin.cu``,
``bitplane.cu``): a block holds a tile of both planes plus a halo of
width 2k and runs k full sweeps on it.  The plan therefore fixes the
tile and k, and its budget is the shared memory of one block.

Each family has its own geometry (:data:`GEOMETRY`): the element of its
planes (int8 sites, uint32 words of 8 nibble spins, uint32 words of 32
replica bits), its tile, its cap on k and its block size, each the
fastest k-sweep configuration measured on the card
(``python -m repro_torch.analysis.tune_resident``, ``PERF.md``).  Rule:
the family's tile, shrunk to the plane where the plane is smaller, with
the largest k <= the cap whose extended tile fits the budget; no plan
(the per-half-sweep tier) when not even k = 1 fits.  The budget is the
one value that moves that boundary:
``Session.open(..., resident_budget_bytes=)`` passes it down to
:func:`plan_resident`, so that tests and ``chip_smoke.py`` can send the
same session through either tier.

The rule takes the k-sweep tier wherever a tile fits, also where it is
not the faster tier.  On an H100 SXM at 700 W (``PERF.md`` section 6)
it is for multispin and, since its group loop was redesigned, for
bitplane (0.84 against 1.09 ms a sweep at 16384^2, where it was 1.30
against 1.22), but no longer for stencil at 32768^2, whose
per-half-sweep kernel, redesigned too, takes 3.27 ms a sweep against
the k-sweep kernel's 3.46.  Choosing the tier by measurement is open
work (``ROADMAP.md``, Queue 2).
"""
from __future__ import annotations

import dataclasses
from typing import Optional

#: dynamic shared memory one block may use on an H100 (227 KB)
SMEM_BUDGET_BYTES: int = 232448

#: stencil: sweeps per launch; the halo (2k) grows with k, and so does
#: the share of redundant draws in the extended tile; k = 2 took the
#: least time per sweep at 32768^2 (``PERF.md``)
MAX_SWEEPS_PER_LAUNCH: int = 2

#: stencil: tile of the compact plane, rows x columns.  A lane takes a
#: word of 4 cells and a warp a row, so 504 columns and a halo of 4 on
#: each side make rows of 128 words, four whole passes of a warp; 64
#: rows leave three 74 KB blocks an SM (the fastest k = 2 candidate of
#: ``tune_resident`` at 32768^2, ``PERF.md``)
TILE_ROWS: int = 64
TILE_COLS: int = 504

#: stencil: threads of a k-sweep block
THREADS: int = 256


@dataclasses.dataclass(frozen=True)
class Geometry:
    """How one family's k-sweep kernel tiles its planes."""

    #: plane columns per lattice column: the plane is (n, m // divisor)
    col_divisor: int
    #: bytes of one plane element
    element_bytes: int
    #: the column halo (and the tile's column origin) are multiples of
    #: this: the bitplane kernel draws one Philox call per 4-site group
    col_align: int
    #: the left halo and each extended row are rounded up to a multiple
    #: of this many plane elements (stencil: the 4 int8 cells of a
    #: thread's 32-bit word; multispin: the 4 words of a 16-byte load)
    row_word: int
    #: bytes of the acceptance table in shared memory
    table_bytes: int
    #: the planes start at a multiple of this many bytes of shared memory
    plane_align: int
    tile_rows: int
    tile_cols: int
    max_k: int
    #: threads of a k-sweep block
    threads: int


GEOMETRY = {
    # int8 cells in 32-bit words, the 10 uint64 draw bounds in 128 bytes
    "stencil": Geometry(col_divisor=2, element_bytes=1, col_align=1,
                        row_word=4, table_bytes=128,
                        plane_align=16, tile_rows=TILE_ROWS,
                        tile_cols=TILE_COLS, max_k=MAX_SWEEPS_PER_LAUNCH,
                        threads=THREADS),
    # uint32 words of 8 spins, the left halo and each extended row
    # rounded up to 4 words (16-byte loads), the 256 threshold pairs of a
    # key byte in 2 KiB; two uint32 planes of stencil's 64 x 504 tile
    # would take 270 KiB, over the budget.  40 x 248 words: rows of 256
    # words (8 whole passes of a warp) with the halo at k = 2, two 98 KiB
    # blocks an SM, the fastest k = 2 candidate of ``tune_resident`` at
    # 32768^2 (96 x 120 within 0.1 %)
    "multispin": Geometry(col_divisor=16, element_bytes=4, col_align=1,
                          row_word=4, table_bytes=2048,
                          plane_align=16, tile_rows=40, tile_cols=248,
                          max_k=2, threads=512),
    # uint32 words of 32 replica bits; tile columns in 4-site groups, each
    # moved as one 16-byte access, a lane a group: 248 words and the halo
    # at k = 2 make rows of 64 groups, two passes of a warp; two 96 KiB
    # blocks an SM; the fastest k = 2 candidate of ``tune_resident`` at
    # 16384^2 (``PERF.md``)
    "bitplane": Geometry(col_divisor=2, element_bytes=4, col_align=4,
                         row_word=1, table_bytes=0, plane_align=16,
                         tile_rows=40, tile_cols=248, max_k=2, threads=512),
}


@dataclasses.dataclass(frozen=True)
class ResidentPlan:
    """A positive decision: this (family, lattice) runs k sweeps per
    launch on (tile_rows, tile_cols) tiles of its planes (columns in
    plane elements: sites or words)."""

    family: str
    n: int
    m: int
    k: int
    tile_rows: int
    tile_cols: int
    smem_bytes: int
    budget_bytes: int
    threads: int


def col_halo(k: int, family: str = "stencil") -> int:
    """Columns of halo on each side of a tile for k sweeps: 2k, rounded
    up to the family's column alignment."""
    align = GEOMETRY[family].col_align
    return -(-2 * k // align) * align


def extended_tile(tile_rows: int, tile_cols: int, k: int,
                  family: str = "stencil"):
    """``(rows, columns)`` of a tile with its halo for k sweeps, as the
    family's kernels hold it in shared memory: 2k rows above and below,
    :func:`col_halo` columns on each side, rounded up to whole words of
    ``row_word`` elements (the left halo, then the row)."""
    g = GEOMETRY[family]
    halo = -(-col_halo(k, family) // g.row_word) * g.row_word
    ec = -(-(tile_cols + 2 * halo) // g.row_word) * g.row_word
    return tile_rows + 4 * k, ec


def smem_bytes(tile_rows: int, tile_cols: int, k: int,
               family: str = "stencil") -> int:
    """Shared memory of one block for k sweeps: the acceptance table
    (stencil: its draw bounds; multispin: its threshold pairs) and both
    extended planes (the layout of the family's k-sweep kernel)."""
    g = GEOMETRY[family]
    er, ec = extended_tile(tile_rows, tile_cols, k, family)
    header = -(-g.table_bytes // g.plane_align) * g.plane_align
    return header + 2 * g.element_bytes * er * ec


def plan_resident(family: str, n: int, m: int,
                  budget_bytes: Optional[int] = None
                  ) -> Optional[ResidentPlan]:
    """The k-sweep plan for one (family, lattice), or ``None`` for the
    per-half-sweep tier.  ``budget_bytes`` is one block's shared memory;
    ``None`` means the card's, :data:`SMEM_BUDGET_BYTES`."""
    if family not in GEOMETRY:
        raise ValueError(f"unknown resident family {family!r}; "
                         f"ported: {sorted(GEOMETRY)}")
    g = GEOMETRY[family]
    budget = SMEM_BUDGET_BYTES if budget_bytes is None else budget_bytes
    tile_rows = min(g.tile_rows, n)
    tile_cols = min(g.tile_cols, m // g.col_divisor)
    for k in range(g.max_k, 0, -1):
        need = smem_bytes(tile_rows, tile_cols, k, family)
        if need <= budget:
            return ResidentPlan(family=family, n=n, m=m, k=k,
                                tile_rows=tile_rows, tile_cols=tile_cols,
                                smem_bytes=need, budget_bytes=budget,
                                threads=g.threads)
    return None
