"""Planner of the k-sweep ("resident") tier, re-derived for Hopper.

The JAX package's planner (``repro/kernels/resident.py``) asks whether
both whole planes fit a TPU core's VMEM.  A Hopper block has at most
227 KB of shared memory, far less than a lattice, so the CUDA kernel
blocks in time on tiles instead (``csrc/stencil.cu``): a block holds a
tile of both planes plus a halo of width 2k and runs k full sweeps on
it.  The plan therefore fixes the tile and k, and its budget is the
shared memory of one block.

Rule (measured on the card, ``PERF.md``): a (TILE_ROWS x TILE_COLS)
tile, shrunk to the plane where the plane is smaller, with the largest
k <= MAX_SWEEPS_PER_LAUNCH whose extended tile fits the budget; no plan
(the per-half-sweep tier) when not even k = 1 fits.  The budget is the
one value that moves that boundary: ``Session.open(...,
resident_budget_bytes=)`` passes it down to :func:`plan_resident`, so
that tests and ``chip_smoke.py`` can send the same session through
either tier.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

#: dynamic shared memory one block may use on an H100 (227 KB)
SMEM_BUDGET_BYTES: int = 232448

#: sweeps per launch: the halo (2k) grows with k, and so does the share
#: of redundant draws in the extended tile; k = 2 took the least time
#: per sweep at 32768^2 (``PERF.md``)
MAX_SWEEPS_PER_LAUNCH: int = 2

#: tile of the compact plane, rows x columns; 256 columns keep a warp's
#: loads on consecutive bytes
TILE_ROWS: int = 128
TILE_COLS: int = 256

_FAMILIES = ("stencil",)


@dataclasses.dataclass(frozen=True)
class ResidentPlan:
    """A positive decision: this (family, lattice) runs k sweeps per
    launch on (tile_rows, tile_cols) tiles of the compact planes."""

    family: str
    n: int
    m: int
    k: int
    tile_rows: int
    tile_cols: int
    smem_bytes: int
    budget_bytes: int


def smem_bytes(tile_rows: int, tile_cols: int, k: int) -> int:
    """Shared memory of one block for k sweeps: global row and column
    indices of the extended tile, the acceptance table (padded to 16
    floats) and both extended int8 planes (the layout of
    ``stencil_sweeps_resident_kernel``)."""
    er = tile_rows + 4 * k
    ec = tile_cols + 4 * k
    return 4 * (er + ec) + 4 * 16 + 2 * er * ec


def plan_resident(family: str, n: int, m: int,
                  budget_bytes: Optional[int] = None
                  ) -> Optional[ResidentPlan]:
    """The k-sweep plan for one (family, lattice), or ``None`` for the
    per-half-sweep tier.  ``budget_bytes`` is one block's shared memory;
    ``None`` means the card's, :data:`SMEM_BUDGET_BYTES`."""
    if family not in _FAMILIES:
        raise ValueError(f"unknown resident family {family!r}; "
                         f"ported: {list(_FAMILIES)}")
    budget = SMEM_BUDGET_BYTES if budget_bytes is None else budget_bytes
    tile_rows = min(TILE_ROWS, n)
    tile_cols = min(TILE_COLS, m // 2)
    for k in range(MAX_SWEEPS_PER_LAUNCH, 0, -1):
        need = smem_bytes(tile_rows, tile_cols, k)
        if need <= budget:
            return ResidentPlan(family=family, n=n, m=m, k=k,
                                tile_rows=tile_rows, tile_cols=tile_cols,
                                smem_bytes=need, budget_bytes=budget)
    return None
