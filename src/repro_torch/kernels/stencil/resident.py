"""``stencil_sweeps_resident``: k full sweeps per launch, CUDA and plain.

Replaces the Pallas kernel ``src/repro/kernels/stencil/resident.py``
(``stencil_sweeps_resident``), which keeps both whole planes in TPU VMEM
for ``n_sweeps`` sweeps.  A Hopper block has at most 227 KB of shared
memory, so the CUDA kernel (``csrc/stencil.cu``) blocks in time on tiles:
each block loads a tile of both planes plus a halo of width 2k (rows
of whole 4-cell words), runs 2k half-sweeps on the extended tile, each
one ring smaller than the last, with a barrier between them, and writes
back only the tile.  The draws are keyed on global (row, col), so the
result is bit for bit k applications of the half-sweep.  It is bound by
instruction issue (the Philox multiplies and XORs of every site), so a
thread takes 4 cells as one word, draws lane 0 of Philox with what
depends on the offset alone hoisted, and compares the raw draw with
integer bounds (``metropolis.draw_bounds`` of the float32 table, derived
once per table).  The planner (``repro_torch.kernels.resident``) picks
the tile, k and the block's threads.

A run longer than the plan's k takes ceil(n_sweeps / k) launches, each
starting at ``half_sweep_offset(start_offset, first sweep, 0)``.
"""
from __future__ import annotations

import torch

from repro_torch.core import metropolis, rng

from .stencil import bounds_arg, check_planes, library, raise_on_error


def stencil_sweeps_resident_plain(black, white, table, *, n_sweeps: int,
                                  seed: int, start_offset: int):
    """The plain PyTorch version: ``n_sweeps`` applications of the
    half-sweep pair."""
    return metropolis.run_sweeps_philox(black, white, table, n_sweeps, seed,
                                        start_offset)


def stencil_sweeps_resident(black, white, table, *, n_sweeps: int,
                            seed: int, start_offset: int, plan):
    """``n_sweeps`` full sweeps of ``(black, white)`` from the cumulative
    Philox offset ``start_offset``; returns new planes and leaves the
    inputs as they were.  ``plan`` is the planner's ``ResidentPlan`` for
    this lattice.  CPU planes take the plain version; CUDA planes launch
    the kernel."""
    check_planes(black, white)
    if n_sweeps < 1:
        raise ValueError(f"n_sweeps must be >= 1, got {n_sweeps}")
    if tuple(black.shape) != (plan.n, plan.m // 2):
        raise ValueError(f"plan is for a {plan.n}x{plan.m} lattice, planes "
                         f"are {tuple(black.shape)}")
    if black.device.type == "cpu":
        return stencil_sweeps_resident_plain(
            black, white, table, n_sweeps=n_sweeps, seed=seed,
            start_offset=start_offset)
    lib = library()
    n, h = black.shape
    k0, k1 = rng.seed_keys(seed)
    bounds = bounds_arg(table)
    stream = torch.cuda.current_stream(black.device).cuda_stream
    for first in range(0, n_sweeps, plan.k):
        k = min(plan.k, n_sweeps - first)
        out_b, out_w = torch.empty_like(black), torch.empty_like(white)
        rc = lib.stencil_sweeps_resident_launch(
            black.data_ptr(), white.data_ptr(), out_b.data_ptr(),
            out_w.data_ptr(), n, h, bounds, k0, k1,
            rng.half_sweep_offset(start_offset, first, 0), k,
            plan.tile_rows, plan.tile_cols, plan.threads, stream)
        raise_on_error(lib, rc, "stencil_sweeps_resident")
        stencil_sweeps_resident.launches += 1
        black, white = out_b, out_w
    return black, white


#: kernel launches since the count was last set to 0
stencil_sweeps_resident.launches = 0
