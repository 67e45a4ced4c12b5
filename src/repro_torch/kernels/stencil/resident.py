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
starting at ``half_sweep_offset(start_offset, first sweep, 0)``; an
ensemble's (:func:`stencil_sweeps_resident_batched`) as many for all its
members.
"""
from __future__ import annotations

import torch

from repro_torch.core import metropolis, rng
from repro_torch.kernels._members import (as_batch, check_batch, keys_arg,
                                          member_chunks, per_member)
from repro_torch.kernels.errors import check_shared_memory, raise_on_error

from .stencil import bounds_args, check_planes, library


def stencil_sweeps_resident_plain(black, white, table, *, n_sweeps: int,
                                  seed: int, start_offset: int):
    """The plain PyTorch version: ``n_sweeps`` applications of the
    half-sweep pair."""
    return metropolis.run_sweeps_philox(black, white, table, n_sweeps, seed,
                                        start_offset)


def _check_plan(black, n_sweeps: int, plan) -> None:
    if n_sweeps < 1:
        raise ValueError(f"n_sweeps must be >= 1, got {n_sweeps}")
    if tuple(black.shape[-2:]) != (plan.n, plan.m // 2):
        raise ValueError(f"plan is for a {plan.n}x{plan.m} lattice, planes "
                         f"are {tuple(black.shape)}")


def _launch(black, white, tables, *, n_sweeps: int, seeds,
            start_offset: int, plan):
    """The kernel over one member's ``(n, h)`` planes or a ``(B, n, h)``
    batch's: ceil(n_sweeps / k) blocks of sweeps, each in ceil(B /
    limit) launches of its member axis counted on
    :func:`stencil_sweeps_resident`; returns new planes.  A tile over the
    card's shared memory raises ``SharedMemoryOverflow`` first."""
    lib = library()
    members, n, h = as_batch(black).shape
    chunks = [(lo, hi, bounds_args(tables[lo:hi]), keys_arg(seeds[lo:hi]))
              for lo, hi in member_chunks(lib, "stencil", members)]
    stream = torch.cuda.current_stream(black.device).cuda_stream
    check_shared_memory(lib, "stencil_sweeps_resident", black.device,
                        "stencil_resident_smem_bytes", plan.tile_rows,
                        plan.tile_cols, min(plan.k, n_sweeps))
    for first in range(0, n_sweeps, plan.k):
        k = min(plan.k, n_sweeps - first)
        out_b, out_w = torch.empty_like(black), torch.empty_like(white)
        bases = [p.data_ptr() for p in (black, white, out_b, out_w)]
        for lo, hi, bounds, keys in chunks:
            rc = lib.stencil_sweeps_resident_launch(
                *(b + lo * n * h for b in bases), n, h, bounds, keys,
                hi - lo, rng.half_sweep_offset(start_offset, first, 0), k,
                plan.tile_rows, plan.tile_cols, plan.threads, stream)
            raise_on_error(lib, rc, "stencil_sweeps_resident")
            stencil_sweeps_resident.launches += 1
        black, white = out_b, out_w
    return black, white


def stencil_sweeps_resident(black, white, table, *, n_sweeps: int,
                            seed: int, start_offset: int, plan):
    """``n_sweeps`` full sweeps of ``(black, white)`` from the cumulative
    Philox offset ``start_offset``; returns new planes and leaves the
    inputs as they were.  ``plan`` is the planner's ``ResidentPlan`` for
    this lattice.  CPU planes take the plain version; CUDA planes launch
    the kernel."""
    check_planes(black, white)
    _check_plan(black, n_sweeps, plan)
    if black.device.type == "cpu":
        return stencil_sweeps_resident_plain(
            black, white, table, n_sweeps=n_sweeps, seed=seed,
            start_offset=start_offset)
    return _launch(black, white, [table], n_sweeps=n_sweeps, seeds=[seed],
                   start_offset=start_offset, plan=plan)


def stencil_sweeps_resident_batched_plain(black, white, tables, *,
                                          n_sweeps: int, seeds,
                                          start_offset: int):
    """The plain batched version: :func:`stencil_sweeps_resident_plain` of
    each member (its table and seed), stacked."""
    return per_member(stencil_sweeps_resident_plain, (black, white), tables,
                      seeds, n_sweeps=n_sweeps, start_offset=start_offset)


def stencil_sweeps_resident_batched(black, white, tables, *, n_sweeps: int,
                                    seeds, start_offset: int, plan):
    """:func:`stencil_sweeps_resident` of B members from one offset:
    ``(B, n, h)`` planes, a table and a seed a member, each block of
    sweeps one launch of the kernel's member axis (counted in
    ``stencil_sweeps_resident.launches``).  CPU planes take the plain
    batched version."""
    check_batch((black, white), tables, seeds, check_planes)
    _check_plan(black, n_sweeps, plan)
    if black.device.type == "cpu":
        return stencil_sweeps_resident_batched_plain(
            black, white, tables, n_sweeps=n_sweeps, seeds=seeds,
            start_offset=start_offset)
    return _launch(black, white, list(tables), n_sweeps=n_sweeps,
                   seeds=list(seeds), start_offset=start_offset, plan=plan)


#: kernel launches since the count was last set to 0 (a batched launch
#: counts once)
stencil_sweeps_resident.launches = 0
