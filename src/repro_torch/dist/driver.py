"""Driver of the sharded resident tier (counterpart of ``repro.dist.driver``).

``make_resident_step(mesh, plan)`` advances a mesh's shards by k sweeps
per halo exchange instead of exchanging 1-wide halos every half-sweep
(``repro_torch.core.distributed``).  For each block of k sweeps every
shard

1. **gathers** a halo ring of width ``h = 2k`` (:func:`extend`): columns
   first, then rows of the column-extended planes, so that the row
   strips carry the corners (a diagonal neighbour's cells arrive in two
   hops);
2. **sweeps** k full sweeps of its extended plane in one launch of the
   family's shard kernel (``repro_torch.dist.kernels``), the draws keyed
   on index planes of true global positions;
3. **keeps** its interior ``[h:-h, h:-h]``, exact because wrong values
   creep inward one ring per half-sweep.

A remainder block of ``n_sweeps % k`` sweeps uses the same halo.  The
index planes hold true positions modulo the lattice, computed in int64
and masked to 32 bits (the JAX package's int32 products wrap the same
way past 2^31 cells); they are built once, when the step is made.
Offsets advance by ``rng.half_sweep_offset`` from a half-sweep-unit
``start``, so the trajectory is the single-device one on any mesh.

:func:`extend` writes the strips and the interior straight into one
preallocated extended buffer per shard (one copy, where two
concatenations would make two).  Each block's gather is a
``dist.extend`` span (the host's copies, which do not wait for them).
"""
from __future__ import annotations

import torch

import repro_torch.telemetry as tel
from repro_torch.core import lattice as lat
from repro_torch.core import rng
from repro_torch.core.distributed import ShardGrid, ring_shift

from . import kernels as dk
from .planner import ShardPlan

_KERNELS = {"stencil": dk.stencil_shard_sweeps,
            "multispin": dk.multispin_shard_sweeps,
            "bitplane": dk.bitplane_shard_sweeps}


def extend(xs, grid: ShardGrid, h: int) -> list:
    """Every shard of ``xs`` extended by ``h`` rings of its neighbours'
    cells (the periodic wrap across the mesh): ``(n_loc + 2h, w_loc +
    2h)`` tensors on the shards' devices.  Needs ``h <= min(n_loc,
    w_loc)``."""
    mesh, n, w = grid.mesh, grid.n_loc, grid.w_loc
    if h > min(n, w):
        raise ValueError(f"halo {h} is wider than a ({n}, {w}) shard")
    left = ring_shift([x[:, -h:] for x in xs], mesh, grid.col_axes, +1)
    right = ring_shift([x[:, :h] for x in xs], mesh, grid.col_axes, -1)
    ext = []
    for x, lft, rgt in zip(xs, left, right):
        e = torch.empty((n + 2 * h, w + 2 * h), dtype=x.dtype, device=x.device)
        e[h:h + n, h:h + w] = x
        e[h:h + n, :h] = lft
        e[h:h + n, h + w:] = rgt
        ext.append(e)
    # rows [h, 2h) and [n, n + h) of every buffer are filled and are not
    # among the rows written below, since h <= n
    top = ring_shift([e[n:n + h] for e in ext], mesh, grid.row_axes, +1)
    bottom = ring_shift([e[h:2 * h] for e in ext], mesh, grid.row_axes, -1)
    for e, t, b in zip(ext, top, bottom):
        e[:h] = t
        e[n + h:] = b
    return ext


def index_planes(plan: ShardPlan, grid: ShardGrid, i: int) -> tuple:
    """The index planes of shard ``i``'s extended plane (int32 tensors
    holding uint32 values): the global site or word index, or for
    bitplane the global 4-site group and the lane."""
    rows, cols = grid.positions(i, plan.halo)
    if plan.family == "bitplane":
        g = (rows[:, None] * (plan.width // 4) + cols[None, :] // 4)
        lane = (cols % 4).expand_as(g)
        return (lat.u32_to_words(g & rng.MASK32),
                lane.to(torch.int32).contiguous())
    return (lat.u32_to_words((rows[:, None] * plan.width + cols[None, :])
                             & rng.MASK32),)


def make_resident_step(mesh, plan: ShardPlan, *, seed: int = 0,
                       row_axes=None, col_axes=None):
    """The sharded resident sweep of ``mesh`` under ``plan``:
    ``step(black, white, table, start, n_sweeps)`` advances the lists of
    shards by ``n_sweeps`` sweeps from the half-sweep offset ``start``
    (pass ``2 * step_count``) and returns new lists; ``table`` is the
    family's acceptance table or thresholds."""
    grid = ShardGrid.of(mesh, plan.n, plan.width, row_axes, col_axes)
    if (grid.rows_devs, grid.cols_devs) != (plan.rows_devs, plan.cols_devs):
        raise ValueError(f"plan grid {plan.rows_devs}x{plan.cols_devs} != "
                         f"mesh grid {grid.rows_devs}x{grid.cols_devs}")
    kernel, h, k = _KERNELS[plan.family], plan.halo, plan.k
    tile = (plan.tile_rows, plan.tile_cols, plan.threads)
    index = [index_planes(plan, grid, i) for i in range(mesh.size)]

    def block(black, white, table, offset, sweeps):
        with tel.span("dist.extend", halo=h, shards=mesh.size):
            bx, wx = extend(black, grid, h), extend(white, grid, h)
        out_b, out_w = [], []
        for i in range(mesh.size):
            b, w = kernel(bx[i], wx[i], table, *index[i], n_sweeps=sweeps,
                          seed=seed, start_offset=offset, tile=tile)
            out_b.append(b[h:-h, h:-h])
            out_w.append(w[h:-h, h:-h])
        return out_b, out_w

    def step(black, white, table, start: int, n_sweeps: int):
        if n_sweeps < 1:
            raise ValueError(f"n_sweeps must be >= 1, got {n_sweeps}")
        n_blocks, rem = divmod(n_sweeps, k)
        for j in range(n_blocks):
            black, white = block(black, white, table,
                                 rng.half_sweep_offset(start, k * j, 0), k)
        if rem:
            black, white = block(black, white, table,
                                 rng.half_sweep_offset(start, k * n_blocks,
                                                       0), rem)
        return ([b.contiguous() for b in black],
                [w.contiguous() for w in white])
    return step
