"""``bitplane_sweeps_resident``: k sweeps of 32 replicas per launch.

Replaces the Pallas kernel ``src/repro/kernels/bitplane/resident.py``
(``bitplane_sweeps_resident``), which keeps both whole bit planes in TPU
VMEM for ``n_sweeps`` sweeps.  On the card (``csrc/bitplane.cu``,
``bitplane_sweeps_kernel<false, ...>``, the group loop it shares with the
shard kernel) each block loads a tile of both planes plus a halo of 2k
rows and of 2k columns rounded up to a multiple of 4 into shared
memory, so that every thread still owns whole 4-site draw groups, runs
2k half-sweeps and writes back the tile.  Draws are keyed on the global
group index, so the result is bit for bit k applications of the
half-sweep; the planner (``repro_torch.kernels.resident``) picks the
tile (columns a multiple of 4) and k.  The accept and the launch counts
as in :mod:`.bitplane`; an ensemble's planes take one launch a block of
sweeps for all its members (:func:`bitplane_sweeps_resident_batched`).
"""
from __future__ import annotations

from repro_torch.core import bitplane as bp
from repro_torch.kernels._members import check_batch, per_member
from repro_torch.kernels._words import check_resident_args, launch_resident

from .bitplane import check_bit_planes, library


def bitplane_sweeps_resident_plain(black, white, thresholds, *,
                                   n_sweeps: int, seed: int,
                                   start_offset: int):
    """The plain PyTorch version: ``n_sweeps`` applications of the
    half-sweep pair."""
    return bp.run_sweeps_bitplane(black, white, thresholds, n_sweeps, seed,
                                  start_offset)


def _check_tiles(plan) -> None:
    if plan.tile_cols % 4:
        raise ValueError(f"bitplane tiles need a multiple-of-4 width, got "
                         f"{plan.tile_cols}")


def bitplane_sweeps_resident(black, white, thresholds, *, n_sweeps: int,
                             seed: int, start_offset: int, plan):
    """``n_sweeps`` full sweeps of all 32 replicas from the cumulative
    Philox offset ``start_offset``; returns new planes and leaves the
    inputs as they were.  CPU planes take the plain version; CUDA planes
    launch the kernel."""
    check_bit_planes(black, white)
    check_resident_args(black, n_sweeps, plan)
    _check_tiles(plan)
    if black.device.type == "cpu":
        return bitplane_sweeps_resident_plain(
            black, white, thresholds, n_sweeps=n_sweeps, seed=seed,
            start_offset=start_offset)
    return launch_resident(library(), "bitplane", bitplane_sweeps_resident,
                           black, white, [thresholds], n_sweeps=n_sweeps,
                           seeds=[seed], start_offset=start_offset, plan=plan)


def bitplane_sweeps_resident_batched_plain(black, white, tables, *,
                                           n_sweeps: int, seeds,
                                           start_offset: int):
    """The plain batched version: :func:`bitplane_sweeps_resident_plain`
    of each member (its table and seed), stacked."""
    return per_member(bitplane_sweeps_resident_plain, (black, white), tables,
                      seeds, n_sweeps=n_sweeps, start_offset=start_offset)


def bitplane_sweeps_resident_batched(black, white, tables, *,
                                     n_sweeps: int, seeds,
                                     start_offset: int, plan):
    """:func:`bitplane_sweeps_resident` of B members from one offset:
    ``(B, n, w)`` planes, a threshold table and a seed a member, each
    block of sweeps one launch of the kernel's member axis (counted in
    ``bitplane_sweeps_resident.launches``, by accept as there).  CPU
    planes take the plain batched version."""
    check_batch((black, white), tables, seeds, check_bit_planes)
    check_resident_args(black, n_sweeps, plan)
    _check_tiles(plan)
    if black.device.type == "cpu":
        return bitplane_sweeps_resident_batched_plain(
            black, white, tables, n_sweeps=n_sweeps, seeds=seeds,
            start_offset=start_offset)
    return launch_resident(library(), "bitplane", bitplane_sweeps_resident,
                           black, white, list(tables), n_sweeps=n_sweeps,
                           seeds=list(seeds), start_offset=start_offset,
                           plan=plan)


#: kernel launches since the count was last set to 0 (a batched launch
#: counts once), and of them those of the general accept
bitplane_sweeps_resident.launches = 0
bitplane_sweeps_resident.general_launches = 0
