"""Per-shard k-sweep kernels of the sharded resident tier, CUDA and plain.

Replace the three Pallas kernels of ``src/repro/dist/kernels.py``
(``stencil_shard_sweeps``, ``multispin_shard_sweeps``,
``bitplane_shard_sweeps``).  Each runs ``n_sweeps`` full sweeps of one
*halo-extended* shard: every half-sweep updates the whole extended
plane with wrap taps (the edge rings read garbage, which creeps inward
one ring per half-sweep, so the caller's interior ``[h:-h, h:-h]`` is
exact for ``h = 2 n_sweeps``), takes the row parity from the extended
plane's own row index, and keys the draws on index planes of the true
global positions (uint32 values in int32 tensors): a site index
``gidx`` (stencil), a word index ``widx`` (multispin), or a group index
``gidx`` and lane ``lane`` per site (bitplane: lane 0, 1, 2, else 3 of
one Philox call per site).

On the card the kernels (``csrc/{stencil,multispin,bitplane}.cu``) are
the temporal blocking of the family's k-sweep kernel applied to the
extended plane as if it were a lattice: each block stages a tile of the
planes and of the index planes, with a halo of 2 ``n_sweeps`` cells
wrapped over the extended plane's own dims, in shared memory, runs the
half-sweeps there and writes the tile back.  So they equal their plain
versions on the whole extended plane, edge rings included.  Like the
single-device k-sweep kernels they are bound by Philox arithmetic; the
index planes add 4 bytes per cell (8 for bitplane) to what a launch
reads.  The bitplane kernel takes a thread per 4-word group and makes
one Philox call per group where the group's 4 words carry one ``gidx``
and the lanes 0, 1, 2, 3 in order (every group of the driver's planes
at k = 2), as ``bitplane_sweeps_resident`` does, and one per word
elsewhere, as the TPU kernel does everywhere.

The plain versions are the port's plain half-sweeps keyed on the index
planes (``core.metropolis.index_uniforms``, ``core.multispin.
update_color_packed(widx=)``, ``core.bitplane.update_color_bitplane(
gidx=, lane=)``).  A wrapper takes its plain version for CPU tensors and
launches its kernel for CUDA tensors; it returns new planes.  Stencil
takes the 10-entry float32 acceptance table (its kernel compares the raw
draw with the table's ``metropolis.draw_bounds``), the word families the
10 uint32 thresholds (the multispin kernel as the 16-entry
``key_table``, the bitplane kernel as ``accept_arg``: t4 and t8 for its
three-threshold accept, all 10 for a table of another layout), as their
single-device kernels do.  Each kernel shares the site, word or group
loop of its family's k-sweep kernel, keyed on the staged ``gidx`` or
``widx``.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.core import bitplane as bp
from repro_torch.core import metropolis, rng
from repro_torch.core import multispin as ms
from repro_torch.kernels import _build
from repro_torch.kernels._words import (accept_arg, check_words,
                                        count_launch, key_table_arg,
                                        table_argtypes)
from repro_torch.kernels.stencil.stencil import (bounds_arg, check_planes,
                                                 raise_on_error)

from .planner import shard_tile


def _sweeps(half_sweep, black, white, n_sweeps: int, start_offset: int):
    """``n_sweeps`` x (black, white) applications of ``half_sweep(target,
    op, is_black, offset)`` at ``half_sweep_offset(start_offset, i, c)``."""
    for i in range(n_sweeps):
        black = half_sweep(black, white, True,
                           rng.half_sweep_offset(start_offset, i, 0))
        white = half_sweep(white, black, False,
                           rng.half_sweep_offset(start_offset, i, 1))
    return black, white


def stencil_shard_sweeps_plain(black, white, table, gidx, *, n_sweeps: int,
                               seed: int, start_offset: int):
    """The plain PyTorch version: the int8 half-sweep with its uniforms
    drawn at ``gidx``."""
    return _sweeps(lambda t, op, is_black, off: metropolis.update_color(
        t, op, metropolis.index_uniforms(gidx, seed, off), table, is_black),
        black, white, n_sweeps, start_offset)


def multispin_shard_sweeps_plain(black, white, thresholds, widx, *,
                                 n_sweeps: int, seed: int,
                                 start_offset: int):
    """The plain PyTorch version: the packed half-sweep keyed on
    ``widx``."""
    return _sweeps(lambda t, op, is_black, off: ms.update_color_packed(
        t, op, thresholds, is_black, seed, off, widx=widx),
        black, white, n_sweeps, start_offset)


def bitplane_shard_sweeps_plain(black, white, thresholds, gidx, lane, *,
                                n_sweeps: int, seed: int,
                                start_offset: int):
    """The plain PyTorch version: the bitplane half-sweep with one draw
    per site from ``gidx`` and ``lane``."""
    return _sweeps(lambda t, op, is_black, off: bp.update_color_bitplane(
        t, op, thresholds, is_black, seed, off, gidx=gidx, lane=lane),
        black, white, n_sweeps, start_offset)


def library(family: str):
    """The compiled ``csrc/<family>.cu`` with the shard kernel's C
    signatures declared."""
    lib = _build.load(family)
    launch = getattr(lib, f"{family}_shard_sweeps_launch")
    if launch.argtypes is None:
        u32, i32, ptr = ctypes.c_uint32, ctypes.c_int, ctypes.c_void_p
        table = ([ctypes.POINTER(ctypes.c_uint64)] if family == "stencil"
                 else table_argtypes(family))
        planes = [ptr] * (6 if family == "bitplane" else 5)
        lib.cuda_error_string.argtypes = [i32]
        lib.cuda_error_string.restype = ctypes.c_char_p
        launch.argtypes = planes + [i32, i32, *table, u32, u32, u32, i32, i32,
                                    i32, i32, ptr]
        launch.restype = i32
        smem = getattr(lib, f"{family}_shard_smem_bytes")
        smem.argtypes = [i32, i32, i32]
        smem.restype = ctypes.c_longlong
    return lib


def _launch(family, wrapper, inputs, black, white, table: tuple, *,
            n_sweeps, seed, start_offset, tile):
    """Launch ``family``'s shard kernel once over ``n_sweeps`` sweeps of
    the extended planes with its threshold arguments ``table``, counting
    the launch on ``wrapper``; returns new planes."""
    lib = library(family)
    n, w = black.shape
    tile_r, tile_c, threads = shard_tile(family, n, w) if tile is None \
        else tile
    k0, k1 = rng.seed_keys(seed)
    out_b, out_w = torch.empty_like(black), torch.empty_like(white)
    # a mesh's shards may live on several cards: launch on the shard's
    with torch.cuda.device(black.device):
        rc = getattr(lib, f"{family}_shard_sweeps_launch")(
            *(t.data_ptr() for t in inputs), out_b.data_ptr(),
            out_w.data_ptr(), n, w, *table, k0, k1,
            int(start_offset) & rng.MASK32, n_sweeps, tile_r, tile_c,
            threads, torch.cuda.current_stream(black.device).cuda_stream)
    raise_on_error(lib, rc, wrapper.__name__)
    count_launch(wrapper, table)
    return out_b, out_w


def _check(black, n_sweeps: int, *index) -> None:
    check_words(*index)
    if index[0].shape != black.shape or index[0].device != black.device:
        raise ValueError(f"index planes {tuple(index[0].shape)} on "
                         f"{index[0].device} do not match the planes "
                         f"{tuple(black.shape)} on {black.device}")
    if n_sweeps < 1:
        raise ValueError(f"n_sweeps must be >= 1, got {n_sweeps}")


def stencil_shard_sweeps(black, white, table, gidx, *, n_sweeps: int,
                         seed: int, start_offset: int, tile=None):
    """``n_sweeps`` sweeps of one halo-extended int8 shard ``(black,
    white)`` keyed on the site-index plane ``gidx``, from the cumulative
    Philox offset ``start_offset``; returns new planes.  ``tile`` is the
    kernel's ``(tile_rows, tile_cols, threads)`` (default
    ``planner.shard_tile``).  CPU planes take the plain version; CUDA
    planes launch the kernel."""
    check_planes(black, white)
    _check(black, n_sweeps, gidx)
    if black.device.type == "cpu":
        return stencil_shard_sweeps_plain(
            black, white, table, gidx, n_sweeps=n_sweeps, seed=seed,
            start_offset=start_offset)
    return _launch("stencil", stencil_shard_sweeps, (black, white, gidx),
                   black, white, (bounds_arg(table),), n_sweeps=n_sweeps,
                   seed=seed, start_offset=start_offset, tile=tile)


def multispin_shard_sweeps(black, white, thresholds, widx, *,
                           n_sweeps: int, seed: int, start_offset: int,
                           tile=None):
    """``n_sweeps`` sweeps of one halo-extended word shard keyed on the
    word-index plane ``widx``; as :func:`stencil_shard_sweeps`."""
    check_words(black, white)
    _check(black, n_sweeps, widx)
    if black.device.type == "cpu":
        return multispin_shard_sweeps_plain(
            black, white, thresholds, widx, n_sweeps=n_sweeps, seed=seed,
            start_offset=start_offset)
    return _launch("multispin", multispin_shard_sweeps, (black, white, widx),
                   black, white, (key_table_arg(thresholds),),
                   n_sweeps=n_sweeps, seed=seed, start_offset=start_offset,
                   tile=tile)


def bitplane_shard_sweeps(black, white, thresholds, gidx, lane, *,
                          n_sweeps: int, seed: int, start_offset: int,
                          tile=None):
    """``n_sweeps`` sweeps of one halo-extended 32-replica bit shard keyed
    on the group-index and lane planes ``gidx`` and ``lane``; as
    :func:`stencil_shard_sweeps`."""
    check_words(black, white)
    _check(black, n_sweeps, gidx, lane)
    if black.device.type == "cpu":
        return bitplane_shard_sweeps_plain(
            black, white, thresholds, gidx, lane, n_sweeps=n_sweeps,
            seed=seed, start_offset=start_offset)
    return _launch("bitplane", bitplane_shard_sweeps,
                   (black, white, gidx, lane), black, white,
                   accept_arg(thresholds), n_sweeps=n_sweeps, seed=seed,
                   start_offset=start_offset, tile=tile)


#: kernel launches since the count was last set to 0 (the bitplane
#: kernel's of the general accept also in ``general_launches``, as
#: ``repro_torch.kernels.bitplane`` counts them)
stencil_shard_sweeps.launches = 0
multispin_shard_sweeps.launches = 0
bitplane_shard_sweeps.launches = 0
bitplane_shard_sweeps.general_launches = 0
