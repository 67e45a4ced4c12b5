"""``stencil_update``: one colour half-sweep, CUDA kernel and plain version.

Replaces the Pallas kernel ``src/repro/kernels/stencil/stencil.py``
(``stencil_update``), which stages row blocks i-1, i, i+1 into TPU VMEM.
On the card (``csrc/stencil.cu``) a thread updates a word of 4 cells and
walks down its column, with the k-sweep kernels' word update: the
neighbour words read whole, lane 0 of Philox4x32-10 at counter
``(offset, 0, row*h + col, 0)`` from offset constants made once a
launch, and the integer compare of the raw draw with the table's draw
bounds (:func:`device_bounds`).  It is bound by the Philox integer
arithmetic, not by its 3 bytes per site, so no shared tiles and no
barriers.  Each thread reads only its own target cells, so the kernel
updates the target plane in place, and so does the wrapper on every
device.  :func:`stencil_update_batched` runs an ensemble's ``(B, n, h)``
planes in one launch of the kernel's member axis (``kernels._members``),
counted in ``stencil_update.launches``.
"""
from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from repro_torch.core import metropolis, rng
from repro_torch.kernels import _build
from repro_torch.kernels._members import (as_batch, check_batch, keys_arg,
                                          member_chunks, per_member)
from repro_torch.kernels.errors import note_in_place, raise_on_error


def stencil_update_plain(target, op_plane, table, *, is_black: bool,
                         seed: int, offset: int) -> torch.Tensor:
    """The plain PyTorch version: returns the updated target plane."""
    return metropolis.update_color_philox(target, op_plane, table, is_black,
                                          seed, offset)


def check_planes(*planes: torch.Tensor) -> None:
    """Raise unless the planes are 2-D contiguous int8 tensors of one
    shape on one device -- what the kernels take."""
    first = planes[0]
    for p in planes:
        if p.dtype != torch.int8 or p.dim() != 2 or not p.is_contiguous():
            raise ValueError(f"planes must be contiguous 2-D int8 tensors, "
                             f"got {p.dtype} {tuple(p.shape)}")
        if p.shape != first.shape or p.device != first.device:
            raise ValueError(f"planes differ: {tuple(p.shape)} on {p.device}"
                             f" vs {tuple(first.shape)} on {first.device}")
    if first.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {first.device}")


def _table_values(table: torch.Tensor) -> tuple:
    if table.numel() != metropolis.TABLE_SIZE:
        raise ValueError(f"acceptance table needs {metropolis.TABLE_SIZE} "
                         f"entries, got {table.numel()}")
    return tuple(table.to(torch.float32).flatten().tolist())


def bounds_arg(table: torch.Tensor):
    """The float32 table's 10 exclusive uint64 draw bounds
    (``metropolis.draw_bounds``) as a ctypes array, for the kernels that
    compare the raw draw: derived once per table."""
    return _bounds_arg(_table_values(table))


@functools.lru_cache(maxsize=64)
def _bounds_arg(values: tuple):
    bounds = metropolis.draw_bounds(np.array(values, np.float32))
    return (ctypes.c_uint64 * metropolis.TABLE_SIZE)(*bounds.tolist())


def device_bounds(table: torch.Tensor, device) -> torch.Tensor:
    """The table's 10 draw bounds (:func:`bounds_arg`) as an int64 tensor
    on the CUDA ``device``, which ``stencil_update``'s kernel reads
    through the L1 cache: made once per table and device."""
    device = torch.device(device)
    return _device_bounds(_table_values(table), device.type, device.index)


@functools.lru_cache(maxsize=64)
def _device_bounds(values: tuple, device_type: str, index):
    return torch.tensor(list(_bounds_arg(values)), dtype=torch.int64,
                        device=torch.device(device_type, index))


def device_bounds_members(tables, device) -> torch.Tensor:
    """The members' draw bounds as a ``(B, 10)`` int64 tensor on
    ``device`` (member i's at row i): made once per member set."""
    device = torch.device(device)
    return _device_bounds_members(tuple(_table_values(t) for t in tables),
                                  device.type, device.index)


@functools.lru_cache(maxsize=16)
def _device_bounds_members(values: tuple, device_type: str, index):
    return torch.tensor([list(_bounds_arg(v)) for v in values],
                        dtype=torch.int64,
                        device=torch.device(device_type, index))


def bounds_args(tables):
    """The k-sweep kernel's argument: the members' :func:`bounds_arg`
    one after another (a ctypes array of 10 B uint64 values), made once
    per member set."""
    return _bounds_args(tuple(_table_values(t) for t in tables))


@functools.lru_cache(maxsize=64)
def _bounds_args(members: tuple):
    values = [v for table in members for v in _bounds_arg(table)]
    return (ctypes.c_uint64 * len(values))(*values)


def library():
    """The compiled ``csrc/stencil.cu`` with its C signatures declared."""
    lib = _build.load("stencil")
    if lib.stencil_update_launch.argtypes is None:
        u32, i32, ptr = ctypes.c_uint32, ctypes.c_int, ctypes.c_void_p
        lib.cuda_error_string.argtypes = [i32]
        lib.cuda_error_string.restype = ctypes.c_char_p
        keys = [ctypes.POINTER(ctypes.c_uint32), i32]
        lib.stencil_update_launch.argtypes = [
            ptr, ptr, i32, i32, i32, ptr, *keys, u32, ptr]
        lib.stencil_update_launch.restype = i32
        lib.stencil_resident_smem_bytes.argtypes = [i32, i32, i32]
        lib.stencil_resident_smem_bytes.restype = ctypes.c_longlong
        lib.stencil_sweeps_resident_launch.argtypes = [
            ptr, ptr, ptr, ptr, i32, i32, ctypes.POINTER(ctypes.c_uint64),
            *keys, u32, i32, i32, i32, i32, ptr]
        lib.stencil_sweeps_resident_launch.restype = i32
        lib.stencil_max_members.argtypes = []
        lib.stencil_max_members.restype = i32
    return lib


def _launch_update(target, op_plane, tables, *, is_black: bool, seeds,
                   offset: int) -> torch.Tensor:
    """Launch the kernel on one member's ``(n, h)`` planes or a ``(B, n,
    h)`` batch's, in place, in ceil(B / limit) launches of its member
    axis, each counted on :func:`stencil_update`."""
    lib = library()
    targets, ops = as_batch(target), as_batch(op_plane)
    members, n, h = targets.shape
    bounds = device_bounds(tables[0], target.device) if members == 1 \
        else device_bounds_members(tables, target.device)
    stream = torch.cuda.current_stream(target.device).cuda_stream
    for lo, hi in member_chunks(lib, "stencil", members):
        rc = lib.stencil_update_launch(
            targets[lo].data_ptr(), ops[lo].data_ptr(), n, h, int(is_black),
            bounds.data_ptr() + 8 * metropolis.TABLE_SIZE * lo,
            keys_arg(seeds[lo:hi]), hi - lo,
            int(offset) & rng.MASK32, stream)
        raise_on_error(lib, rc, "stencil_update")
        note_in_place()
        stencil_update.launches += 1
    return target


def stencil_update(target, op_plane, table, *, is_black: bool, seed: int,
                   offset: int) -> torch.Tensor:
    """One colour half-sweep of ``target`` against ``op_plane``, in place.

    ``table`` is the 10-entry float32 acceptance table
    (``metropolis.acceptance_table``), ``seed`` a 64-bit int (both Philox
    key lanes) and ``offset`` the uint32 Philox offset of this half-sweep.
    CPU planes take the plain version; CUDA planes launch the kernel.
    Returns ``target``.
    """
    check_planes(target, op_plane)
    if target.device.type == "cpu":
        target.copy_(stencil_update_plain(
            target, op_plane, table, is_black=is_black, seed=seed,
            offset=offset))
        note_in_place()
        return target
    return _launch_update(target, op_plane, [table], is_black=is_black,
                          seeds=[seed], offset=offset)


def stencil_update_batched_plain(targets, ops, tables, *, is_black: bool,
                                 seeds, offset: int) -> torch.Tensor:
    """The plain batched version: :func:`stencil_update_plain` of each
    member (its table and seed), stacked."""
    return per_member(stencil_update_plain, (targets, ops), tables, seeds,
                      is_black=is_black, offset=offset)


def stencil_update_batched(targets, ops, tables, *, is_black: bool, seeds,
                           offset: int) -> torch.Tensor:
    """:func:`stencil_update` of B members at one offset, in place:
    ``(B, n, h)`` planes, a table and a seed a member.  CPU planes take
    the plain batched version; CUDA planes launch the kernel's member
    axis."""
    check_batch((targets, ops), tables, seeds, check_planes)
    if targets.device.type == "cpu":
        targets.copy_(stencil_update_batched_plain(
            targets, ops, tables, is_black=is_black, seeds=seeds,
            offset=offset))
        note_in_place()
        return targets
    return _launch_update(targets, ops, list(tables), is_black=is_black,
                          seeds=list(seeds), offset=offset)


#: kernel launches since the count was last set to 0 (a batched launch
#: counts once)
stencil_update.launches = 0
