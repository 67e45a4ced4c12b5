"""What the two word-plane kernel families share: their plain C interface
(``csrc/multispin.cu`` and ``csrc/bitplane.cu`` export the same four
functions under their family's name), the checks of their arguments and
the launch loops of their kernels, for one member or an ensemble's
(``repro_torch.kernels._members``).

Word planes are ``torch.int32`` tensors holding the uint32 bits; the
thresholds an int64 tensor of 10 uint32 values
(``repro_torch.core.multispin.acceptance_thresholds``), which the
multispin k-sweep and shard kernels take as the 16-entry
:func:`key_table` and the bitplane kernels as :func:`accept_arg`: t4 and
t8 where the table has a ferromagnet's three values, else all 10.  A
launch of several members passes their tables one after another, an
argument made once per member set (``_members_args``).
"""
from __future__ import annotations

import ctypes
import functools
from typing import Optional

import torch

from repro_torch.core import rng
from repro_torch.kernels._members import as_batch, keys_arg, member_chunks
from repro_torch.kernels.errors import (check_shared_memory, note_in_place,
                                        raise_on_error)
from repro_torch.kernels.resident import GEOMETRY

#: entries of the threshold table
N_CLASSES = 10

#: entries of the multispin k-sweep and shard kernels' table
N_KEYS = 16

#: a ferromagnet's threshold table (index s * 5 + c, c the count of up
#: neighbours): 0xFFFFFFFF where the energy does not rise; t4 (argument
#: -4 beta) at (1, 3) and (0, 1); t8 (-8 beta) at (1, 4) and (0, 0)
ALWAYS = (2, 3, 4, 5, 6, 7)
T4_CLASSES = (8, 1)
T8_CLASSES = (9, 0)


def check_words(*planes: torch.Tensor, align: int = 4) -> None:
    """Raise unless the planes are 2-D contiguous int32 word tensors of
    one shape on one device, each starting at a multiple of ``align``
    bytes -- what the kernels take."""
    first = planes[0]
    for p in planes:
        if p.dtype != torch.int32 or p.dim() != 2 or not p.is_contiguous():
            raise ValueError(f"word planes must be contiguous 2-D int32 "
                             f"tensors, got {p.dtype} {tuple(p.shape)}")
        if p.shape != first.shape or p.device != first.device:
            raise ValueError(f"planes differ: {tuple(p.shape)} on {p.device}"
                             f" vs {tuple(first.shape)} on {first.device}")
        if p.device.type == "cuda" and p.data_ptr() % align:
            raise ValueError(f"word planes must start at a multiple of "
                             f"{align} bytes")
    if first.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {first.device}")


def check_resident_args(black, n_sweeps: int, plan) -> None:
    """Raise unless ``n_sweeps`` is positive and ``plan`` is for planes of
    ``black``'s shape (of each member's, for a ``(B, n, w)`` batch)."""
    if n_sweeps < 1:
        raise ValueError(f"n_sweeps must be >= 1, got {n_sweeps}")
    width = plan.m // GEOMETRY[plan.family].col_divisor
    if tuple(black.shape[-2:]) != (plan.n, width):
        raise ValueError(f"plan is for a {plan.n}x{plan.m} lattice, planes "
                         f"are {tuple(black.shape)}")


def _values(thresholds: torch.Tensor) -> tuple:
    """The 10 uint32 thresholds as a tuple of ints (the caches' key)."""
    if thresholds.numel() != N_CLASSES:
        raise ValueError(f"threshold table needs {N_CLASSES} entries, got "
                         f"{thresholds.numel()}")
    return tuple(int(v) & rng.MASK32 for v in thresholds.flatten().tolist())


def thresholds_arg(thresholds: torch.Tensor):
    """The 10 uint32 thresholds as a ctypes array (passed by value)."""
    return (ctypes.c_uint32 * N_CLASSES)(*_values(thresholds))


def _three(values: tuple) -> Optional[tuple]:
    if any(values[i] != rng.MASK32 for i in ALWAYS):
        return None
    t4, t8 = (values[c[0]] for c in (T4_CLASSES, T8_CLASSES))
    if any(values[i] != t4 for i in T4_CLASSES) or \
            any(values[i] != t8 for i in T8_CLASSES):
        return None
    return t4, t8


def three_thresholds(thresholds: torch.Tensor) -> Optional[tuple]:
    """``(t4, t8)`` where the thresholds have a ferromagnet's layout
    (:data:`ALWAYS`, :data:`T4_CLASSES`, :data:`T8_CLASSES`), which the
    bitplane kernels' three-threshold accept takes; else ``None``."""
    return _three(_values(thresholds))


def accept_arg(thresholds: torch.Tensor) -> tuple:
    """The bitplane kernels' accept: ``(array, 2)`` of t4 and t8 for the
    three-threshold accept where :func:`three_thresholds` finds them,
    else ``(array, 10)`` of all 10 for the general one (ctypes arrays):
    :func:`accept_args` of one member."""
    return accept_args([thresholds])


def _key_table(values: tuple) -> list:
    return [values[(key >> 3) * 5 + (key & 7)] if key & 7 <= 4 else 0
            for key in range(N_KEYS)]


def key_table(thresholds: torch.Tensor) -> list:
    """The 16 uint32 entries that ``csrc/multispin.cu``'s k-sweep and
    shard kernels index by a word's key nibble ``s * 8 + c`` (spin s at
    bit 3, the count c <= 4 of up neighbours below it): entry ``s * 8 +
    c`` is threshold ``s * 5 + c``; entries 5-7 and 13-15, which no
    nibble takes, are 0."""
    return _key_table(_values(thresholds))


def key_table_arg(thresholds: torch.Tensor):
    """:func:`key_table` as a ctypes array (passed by value)."""
    return (ctypes.c_uint32 * N_KEYS)(*key_table(thresholds))


def _u32_array(values) -> ctypes.Array:
    return (ctypes.c_uint32 * len(values))(*values)


@functools.lru_cache(maxsize=64)
def _members_args(kind: str, members: tuple) -> tuple:
    """The launch argument ``kind`` of the members' threshold values,
    made once per member set (a launch only reads it)."""
    if kind == "thresholds":
        return (_u32_array([v for values in members for v in values]),)
    if kind == "key_table":
        return (_u32_array([v for values in members
                            for v in _key_table(values)]),)
    threes = [_three(values) for values in members]
    if any(three is None for three in threes):
        return (_u32_array([v for values in members for v in values]),
                N_CLASSES)
    return _u32_array([v for three in threes for v in three]), 2


def thresholds_args(tables) -> tuple:
    """``multispin_update``'s threshold argument for the members'
    ``tables``: their :func:`thresholds_arg` one after another."""
    return _members_args("thresholds", tuple(_values(t) for t in tables))


def key_table_args(tables) -> tuple:
    """The multispin k-sweep kernel's argument: the members'
    :func:`key_table_arg` one after another."""
    return _members_args("key_table", tuple(_values(t) for t in tables))


def accept_args(tables) -> tuple:
    """The bitplane kernels' accept for the members' ``tables``:
    ``(t4 and t8 of each, 2)`` where every table has a ferromagnet's
    layout (:func:`three_thresholds`), else ``(the 10 thresholds of each,
    10)``: the general accept for all members of the launch."""
    return _members_args("accept", tuple(_values(t) for t in tables))


#: the threshold arguments of each family's kernels for its members'
#: tables: (half-sweep kernel, k-sweep kernel)
TABLE_ARGS = {"multispin": (thresholds_args, key_table_args),
              "bitplane": (accept_args, accept_args)}


def table_argtypes(family: str) -> list:
    """The C types of a family's threshold arguments: the multispin
    kernels' table, the bitplane kernels' table and its length."""
    thr = [ctypes.POINTER(ctypes.c_uint32)]
    return thr + [ctypes.c_int] if family == "bitplane" else thr


def declare(lib, family: str):
    """Declare the C signatures of ``csrc/<family>.cu``: its two launch
    functions (the members' thresholds, key pairs and count), its
    shared-memory query and its member limit."""
    if getattr(lib, f"{family}_update_launch").argtypes is None:
        u32, i32, ptr = ctypes.c_uint32, ctypes.c_int, ctypes.c_void_p
        thr = table_argtypes(family)
        keys = [ctypes.POINTER(ctypes.c_uint32), i32]
        lib.cuda_error_string.argtypes = [i32]
        lib.cuda_error_string.restype = ctypes.c_char_p
        update = getattr(lib, f"{family}_update_launch")
        update.argtypes = [ptr, ptr, i32, i32, i32, *thr, *keys, u32, ptr]
        update.restype = i32
        smem = getattr(lib, f"{family}_resident_smem_bytes")
        smem.argtypes = [i32, i32, i32]
        smem.restype = ctypes.c_longlong
        sweeps = getattr(lib, f"{family}_sweeps_resident_launch")
        sweeps.argtypes = [ptr, ptr, ptr, ptr, i32, i32, *thr, *keys, u32,
                           i32, i32, i32, i32, ptr]
        sweeps.restype = i32
        getattr(lib, f"{family}_max_members").argtypes = []
        getattr(lib, f"{family}_max_members").restype = i32
    return lib


def count_launch(wrapper, table: tuple) -> None:
    """One launch more on ``wrapper``; a bitplane launch with the general
    accept (``table`` of 10 thresholds and their count) also on
    ``wrapper.general_launches``."""
    wrapper.launches += 1
    if len(table) == 2 and table[1] == N_CLASSES:
        wrapper.general_launches += 1


def launch_update(lib, family: str, wrapper, target, op_words, tables, *,
                  is_black: bool, seeds, offset: int) -> torch.Tensor:
    """Launch ``family``'s half-sweep kernel on ``target`` in place: a
    ``(n, w)`` plane with one table and seed, or a ``(B, n, w)`` batch
    with a table and a seed a member, in ceil(B / limit) launches of the
    member axis; each launch counted on ``wrapper`` (and, as it writes
    the planes in place, noted).  Returns ``target``."""
    fn = getattr(lib, f"{family}_update_launch")
    targets, ops = as_batch(target), as_batch(op_words)
    members, n, w = targets.shape
    stream = torch.cuda.current_stream(target.device).cuda_stream
    for lo, hi in member_chunks(lib, family, members):
        table = TABLE_ARGS[family][0](tables[lo:hi])
        rc = fn(targets[lo].data_ptr(), ops[lo].data_ptr(), n, w,
                int(is_black), *table, keys_arg(seeds[lo:hi]), hi - lo,
                int(offset) & rng.MASK32, stream)
        raise_on_error(lib, rc, wrapper.__name__)
        note_in_place()
        count_launch(wrapper, table)
    return target


def launch_resident(lib, family: str, wrapper, black, white, tables, *,
                    n_sweeps: int, seeds, start_offset: int, plan):
    """Launch ``family``'s k-sweep kernel over ``n_sweeps`` sweeps of one
    member's ``(n, w)`` planes or a ``(B, n, w)`` batch's (a table and a
    seed a member) in launches of at most ``plan.k`` sweeps and of the
    library's limit of members, each counted on ``wrapper``; returns new
    planes and leaves the inputs as they were.  A tile over the card's
    shared memory raises ``SharedMemoryOverflow`` before any launch."""
    fn = getattr(lib, f"{family}_sweeps_resident_launch")
    members, n, w = as_batch(black).shape
    chunks = [(lo, hi, TABLE_ARGS[family][1](tables[lo:hi]),
               keys_arg(seeds[lo:hi]))
              for lo, hi in member_chunks(lib, family, members)]
    stream = torch.cuda.current_stream(black.device).cuda_stream
    member_bytes = n * w * black.element_size()
    check_shared_memory(lib, wrapper.__name__, black.device,
                        f"{family}_resident_smem_bytes", plan.tile_rows,
                        plan.tile_cols, min(plan.k, n_sweeps))
    for first in range(0, n_sweeps, plan.k):
        k = min(plan.k, n_sweeps - first)
        out_b, out_w = torch.empty_like(black), torch.empty_like(white)
        bases = [p.data_ptr() for p in (black, white, out_b, out_w)]
        for lo, hi, table, keys in chunks:
            rc = fn(*(b + lo * member_bytes for b in bases), n, w, *table,
                    keys, hi - lo,
                    rng.half_sweep_offset(start_offset, first, 0), k,
                    plan.tile_rows, plan.tile_cols, plan.threads, stream)
            raise_on_error(lib, rc, wrapper.__name__)
            count_launch(wrapper, table)
        black, white = out_b, out_w
    return black, white
