"""What the two word-plane kernel families share: their plain C interface
(``csrc/multispin.cu`` and ``csrc/bitplane.cu`` export the same three
functions under their family's name), the checks of their arguments and
the launch loop of their k-sweep kernels.

Word planes are ``torch.int32`` tensors holding the uint32 bits; the
thresholds an int64 tensor of 10 uint32 values
(``repro_torch.core.multispin.acceptance_thresholds``), which the
multispin k-sweep and shard kernels take as the 16-entry
:func:`key_table` and the bitplane kernels as :func:`accept_arg`: t4 and
t8 where the table has a ferromagnet's three values, else all 10.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from repro_torch.core import rng
from repro_torch.kernels.resident import GEOMETRY
from repro_torch.kernels.stencil.stencil import raise_on_error

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
    ``black``'s shape."""
    if n_sweeps < 1:
        raise ValueError(f"n_sweeps must be >= 1, got {n_sweeps}")
    width = plan.m // GEOMETRY[plan.family].col_divisor
    if tuple(black.shape) != (plan.n, width):
        raise ValueError(f"plan is for a {plan.n}x{plan.m} lattice, planes "
                         f"are {tuple(black.shape)}")


def thresholds_arg(thresholds: torch.Tensor):
    """The 10 uint32 thresholds as a ctypes array (passed by value)."""
    if thresholds.numel() != N_CLASSES:
        raise ValueError(f"threshold table needs {N_CLASSES} entries, got "
                         f"{thresholds.numel()}")
    values = [int(v) & rng.MASK32 for v in thresholds.flatten().tolist()]
    return (ctypes.c_uint32 * N_CLASSES)(*values)


def three_thresholds(thresholds: torch.Tensor) -> Optional[tuple]:
    """``(t4, t8)`` where the thresholds have a ferromagnet's layout
    (:data:`ALWAYS`, :data:`T4_CLASSES`, :data:`T8_CLASSES`), which the
    bitplane kernels' three-threshold accept takes; else ``None``."""
    values = list(thresholds_arg(thresholds))
    if any(values[i] != rng.MASK32 for i in ALWAYS):
        return None
    t4, t8 = (values[c[0]] for c in (T4_CLASSES, T8_CLASSES))
    if any(values[i] != t4 for i in T4_CLASSES) or \
            any(values[i] != t8 for i in T8_CLASSES):
        return None
    return t4, t8


def accept_arg(thresholds: torch.Tensor) -> tuple:
    """The bitplane kernels' accept: ``(array, 2)`` of t4 and t8 for the
    three-threshold accept where :func:`three_thresholds` finds them,
    else ``(array, 10)`` of all 10 for the general one (ctypes arrays)."""
    three = three_thresholds(thresholds)
    if three is None:
        return thresholds_arg(thresholds), N_CLASSES
    return (ctypes.c_uint32 * 2)(*three), 2


def key_table(thresholds: torch.Tensor) -> list:
    """The 16 uint32 entries that ``csrc/multispin.cu``'s k-sweep and
    shard kernels index by a word's key nibble ``s * 8 + c`` (spin s at
    bit 3, the count c <= 4 of up neighbours below it): entry ``s * 8 +
    c`` is threshold ``s * 5 + c``; entries 5-7 and 13-15, which no
    nibble takes, are 0."""
    values = list(thresholds_arg(thresholds))
    return [values[(key >> 3) * 5 + (key & 7)] if key & 7 <= 4 else 0
            for key in range(N_KEYS)]


def key_table_arg(thresholds: torch.Tensor):
    """:func:`key_table` as a ctypes array (passed by value)."""
    return (ctypes.c_uint32 * N_KEYS)(*key_table(thresholds))


def table_argtypes(family: str) -> list:
    """The C types of a family's threshold arguments: the multispin
    kernels' table, the bitplane kernels' table and its length."""
    thr = [ctypes.POINTER(ctypes.c_uint32)]
    return thr + [ctypes.c_int] if family == "bitplane" else thr


def declare(lib, family: str):
    """Declare the C signatures of ``csrc/<family>.cu``: its two launch
    functions and its shared-memory query."""
    if getattr(lib, f"{family}_update_launch").argtypes is None:
        u32, i32, ptr = ctypes.c_uint32, ctypes.c_int, ctypes.c_void_p
        thr = table_argtypes(family)
        lib.cuda_error_string.argtypes = [i32]
        lib.cuda_error_string.restype = ctypes.c_char_p
        update = getattr(lib, f"{family}_update_launch")
        update.argtypes = [ptr, ptr, i32, i32, i32, *thr, u32, u32, u32, ptr]
        update.restype = i32
        smem = getattr(lib, f"{family}_resident_smem_bytes")
        smem.argtypes = [i32, i32, i32]
        smem.restype = ctypes.c_longlong
        sweeps = getattr(lib, f"{family}_sweeps_resident_launch")
        sweeps.argtypes = [ptr, ptr, ptr, ptr, i32, i32, *thr, u32, u32, u32,
                           i32, i32, i32, i32, ptr]
        sweeps.restype = i32
    return lib


def count_launch(wrapper, table: tuple) -> None:
    """One launch more on ``wrapper``; a bitplane launch with the general
    accept (``table`` of 10 thresholds and their count) also on
    ``wrapper.general_launches``."""
    wrapper.launches += 1
    if len(table) == 2 and table[1] == N_CLASSES:
        wrapper.general_launches += 1


def launch_update(lib, fn, wrapper, target, op_words, table: tuple, *,
                  is_black: bool, seed: int, offset: int) -> torch.Tensor:
    """Launch a word family's half-sweep kernel ``fn`` on ``target`` in
    place with its threshold arguments ``table`` (``(thresholds_arg,)``
    or :func:`accept_arg`), counting the launch on ``wrapper``; returns
    ``target``."""
    n, w = target.shape
    k0, k1 = rng.seed_keys(seed)
    rc = fn(target.data_ptr(), op_words.data_ptr(), n, w, int(is_black),
            *table, k0, k1, int(offset) & rng.MASK32,
            torch.cuda.current_stream(target.device).cuda_stream)
    raise_on_error(lib, rc, wrapper.__name__)
    count_launch(wrapper, table)
    return target


def launch_resident(lib, fn, wrapper, black, white, table: tuple, *,
                    n_sweeps: int, seed: int, start_offset: int, plan):
    """Launch a word family's k-sweep kernel ``fn`` with its threshold
    arguments ``table`` (``(key_table_arg,)`` or :func:`accept_arg`) over
    ``n_sweeps`` sweeps in launches of at most ``plan.k``, counting each
    launch on ``wrapper``; returns new planes."""
    n, w = black.shape
    k0, k1 = rng.seed_keys(seed)
    stream = torch.cuda.current_stream(black.device).cuda_stream
    for first in range(0, n_sweeps, plan.k):
        k = min(plan.k, n_sweeps - first)
        out_b, out_w = torch.empty_like(black), torch.empty_like(white)
        rc = fn(black.data_ptr(), white.data_ptr(), out_b.data_ptr(),
                out_w.data_ptr(), n, w, *table, k0, k1,
                rng.half_sweep_offset(start_offset, first, 0), k,
                plan.tile_rows, plan.tile_cols, plan.threads, stream)
        raise_on_error(lib, rc, wrapper.__name__)
        count_launch(wrapper, table)
        black, white = out_b, out_w
    return black, white
