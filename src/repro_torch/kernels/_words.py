"""What the two word-plane kernel families share: their plain C interface
(``csrc/multispin.cu`` and ``csrc/bitplane.cu`` export the same three
functions under their family's name), the checks of their arguments and
the launch loop of their k-sweep kernels.

Word planes are ``torch.int32`` tensors holding the uint32 bits; the
thresholds an int64 tensor of 10 uint32 values
(``repro_torch.core.multispin.acceptance_thresholds``), which the
multispin k-sweep and shard kernels take as the 16-entry
:func:`key_table`.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.core import rng
from repro_torch.kernels.resident import GEOMETRY
from repro_torch.kernels.stencil.stencil import raise_on_error

#: entries of the threshold table
N_CLASSES = 10

#: entries of the multispin k-sweep and shard kernels' table
N_KEYS = 16


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


def declare(lib, family: str):
    """Declare the C signatures of ``csrc/<family>.cu``: its two launch
    functions and its shared-memory query."""
    if getattr(lib, f"{family}_update_launch").argtypes is None:
        u32, i32, ptr = ctypes.c_uint32, ctypes.c_int, ctypes.c_void_p
        thr = ctypes.POINTER(ctypes.c_uint32)
        lib.cuda_error_string.argtypes = [i32]
        lib.cuda_error_string.restype = ctypes.c_char_p
        update = getattr(lib, f"{family}_update_launch")
        update.argtypes = [ptr, ptr, i32, i32, i32, thr, u32, u32, u32, ptr]
        update.restype = i32
        smem = getattr(lib, f"{family}_resident_smem_bytes")
        smem.argtypes = [i32, i32, i32]
        smem.restype = ctypes.c_longlong
        sweeps = getattr(lib, f"{family}_sweeps_resident_launch")
        sweeps.argtypes = [ptr, ptr, ptr, ptr, i32, i32, thr, u32, u32, u32,
                           i32, i32, i32, i32, ptr]
        sweeps.restype = i32
    return lib


def launch_update(lib, fn, wrapper, target, op_words, thresholds, *,
                  is_black: bool, seed: int, offset: int) -> torch.Tensor:
    """Launch a word family's half-sweep kernel ``fn`` on ``target`` in
    place, counting the launch on ``wrapper``; returns ``target``."""
    n, w = target.shape
    k0, k1 = rng.seed_keys(seed)
    rc = fn(target.data_ptr(), op_words.data_ptr(), n, w, int(is_black),
            thresholds_arg(thresholds), k0, k1, int(offset) & rng.MASK32,
            torch.cuda.current_stream(target.device).cuda_stream)
    raise_on_error(lib, rc, wrapper.__name__)
    wrapper.launches += 1
    return target


def launch_resident(lib, fn, wrapper, black, white, table, *,
                    n_sweeps: int, seed: int, start_offset: int, plan):
    """Launch a word family's k-sweep kernel ``fn`` with its threshold
    table ``table`` (a ctypes array: :func:`thresholds_arg` or
    :func:`key_table_arg`) over ``n_sweeps`` sweeps in launches of at
    most ``plan.k``, counting each launch on ``wrapper``; returns new
    planes."""
    n, w = black.shape
    k0, k1 = rng.seed_keys(seed)
    stream = torch.cuda.current_stream(black.device).cuda_stream
    for first in range(0, n_sweeps, plan.k):
        k = min(plan.k, n_sweeps - first)
        out_b, out_w = torch.empty_like(black), torch.empty_like(white)
        rc = fn(black.data_ptr(), white.data_ptr(), out_b.data_ptr(),
                out_w.data_ptr(), n, w, table, k0, k1,
                rng.half_sweep_offset(start_offset, first, 0), k,
                plan.tile_rows, plan.tile_cols, plan.threads, stream)
        raise_on_error(lib, rc, wrapper.__name__)
        wrapper.launches += 1
        black, white = out_b, out_w
    return black, white
