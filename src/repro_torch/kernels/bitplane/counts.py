"""``bitplane_counts``: the per-replica counts of the bitplane observables,
CUDA and plain.

Replaces no TPU kernel: the JAX package computes a replica's ``m`` and
``e`` in ``jnp`` (``src/repro/core/bitplane.py``: ``replica_observables``,
which unpacks the 32 lattices).  For each member of ``(B, n, w)`` int32
black and white word planes the kernel (``csrc/counts.cu``) counts, for
each replica r, ``up_r``, the set bits of replica r in both planes, and
``D_r``, the bonds whose ends disagree in bit r: every black word XOR
each of its four white neighbours (up, down, centre and the row-parity
side tap of ``lattice.side_shift(..., is_black=True)``), rows and columns
periodic.

Bound: bytes, each word of both planes read once (8 bytes a pair of a
black and a white word; 1.07e9 at 16384^2 x 32, 0.32 ms at 3.35 TB/s).
Design: a warp walks a strip of 128 words down a run of rows, the row
above in registers and the side tap from the neighbouring lane; the
counted words go into bit-sliced counters of carry-save adders, which a
butterfly of shuffles sums over the warp before they can overflow; each
block adds its 64 counts with one atomic each (the source's note says
more).

The plain version, :func:`bitplane_counts_plain`, is
``core.bitplane.replica_counts``, from which ``core.bitplane`` forms
``m`` and ``e`` (``observables_of``: one float64 division of the int64
counts, one rounding to float32), so that the kernel's counts give its
values bit for bit.  CPU planes take it; CUDA planes launch the kernel or
raise, each launch counted in ``bitplane_counts.launches``.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.core import bitplane as bp
from repro_torch.kernels import _build
from repro_torch.kernels._members import as_batch
from repro_torch.kernels.bitplane.bitplane import check_bit_planes
from repro_torch.kernels.errors import raise_on_error


def check_count_planes(black: torch.Tensor, white: torch.Tensor) -> None:
    """Raise unless ``black`` and ``white`` are contiguous, non-empty int32
    ``(n, w)`` or ``(B, n, w)`` planes of one shape on one device, 16-byte
    aligned, ``w`` a multiple of 4."""
    if black.dim() not in (2, 3) or black.shape != white.shape \
            or black.numel() == 0:
        raise ValueError(f"count planes must be non-empty (n, w) or (B, n, "
                         f"w) planes of one shape, got {tuple(black.shape)} "
                         f"and {tuple(white.shape)}")
    for p in (black, white):
        if not p.is_contiguous():
            raise ValueError(f"count planes must be contiguous, got strides "
                             f"{p.stride()}")
    check_bit_planes(as_batch(black)[0], as_batch(white)[0])


#: the plain version: ``(..., 2, 32)`` int64, ``[..., 0, r]`` = up_r and
#: ``[..., 1, r]`` = D_r, for ``(..., n, w)`` planes
bitplane_counts_plain = bp.replica_counts


def library():
    """The compiled ``csrc/counts.cu`` with its C signature declared."""
    lib = _build.load("counts")
    if lib.bitplane_counts_launch.argtypes is None:
        i32, ptr = ctypes.c_int, ctypes.c_void_p
        lib.cuda_error_string.argtypes = [i32]
        lib.cuda_error_string.restype = ctypes.c_char_p
        lib.bitplane_counts_launch.argtypes = [ptr, ptr, ptr, i32, i32, i32,
                                               ptr]
        lib.bitplane_counts_launch.restype = i32
    return lib


def bitplane_counts(black, white) -> torch.Tensor:
    """``(2, 32)`` int64 counts of ``(n, w)`` planes, ``(B, 2, 32)`` of
    ``(B, n, w)`` ones (:func:`bitplane_counts_plain`).  CPU planes take
    the plain version; CUDA planes launch the kernel into a zeroed buffer,
    its only scratch."""
    check_count_planes(black, white)
    if black.device.type == "cpu":
        return bitplane_counts_plain(black, white)
    blacks, whites = as_batch(black), as_batch(white)
    members, n, w = blacks.shape
    out = torch.zeros((members, 2, bp.N_REPLICAS), dtype=torch.int64,
                      device=black.device)
    lib = library()
    rc = lib.bitplane_counts_launch(
        blacks.data_ptr(), whites.data_ptr(), out.data_ptr(), members, n, w,
        torch.cuda.current_stream(black.device).cuda_stream)
    raise_on_error(lib, rc, "bitplane_counts")
    bitplane_counts.launches += 1
    return out if black.dim() == 3 else out[0]


#: kernel launches since the count was last set to 0
bitplane_counts.launches = 0

