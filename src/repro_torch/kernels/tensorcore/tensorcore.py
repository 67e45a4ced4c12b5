"""``tensorcore_update``: the fused tensor-core half-sweep, CUDA and plain.

Replaces the Pallas kernel ``src/repro/kernels/tensorcore/tensorcore.py``
(``tensorcore_update``), which stages a block pair of the target planes
and six neighbour blocks into TPU VMEM and runs the banded products on
the MXU.  On the card (``csrc/tensorcore.cu``) a persistent grid of
8-warp blocks walks tiles of the planes through a two-stage ring of
``cp.async`` copies in shared memory: the spin operands converted to bf16,
the banded products on the tensor cores (``mma.sync`` m16n8k16, bf16 in,
f32 sums, only the k-steps where K is not zero), then the edge terms,
lanes 0 and 1 of one Philox call per plane position (lane 0 for the
first target plane, lane 1 for the second, key ``(seed mod 2^32, 0)``,
the offset's work hoisted) and the accept in registers.  Its floor is
the issue of Philox's wide multiplies, about 0.53 ms a half-sweep of
four 16384^2 int8 planes on an H100 SXM at its 1980 MHz clock
(``PERF.md``).  The kernel's tile is its own, the largest of 64, 32, 16
rows and of 128, 64, 32, 16 columns that divide the planes
(:func:`kernel_geometry`): the sums are exact whatever the tile, so
``block`` (the engine's ``tc_block``) only has to tile the planes.  The
target planes are updated in place, by the kernel and, on the CPU, by the
wrapper.

Planes are int8 (the engine's state) or bf16 (the TPU kernel's
contract), all four of one type and shape, and hold spins +-1.  The
kernel compares the raw draw with integer bounds
(:func:`repro_torch.core.metropolis.draw_bounds`), the same decisions
as the plain version's float compare.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.core import metropolis, rng
from repro_torch.core import tensorcore as tc
from repro_torch.kernels import _build
from repro_torch.kernels.errors import note_in_place, raise_on_error

DEFAULT_BLOCK = tc.BLOCK
#: block sizes the CUDA kernel takes: multiples of the 16-deep mma step
#: up to 128, the TPU kernel's contract (the kernel's own tile is at most
#: 64 x 128)
CUDA_BLOCKS = tuple(range(16, 129, 16))
_DTYPES = {torch.int8: 1, torch.bfloat16: 2}


def tensorcore_update_plain(planes: dict, color: str, inv_temp, *,
                            seed: int = 0, offset: int = 0,
                            block: int = DEFAULT_BLOCK) -> dict:
    """The plain PyTorch version, the paper's three passes: batched
    products, boundary corrections, then the accept with the fused
    kernel's Philox lanes.  Returns a new dict."""
    h, w = planes["00"].shape
    u = tc.philox_uniform_pair(h, w, seed, offset, planes["00"].device)
    return tc.update_color_tc(planes, color, u,
                              metropolis.acceptance_table(inv_temp), block)


def check_block(block: int) -> None:
    """Raise ``ValueError`` unless the CUDA kernel takes ``block``."""
    if block not in CUDA_BLOCKS:
        raise ValueError(f"the CUDA tensorcore kernel takes a block of "
                         f"{CUDA_BLOCKS[0]} to {CUDA_BLOCKS[-1]} in steps "
                         f"of 16, got {block}")


def check_planes(planes: dict, block: int) -> None:
    """Raise unless ``planes`` holds four contiguous 2-D int8 or bf16
    tensors of one shape, type and device, tiled by ``block``."""
    missing = [k for k in tc.PLANE_KEYS if k not in planes]
    if missing:
        raise ValueError(f"planes lack {missing}")
    first = planes["00"]
    for k in tc.PLANE_KEYS:
        p = planes[k]
        if p.dtype not in _DTYPES or p.dim() != 2 or not p.is_contiguous():
            raise ValueError(f"plane {k!r} must be a contiguous 2-D int8 or "
                             f"bf16 tensor, got {p.dtype} {tuple(p.shape)}")
        if p.shape != first.shape or p.dtype != first.dtype \
                or p.device != first.device:
            raise ValueError(f"planes differ: {k!r} is {p.dtype} "
                             f"{tuple(p.shape)} on {p.device}")
        if p.device.type == "cuda" and p.data_ptr() % 16:
            raise ValueError("planes must start at a multiple of 16 bytes")
    if first.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {first.device}")
    h, w = first.shape
    if block <= 0 or h % block or w % block:
        raise ValueError(f"block {block} does not tile planes of "
                         f"{tuple(first.shape)}")


@functools.lru_cache(maxsize=16)
def _bounds_arg(inv_temp: float):
    values = metropolis.draw_bounds(
        metropolis.acceptance_table(inv_temp).numpy())
    return (ctypes.c_uint64 * metropolis.TABLE_SIZE)(*values.tolist())


def library(csrc_dir=_build.CSRC_DIR):
    """The compiled ``tensorcore.cu`` of ``csrc_dir`` (the package's
    ``csrc/``, or an edited copy that an analysis tool times) with its C
    signatures declared."""
    lib = _build.load("tensorcore", csrc_dir)
    if lib.tensorcore_update_launch.argtypes is None:
        u32, i32, ptr = ctypes.c_uint32, ctypes.c_int, ctypes.c_void_p
        lib.cuda_error_string.argtypes = [i32]
        lib.cuda_error_string.restype = ctypes.c_char_p
        lib.tensorcore_update_launch.argtypes = [
            ptr, ptr, ptr, ptr, i32, i32, i32, i32, i32,
            ctypes.POINTER(ctypes.c_uint64), u32, u32, ptr]
        lib.tensorcore_update_launch.restype = i32
        lib.tensorcore_geometry.argtypes = [i32, i32, i32,
                                            ctypes.POINTER(i32)]
        lib.tensorcore_geometry.restype = i32
    return lib


def kernel_geometry(h: int, w: int, dtype=torch.int8) -> dict:
    """The CUDA kernel's geometry on (h, w) planes of ``dtype``: its tile
    (``tile_rows``, ``tile_cols``), the ``tiles`` of the planes and the
    ``blocks`` of its persistent grid on the current card."""
    lib = library()
    out = (ctypes.c_int * 4)()
    raise_on_error(lib, lib.tensorcore_geometry(h, w, _DTYPES[dtype], out),
                   "tensorcore_geometry")
    return dict(zip(("tile_rows", "tile_cols", "tiles", "blocks"), out))


def launch_args(planes: dict, color: str, inv_temp, *, seed: int = 0,
                offset: int = 0, block: int = DEFAULT_BLOCK) -> tuple:
    """The arguments of ``tensorcore_update_launch`` for a half-sweep of
    CUDA ``planes`` that :func:`check_planes` takes; raises unless the
    kernel takes ``block``."""
    check_block(block)
    t1k, t2k = tc.COLOR_PLANES[color]
    is_black = color == "black"
    ak, bk = ("01", "10") if is_black else ("11", "00")
    h, w = planes["00"].shape
    stream = torch.cuda.current_stream(planes["00"].device).cuda_stream
    return (planes[t1k].data_ptr(), planes[t2k].data_ptr(),
            planes[ak].data_ptr(), planes[bk].data_ptr(), h, w, block,
            int(is_black), _DTYPES[planes["00"].dtype],
            _bounds_arg(float(inv_temp)), int(seed) & rng.MASK32,
            int(offset) & rng.MASK32, stream)


def tensorcore_update(planes: dict, color: str, inv_temp, *, seed: int = 0,
                      offset: int = 0, block: int = DEFAULT_BLOCK) -> dict:
    """Fused half-sweep of ``color``'s two planes (black: '00', '11';
    white: '10', '01'), in place; returns ``planes``.

    ``seed`` keys Philox on its low 32 bits only, as the TPU kernel does;
    ``offset`` is the uint32 Philox offset of this half-sweep.  CPU
    planes take the plain version; CUDA planes launch the kernel, whose
    ``block`` must be in :data:`CUDA_BLOCKS`.
    """
    if color not in tc.COLOR_PLANES:
        raise ValueError(f"color must be 'black' or 'white', got {color!r}")
    check_planes(planes, block)
    if planes["00"].device.type == "cpu":
        t1k, t2k = tc.COLOR_PLANES[color]
        new = tensorcore_update_plain(planes, color, inv_temp, seed=seed,
                                      offset=offset, block=block)
        planes[t1k].copy_(new[t1k])
        planes[t2k].copy_(new[t2k])
        note_in_place()
        return planes
    lib = library()
    raise_on_error(lib, lib.tensorcore_update_launch(*launch_args(
        planes, color, inv_temp, seed=seed, offset=offset, block=block)),
        "tensorcore_update")
    note_in_place()
    tensorcore_update.launches += 1
    return planes


#: kernel launches since the count was last set to 0
tensorcore_update.launches = 0
