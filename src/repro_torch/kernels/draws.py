"""``philox_fill``: planes of Philox uniforms, CUDA kernel and plain version.

Replaces no TPU kernel.  The JAX package draws the uniforms of the
engines whose update is plain ``jnp`` -- ``basic_philox``, ``basic``,
``spinglass``, ``wolff`` and the 3D model -- with ``repro.core.rng``'s
``uniforms`` in ``jnp``, and XLA fuses the draws into the update.  The
port keeps those updates plain PyTorch, but its plain Philox on 16-bit
limbs (``core.rng.philox4x32``) costs hundreds of times a kernel's on the
card, so their draws come from ``csrc/draws.cu``: lane 0 (or lanes 0 to
``lanes - 1``) of Philox4x32-10 at counter ``(offset, c1, index, c3)``,
key ``seed_keys(seed)`` a member, as float32 uniforms (``lanes`` at
most :data:`MAX_LANES`).  The index of an
element is its row-major position in the plane (``row * h + col``), or
its entry in an int32 index plane.  ``c1`` names the stream
(``core.rng``'s table of lanes).

The plain version is ``metropolis.philox_uniforms`` (row-major) and
``metropolis.index_uniforms`` (an index plane), a member at a time.
CPU tensors take it; on the card the wrapper launches the kernel or
raises, and counts each launch in ``philox_fill.launches``.
"""
from __future__ import annotations

import ctypes
import math

import torch

from repro_torch.core import metropolis, rng
from repro_torch.kernels import _build
from repro_torch.kernels._members import keys_arg, member_chunks
from repro_torch.kernels.errors import raise_on_error

#: the most lanes a call draws: the couplings take 2, every other caller 1
MAX_LANES = 2


def _check(seeds, lanes: int, shape, index) -> None:
    if not 1 <= lanes <= MAX_LANES:
        raise ValueError(f"lanes must be 1 to {MAX_LANES}, got {lanes}")
    if len(seeds) < 1:
        raise ValueError("philox_fill needs at least one member's seed")
    if index is not None:
        if index.dtype not in (torch.int32, torch.int64):
            raise ValueError(f"index plane must be int32 or int64, got "
                             f"{index.dtype}")
    elif not shape or math.prod(shape) < 1:
        raise ValueError(f"philox_fill needs a non-empty shape, got {shape}")


def philox_fill_plain(seeds, offset: int, *, shape=None, index=None,
                      device=None, c1: int = 0, c3: int = 0,
                      lanes: int = 1) -> torch.Tensor:
    """The plain version: ``(lanes, B, *shape)`` float32 uniforms, member
    b's lane l at ``[l, b]``, for the row-major ``shape`` on ``device`` or
    the sites of ``index`` (on its device; ``shape`` is then its
    shape)."""
    _check(seeds, lanes, shape, index)
    planes = []
    for seed in seeds:
        if index is not None:
            u = metropolis.index_uniforms(index, int(seed), offset, c1=c1,
                                          c3=c3, lanes=lanes)
        else:
            u = metropolis.philox_uniforms(
                shape[0], math.prod(shape[1:]), int(seed), offset, device,
                c1=c1, c3=c3, lanes=lanes)
        u = u.reshape(lanes, *(index.shape if index is not None else shape))
        planes.append(u)
    return torch.stack(planes, dim=1)


def library():
    """The compiled ``csrc/draws.cu`` with its C signatures declared."""
    lib = _build.load("draws")
    if lib.philox_fill_launch.argtypes is None:
        u32, i32, i64, ptr = (ctypes.c_uint32, ctypes.c_int,
                              ctypes.c_longlong, ctypes.c_void_p)
        lib.cuda_error_string.argtypes = [i32]
        lib.cuda_error_string.restype = ctypes.c_char_p
        lib.philox_fill_launch.argtypes = [
            ptr, ptr, i64, i64, i32, i32, ctypes.POINTER(ctypes.c_uint32),
            u32, u32, u32, ptr]
        lib.philox_fill_launch.restype = i32
        lib.draws_max_members.argtypes = []
        lib.draws_max_members.restype = i32
    return lib


def _index_int32(index: torch.Tensor) -> torch.Tensor:
    """The index plane as contiguous int32 with the same low 32 bits."""
    if index.dtype == torch.int64:
        v = index & rng.MASK32
        index = torch.where(v >= 1 << 31, v - (1 << 32), v).to(torch.int32)
    return index.contiguous()


def philox_fill(seeds, offset: int, *, shape=None, index=None, device=None,
                c1: int = 0, c3: int = 0, lanes: int = 1) -> torch.Tensor:
    """``(lanes, B, *shape)`` float32 uniforms of Philox4x32-10 at counter
    ``(offset, c1, index, c3)``, one member a seed of ``seeds``: of the
    row-major ``shape`` on ``device`` (index = flat position), or of the
    int32/int64 index plane ``index`` (on its device, shared by the
    members; ``shape`` its shape).  CPU tensors take the plain version,
    and so do meta tensors (shapes only: the dry-run counts its ops in
    the kernel's place); on the card each launch (ceil(B / limit) of
    them) is counted."""
    _check(seeds, lanes, shape, index)
    device = torch.device(index.device if index is not None else device)
    if device.type in ("cpu", "meta"):
        return philox_fill_plain(seeds, offset, shape=shape, index=index,
                                 device=device, c1=c1, c3=c3, lanes=lanes)
    if device.type != "cuda":
        raise ValueError(f"unsupported device {device}")
    if index is not None:
        index = _index_int32(index)
        shape = tuple(index.shape)
    shape = tuple(int(d) for d in shape)
    out = torch.empty((lanes, len(seeds), *shape), dtype=torch.float32,
                      device=device)
    return _launch_fill(out, index, list(seeds), offset, c1, c3)


def _launch_fill(out, index, seeds, offset: int, c1: int, c3: int):
    """Launch the kernel into ``out``, ``(lanes, B, *shape)``, in
    ceil(B / limit) launches of its member axis, each counted on
    :func:`philox_fill`."""
    lib = library()
    lanes, members = out.shape[:2]
    count = math.prod(out.shape[2:])
    stream = torch.cuda.current_stream(out.device).cuda_stream
    index_ptr = None if index is None else index.data_ptr()
    for lo, hi in member_chunks(lib, "draws", members):
        rc = lib.philox_fill_launch(
            out[0, lo].data_ptr(), index_ptr, count, members * count, lanes,
            hi - lo, keys_arg(seeds[lo:hi]), int(offset) & rng.MASK32,
            int(c1) & rng.MASK32, int(c3) & rng.MASK32, stream)
        raise_on_error(lib, rc, "philox_fill")
        philox_fill.launches += 1
    return out


#: kernel launches since the count was last set to 0 (a batched launch
#: counts once)
philox_fill.launches = 0


def uniforms(shape, seed: int, offset: int, device, *, c1: int = 0,
             c3: int = 0) -> torch.Tensor:
    """One member's lane-0 uniforms of the row-major ``shape``: what the
    engines of plain updates draw, through :func:`philox_fill`."""
    return philox_fill([seed], offset, shape=tuple(shape), device=device,
                       c1=c1, c3=c3)[0, 0]


def index_uniforms(index: torch.Tensor, seed: int, offset: int, *,
                   c1: int = 0, c3: int = 0) -> torch.Tensor:
    """One member's lane-0 uniforms of the sites of ``index``, through
    :func:`philox_fill`."""
    return philox_fill([seed], offset, index=index, c1=c1, c3=c3)[0, 0]
