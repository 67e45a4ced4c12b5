"""Checkerboard lattice (de)composition, and this package's own init.

Counterpart of ``repro.core.lattice``.  The ``(N, M)`` lattice of spins
+-1 splits into two colour planes of shape ``(N, M/2)``: *black* cells
are those with ``(i + j) % 2 == 0``, each colour compacted along rows.
For a black target at ``(i, k)`` the four neighbours are the opposite
plane's ``(i-1, k)``, ``(i, k)``, ``(i+1, k)`` and ``(i, k+1)`` on odd
rows / ``(i, k-1)`` on even rows; the side parity flips for white.

Word planes (the multispin and bitplane engines) hold uint32 words.  The
state keeps them in ``torch.int32`` tensors with the same bits, which the
kernels read as uint32; the plain code widens them to int64 masked to 32
bits (:func:`words_to_u32`), because PyTorch on the CPU implements no
uint32 arithmetic, and every right shift of such a value is logical.
"""
from __future__ import annotations

import torch

from . import rng

#: Philox counter lane c1 of the init draws.  The sweeps keep c1 = 0, so
#: the init stream never meets a sweep's stream.
INIT_COUNTER_LANE = 1

SPINS_PER_WORD = 8  # 4 bits per spin in a uint32 word
NIBBLE_BITS = 4

#: sites per init chunk: bounds the int64 Philox temporaries
_INIT_CHUNK_SITES = 1 << 22


def init_row_chunks(n: int, m: int, seed: int, device,
                    replica_groups: int = 1, rows=None, cols=None):
    """The package's own init draws, a block of rows at a time: yields
    ``(r0, r1, draws)`` where ``draws[q]`` holds the 4 lanes of Philox at
    counter ``(0, 1, i*m + j, q)`` keyed on ``seed_keys(seed)``, each an
    (r1 - r0, j1 - j0) plane of uint32 values in int64.  Lane ``l`` of
    group ``q`` draws replica ``4q + l``; replica 0 is the single lattice.
    :func:`spin_up` turns a lane into spins.  ``rows`` and ``cols`` are
    ``(start, stop)`` ranges of lattice rows and columns (default: all
    of them): a block draws what the whole lattice draws there, so that
    a shard of a sharded run makes its own part of the lattice.

    The CPU and the card give the same lattice.  It is not the JAX
    package's init (``jax.random``), which this package cannot reproduce.
    """
    k0, k1 = rng.seed_keys(seed)
    i0, i1 = rows if rows is not None else (0, n)
    j0, j1 = cols if cols is not None else (0, m)
    # even: a chunk starting at an even row keeps the row parity
    step = max(2, (_INIT_CHUNK_SITES // (j1 - j0)) & ~1)
    cols_ = torch.arange(j0, j1, dtype=torch.int64, device=device)
    for r0 in range(i0, i1, step):
        r1 = min(i1, r0 + step)
        i = torch.arange(r0, r1, dtype=torch.int64, device=device)
        idx = (i[:, None] * m + cols_[None, :]) & rng.MASK32
        yield r0, r1, [rng.philox4x32(0, INIT_COUNTER_LANE, idx, q, k0, k1)
                       for q in range(replica_groups)]


def spin_up(bits: torch.Tensor, p_up: float) -> torch.Tensor:
    """A site is up iff ``(bits >> 8) * 2^-24 < p_up``: the 24-bit
    uniform lies in [0, 1), so ``p_up = 1.0`` is all up."""
    return (bits >> 8).to(torch.float64) < float(p_up) * (1 << 24)


def init_planes(n: int, m: int, p_up: float, seed: int, device,
                rows=None, cols=None):
    """Fresh ``(black, white)`` int8 planes: replica 0 of
    :func:`init_row_chunks`, for the whole lattice or for the block of
    ``rows`` x ``cols`` (lattice ranges; the first row even, the columns
    an even range) of it."""
    i0, i1 = rows if rows is not None else (0, n)
    j0, j1 = cols if cols is not None else (0, m)
    black = torch.empty((i1 - i0, (j1 - j0) // 2), dtype=torch.int8,
                        device=device)
    white = torch.empty_like(black)
    for r0, r1, draws in init_row_chunks(n, m, seed, device, rows=rows,
                                         cols=cols):
        full = torch.where(spin_up(draws[0][0], p_up), 1, -1).to(torch.int8)
        black[r0 - i0:r1 - i0], white[r0 - i0:r1 - i0] = \
            split_checkerboard(full)
    return black, white


def split_checkerboard(lattice: torch.Tensor):
    """(N, M) full lattice -> (black, white) compact planes of (N, M/2),
    for a lattice whose first row is an even row.

    black[i, k] = lattice[i, 2k + i%2]; white[i, k] = lattice[i, 2k + (i+1)%2].
    """
    n, m = lattice.shape
    if m % 2:
        raise ValueError(f"lattice width must be even, got {m}")
    pairs = lattice.reshape(n, m // 2, 2)
    odd = (torch.arange(n, device=lattice.device) % 2 == 1)[:, None]
    black = torch.where(odd, pairs[..., 1], pairs[..., 0])
    white = torch.where(odd, pairs[..., 0], pairs[..., 1])
    return black, white


def merge_checkerboard(black: torch.Tensor, white: torch.Tensor):
    """Inverse of :func:`split_checkerboard`; ``(..., n, m/2)`` planes
    give ``(..., n, m)`` lattices (an ensemble's, one a member)."""
    n, half = black.shape[-2:]
    odd = (torch.arange(n, device=black.device) % 2 == 1)[:, None, None]
    even_pairs = torch.stack([black, white], dim=-1)
    odd_pairs = torch.stack([white, black], dim=-1)
    return torch.where(odd, odd_pairs, even_pairs).reshape(
        *black.shape[:-2], n, 2 * half)


def side_shift(op_plane: torch.Tensor, is_black: bool) -> torch.Tensor:
    """The 4th (same-row) neighbour of every target cell, in target
    coordinates, with periodic wrap.  For black targets odd rows take
    ``(i, k+1)`` and even rows ``(i, k-1)``; reversed for white.  The
    plane is ``(..., n, h)``: leading axes (an ensemble's members) are
    independent planes."""
    odd = (torch.arange(op_plane.shape[-2], device=op_plane.device)
           % 2 == 1)[:, None]
    plus = torch.roll(op_plane, -1, dims=-1)    # (i, k+1)
    minus = torch.roll(op_plane, 1, dims=-1)    # (i, k-1)
    if is_black:
        return torch.where(odd, plus, minus)
    return torch.where(odd, minus, plus)


# -- word planes: uint32 values held in int64 (and int32 in the state) ------

def words_to_u32(words: torch.Tensor) -> torch.Tensor:
    """int32 (or int64) words -> their uint32 values in int64."""
    return words.to(torch.int64) & rng.MASK32


def u32_to_words(values: torch.Tensor) -> torch.Tensor:
    """uint32 values in int64 -> int32 words with the same bits."""
    v = values & rng.MASK32
    return torch.where(v >= 1 << 31, v - (1 << 32), v).to(torch.int32)


def to_binary(plane_pm1: torch.Tensor) -> torch.Tensor:
    """+-1 plane -> 0/1 int64 plane."""
    return (plane_pm1.to(torch.int64) + 1) // 2


def from_binary(plane01: torch.Tensor, dtype=torch.int8) -> torch.Tensor:
    return (2 * plane01.to(torch.int64) - 1).to(dtype)


def _nibble_shifts(device) -> torch.Tensor:
    return torch.arange(SPINS_PER_WORD, dtype=torch.int64,
                        device=device) * NIBBLE_BITS


def pack_nibbles(plane01: torch.Tensor) -> torch.Tensor:
    """(N, C) 0/1 plane -> (N, C/8) uint32 values in int64, nibble n of
    word w = column 8w + n."""
    n, c = plane01.shape
    if c % SPINS_PER_WORD:
        raise ValueError(f"columns must be a multiple of {SPINS_PER_WORD}, "
                         f"got {c}")
    grouped = plane01.to(torch.int64).reshape(n, c // SPINS_PER_WORD,
                                              SPINS_PER_WORD)
    return (grouped << _nibble_shifts(plane01.device)).sum(-1)


def unpack_nibbles(words: torch.Tensor) -> torch.Tensor:
    """(..., N, W) uint32 values -> (..., N, 8W) nibble values (int64)."""
    nib = (words_to_u32(words)[..., None]
           >> _nibble_shifts(words.device)) & 0xF
    return nib.reshape(*words.shape[:-1], words.shape[-1] * SPINS_PER_WORD)


def align_side_word(center: torch.Tensor, is_black: bool) -> torch.Tensor:
    """Packed-word counterpart of :func:`side_shift`: 7 of a word's 8
    same-row neighbours lie in the opposite plane's word at the same
    place, the 8th in the edge nibble of the word to the right (``k+1``)
    or the left (``k-1``).  A funnel shift of two words, masked to 32
    bits, aligns them.  ``center`` holds uint32 values in int64, ``(...,
    n, w)``."""
    nxt = torch.roll(center, -1, dims=-1)
    prv = torch.roll(center, 1, dims=-1)
    # toward k+1: nibble n <- nibble n+1; the next word's nibble 0 enters
    # at the top
    plus = (center >> NIBBLE_BITS) | ((nxt << (32 - NIBBLE_BITS))
                                      & rng.MASK32)
    # toward k-1
    minus = ((center << NIBBLE_BITS) & rng.MASK32) | (prv
                                                      >> (32 - NIBBLE_BITS))
    odd = (torch.arange(center.shape[-2], device=center.device)
           % 2 == 1)[:, None]
    if is_black:
        return torch.where(odd, plus, minus)
    return torch.where(odd, minus, plus)


def packed_neighbor_sums(op_words: torch.Tensor, is_black: bool
                         ) -> torch.Tensor:
    """Nibble-parallel four-neighbour sums: three adds per 8 spins.  Each
    nibble sum is at most 4 < 16, so no carry crosses a nibble.  Takes
    and returns uint32 values in int64, ``(..., n, w)``."""
    op = words_to_u32(op_words)
    up = torch.roll(op, 1, dims=-2)
    down = torch.roll(op, -1, dims=-2)
    return up + down + op + align_side_word(op, is_black)
