"""Checkerboard lattice (de)composition, and this package's own init.

Counterpart of ``repro.core.lattice``.  The ``(N, M)`` lattice of spins
+-1 splits into two colour planes of shape ``(N, M/2)``: *black* cells
are those with ``(i + j) % 2 == 0``, each colour compacted along rows.
For a black target at ``(i, k)`` the four neighbours are the opposite
plane's ``(i-1, k)``, ``(i, k)``, ``(i+1, k)`` and ``(i, k+1)`` on odd
rows / ``(i, k-1)`` on even rows; the side parity flips for white.
"""
from __future__ import annotations

import torch

from . import rng

#: Philox counter lane c1 of the init draws.  The sweeps keep c1 = 0, so
#: the init stream never meets a sweep's stream.
INIT_COUNTER_LANE = 1

#: sites per init chunk: bounds the int64 Philox temporaries
_INIT_CHUNK_SITES = 1 << 22


def init_planes(n: int, m: int, p_up: float, seed: int, device):
    """Fresh ``(black, white)`` int8 planes: site ``(i, j)`` is +1 iff
    ``(bits >> 8) * 2^-24 < p_up``, with ``bits`` lane 0 of Philox at
    counter ``(0, 1, i*m + j, 0)`` keyed on ``seed_keys(seed)``.

    The CPU and the card give the same lattice.  It is not the JAX
    package's init (``jax.random``), which this package cannot reproduce.
    The 24-bit uniform lies in [0, 1), so ``p_up = 1.0`` is all up.
    """
    k0, k1 = rng.seed_keys(seed)
    black = torch.empty((n, m // 2), dtype=torch.int8, device=device)
    white = torch.empty_like(black)
    rows = max(2, (_INIT_CHUNK_SITES // m) & ~1)  # even: keeps row parity
    cols = torch.arange(m, dtype=torch.int64, device=device)
    threshold = float(p_up) * (1 << 24)
    for r0 in range(0, n, rows):
        r1 = min(n, r0 + rows)
        i = torch.arange(r0, r1, dtype=torch.int64, device=device)
        idx = (i[:, None] * m + cols[None, :]) & rng.MASK32
        bits = rng.philox4x32(0, INIT_COUNTER_LANE, idx, 0, k0, k1)[0]
        up = (bits >> 8).to(torch.float64) < threshold
        full = torch.where(up, 1, -1).to(torch.int8)
        black[r0:r1], white[r0:r1] = split_checkerboard(full)
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
    """Inverse of :func:`split_checkerboard`."""
    n, half = black.shape
    odd = (torch.arange(n, device=black.device) % 2 == 1)[:, None, None]
    even_pairs = torch.stack([black, white], dim=-1)
    odd_pairs = torch.stack([white, black], dim=-1)
    return torch.where(odd, odd_pairs, even_pairs).reshape(n, 2 * half)


def side_shift(op_plane: torch.Tensor, is_black: bool) -> torch.Tensor:
    """The 4th (same-row) neighbour of every target cell, in target
    coordinates, with periodic wrap.  For black targets odd rows take
    ``(i, k+1)`` and even rows ``(i, k-1)``; reversed for white."""
    odd = (torch.arange(op_plane.shape[0], device=op_plane.device)
           % 2 == 1)[:, None]
    plus = torch.roll(op_plane, -1, dims=1)    # (i, k+1)
    minus = torch.roll(op_plane, 1, dims=1)    # (i, k-1)
    if is_black:
        return torch.where(odd, plus, minus)
    return torch.where(odd, minus, plus)
