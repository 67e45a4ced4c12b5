"""Plain reference of checkerboard Metropolis with counter-based draws.

This is the semantics the benchmark holds the program to, written from
the definition and not from the program: it imports nothing of the
program, and the program's state only reaches it to be judged, or, for
the window's last call, as the start it follows (``PERF.md`` says why).

The model.  An ``(N, M)`` lattice of spins, periodic.  Site ``(i, j)``
is black where ``(i + j)`` is even.  Each colour is held as a compact
plane ``(N, M / 2)``: compact column ``k = j // 2``.  A black site
``(i, k)`` has the white neighbours ``(i - 1, k)``, ``(i + 1, k)``,
``(i, k)`` and, on odd rows ``(i, k + 1)``, on even rows ``(i, k - 1)``;
for a white site the side is the other way round.  A sweep updates
every black site, then every white site, each from the other colour.

Replicas.  A site's word holds one bit a replica: bit ``r`` is replica
``r``'s spin, 1 up and 0 down.  The multispin layout carries one
replica (bit 0), the bitplane layout 32, which share every draw.

The draw of a site.  Philox4x32-10 at a 128-bit counter under the key
``(seed mod 2^32, seed >> 32)``.  Half-sweep ``h`` of a call that
starts at sweep ``step`` has the offset ``off = (2 step + h) mod 2^32``
(``h`` = 2 x sweep + colour, colour 0 black).

* multispin: compact column ``k`` is nibble ``q = k mod 8`` of word
  ``k // 8``, word index ``w = i (M / 16) + k // 8``.  The draw is lane
  ``q mod 4`` of Philox at counter ``((2 off + q // 4) mod 2^32, 0, w,
  0)``.
* bitplane: site index ``s = i (M / 2) + k``; the draw is lane ``s mod
  4`` of Philox at counter ``(off, 0, s // 4, 0)``.

The accept.  With ``c`` up neighbours (0 to 4) and spin bit ``b``, the
site flips iff its draw is below ``t[5 b + c]``, where the threshold is
``floor(p 2^32)`` for ``p < 1`` and ``2^32 - 1`` otherwise, and ``p`` is
``exp(a)`` of the float32 argument ``a = (float32(-2) x float32(beta))
x float32(2c - 4) x float32(2b - 1)``, taken in float64 and rounded once
to the configuration's precision (float32).  The control rounds ``p`` to
bfloat16 instead.

uint32 values travel in int64 tensors, masked to 32 bits; a 32 x 32-bit
product is split into 16-bit limbs so that no product leaves int64.
"""
from __future__ import annotations

import math
from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch

MASK32 = 0xFFFFFFFF
M0 = 0xD2511F53
M1 = 0xCD9E8D57
W0 = 0x9E3779B9
W1 = 0xBB67AE85

REPLICAS = {"multispin": 1, "bitplane": 32}
#: precisions of the acceptance probability: the configuration's, and
#: the control's one step below it
PRECISIONS = {"float32": torch.float32, "bfloat16": torch.bfloat16}

#: int64 elements of one chunk of full-plane draws
_CHUNK = 1 << 24


# -- Philox4x32-10 ------------------------------------------------------------

def _mul_hi_lo(const: int, x: torch.Tensor):
    """``const * x`` of a uint32 constant and uint32 values: (hi, lo)."""
    lo16 = (x & 0xFFFF) * const
    hi16 = (x >> 16) * const
    lo = (lo16 + ((hi16 & 0xFFFF) << 16)) & MASK32
    hi = (hi16 + (lo16 >> 16)) >> 16
    return hi & MASK32, lo


def philox(c0, c1, c2, c3, k0: int, k1: int):
    """Philox4x32-10 of broadcastable counter lanes (int64 tensors or
    ints holding uint32 values) under the key ``(k0, k1)``; the four
    output lanes as int64 tensors."""
    x, y, z, w = (c & MASK32 if isinstance(c, torch.Tensor) else int(c) & MASK32
                  for c in (c0, c1, c2, c3))
    for r in range(10):
        rk0 = (k0 + r * W0) & MASK32
        rk1 = (k1 + r * W1) & MASK32
        hi_a, lo_a = _mul_hi_lo(M0, x)
        hi_b, lo_b = _mul_hi_lo(M1, z)
        x, y, z, w = hi_b ^ y ^ rk0, lo_b, hi_a ^ w ^ rk1, lo_a
    return x, y, z, w


def keys(seed: int) -> Tuple[int, int]:
    seed = int(seed)
    return seed & MASK32, (seed >> 32) & MASK32


def _pick(lanes, lane: torch.Tensor) -> torch.Tensor:
    x, y, z, w = lanes
    return torch.where(lane == 0, x, torch.where(
        lane == 1, y, torch.where(lane == 2, z, w)))


# -- acceptance thresholds ----------------------------------------------------

def thresholds(temperature: float, precision: str = "float32") -> List[int]:
    """The 10 uint32 thresholds, entry ``5 b + c``."""
    beta = np.float32(1.0 / float(temperature))
    a = np.float32(-2.0) * beta
    args = [a * np.float32(2 * c - 4) * np.float32(2 * b - 1)
            for b in (0, 1) for c in range(5)]
    p = torch.exp(torch.tensor(np.array(args, np.float32), dtype=torch.float64))
    p = p.to(PRECISIONS[precision]).to(torch.float64)
    return [int(math.floor(v * 4294967296.0)) if v < 1.0 else MASK32
            for v in p.tolist()]


# -- draws --------------------------------------------------------------------

def site_draws(layout: str, rows: torch.Tensor, cols: torch.Tensor,
               width: int, offset: int, seed: int) -> torch.Tensor:
    """The draw (uint32 in int64) of every site of the block ``rows`` x
    ``cols`` (global row and compact column indices, int64) of a colour
    plane ``width`` compact columns wide."""
    k0, k1 = keys(seed)
    r = rows[..., :, None]
    c = cols[..., None, :]
    if layout == "multispin":
        word = r * (width // 8) + c // 8
        q = c % 8
        lanes = philox((2 * offset + q // 4) & MASK32, 0, word & MASK32, 0,
                       k0, k1)
        return _pick(lanes, q % 4)
    if layout == "bitplane":
        site = r * width + c
        lanes = philox(offset, 0, (site // 4) & MASK32, 0, k0, k1)
        return _pick(lanes, site % 4)
    raise ValueError(f"unknown layout {layout!r}")


def row_draws(layout: str, r0: int, r1: int, width: int, offset: int,
              seed: int, device) -> torch.Tensor:
    """:func:`site_draws` of whole rows ``r0:r1``; the bitplane layout
    takes one Philox call for each four sites there."""
    if layout != "bitplane":
        rows = torch.arange(r0, r1, dtype=torch.int64, device=device)
        cols = torch.arange(width, dtype=torch.int64, device=device)
        return site_draws(layout, rows, cols, width, offset, seed)
    k0, k1 = keys(seed)
    groups = torch.arange(r0 * width // 4, r1 * width // 4,
                          dtype=torch.int64, device=device)
    lanes = philox(offset & MASK32, 0, groups & MASK32, 0, k0, k1)
    return torch.stack(lanes, dim=-1).reshape(r1 - r0, width)


# -- one half-sweep -----------------------------------------------------------

def _counts(up, down, centre, side):
    """Per bit, the sum of the four neighbour bits as three bit planes
    ``(n0, n1, n2)``: ``n0 + 2 n1 + 4 n2``."""
    half = up ^ down
    low3 = half ^ centre
    carry3 = (up & down) | (centre & half)
    n0 = low3 ^ side
    carry = low3 & side
    return n0, carry3 ^ carry, carry3 & carry


def flip_mask(target, counts, draws, thr: Sequence[int], replica_bits: int):
    """The bits of ``target`` that flip: replica bit ``r`` of a site
    flips iff the site's draw is below ``thr[5 b_r + c_r]``."""
    n0, n1, n2 = counts
    flip = torch.zeros_like(target)
    for b in (0, 1):
        spin = target if b else ~target
        for c in range(5):
            cls = (spin & (n0 if c & 1 else ~n0) & (n1 if c & 2 else ~n1)
                   & (n2 if c & 4 else ~n2))
            accept = -(draws < thr[5 * b + c]).to(target.dtype)
            flip |= cls & accept
    return flip & replica_bits


def _replica_bits(layout: str) -> int:
    return 1 if REPLICAS[layout] == 1 else -1


def half_sweep_block(layout: str, target, op, rows, cols, width: int,
                     is_black: bool, offset: int, seed: int,
                     thr: Sequence[int]):
    """One half-sweep of blocks cut out of the lattice, without wrap:
    ``target`` and ``op`` are ``(..., h, w)`` int32 planes of one colour
    each over global rows ``rows`` ``(..., h)`` and compact columns
    ``cols`` ``(..., w)`` (leading axes: independent blocks).  Returns
    the updated target, the opposite plane, the rows and the columns,
    all cropped by one row and one column on every side: what is left
    is exact."""
    inner = (..., slice(1, -1), slice(1, -1))
    up, down, centre = op[..., :-2, 1:-1], op[..., 2:, 1:-1], op[inner]
    odd = (rows[..., 1:-1] % 2 == 1)[..., :, None]
    take_plus = odd if is_black else ~odd
    side = torch.where(take_plus, op[..., 1:-1, 2:], op[..., 1:-1, :-2])
    tgt = target[inner]
    rows, cols = rows[..., 1:-1], cols[..., 1:-1]
    draws = site_draws(layout, rows, cols, width, offset, seed)
    new = tgt ^ flip_mask(tgt, _counts(up, down, centre, side), draws, thr,
                          _replica_bits(layout))
    return new, centre, rows, cols


def sweeps_block(layout: str, black, white, rows, cols, width: int,
                 step: int, n_sweeps: int, seed: int, thr):
    """``n_sweeps`` sweeps of blocks cut out of the lattice, from sweep
    ``step`` on: each block's centre, ``2 n_sweeps`` rows and compact
    columns in from each side, as ``(black, white)``."""
    start = 2 * int(step)
    for s in range(n_sweeps):
        off = (start + 2 * s) & MASK32
        black, white, rows, cols = half_sweep_block(
            layout, black, white, rows, cols, width, True, off, seed, thr)
        white, black, rows, cols = half_sweep_block(
            layout, white, black, rows, cols, width, False,
            (off + 1) & MASK32, seed, thr)
    return black, white


def _side(op, is_black: bool):
    odd = (torch.arange(op.shape[0], device=op.device) % 2 == 1)[:, None]
    take_plus = odd if is_black else ~odd
    return torch.where(take_plus, torch.roll(op, -1, 1),
                       torch.roll(op, 1, 1))


def sweeps_full(layout: str, black, white, step: int, n_sweeps: int,
                seed: int, thr):
    """``n_sweeps`` sweeps of the whole periodic lattice's ``(N, M/2)``
    colour planes (new tensors), a block of rows at a time."""
    n, width = black.shape
    rows = max(2, _CHUNK // width)
    start = 2 * int(step)

    def half(target, op, is_black, offset):
        up, down, side = torch.roll(op, 1, 0), torch.roll(op, -1, 0), \
            _side(op, is_black)
        out = torch.empty_like(target)
        for r0 in range(0, n, rows):
            r1 = min(n, r0 + rows)
            t = target[r0:r1]
            draws = row_draws(layout, r0, r1, width, offset, seed,
                              target.device)
            out[r0:r1] = t ^ flip_mask(
                t, _counts(up[r0:r1], down[r0:r1], op[r0:r1], side[r0:r1]),
                draws, thr, _replica_bits(layout))
        return out

    for s in range(n_sweeps):
        off = (start + 2 * s) & MASK32
        black = half(black, white, True, off)
        white = half(white, black, False, (off + 1) & MASK32)
    return black, white


# -- observables ----------------------------------------------------------------

def bit_totals(words: torch.Tensor, replicas: int) -> torch.Tensor:
    """(replicas,) int64: how many words have bit ``r`` set."""
    return torch.stack([((words >> r) & 1).sum(dtype=torch.int64)
                        for r in range(replicas)])


def observables(layout: str, black, white) -> Dict[str, np.ndarray]:
    """Each replica's magnetization and energy per spin of the whole
    periodic lattice, float32: ``(2 up - N) / N`` and ``-(2 N - 2 D) /
    N``, ``D`` the bonds whose ends differ, both from exact counts,
    divided in float64 and rounded once."""
    reps = REPLICAS[layout]
    sites = 2 * black.numel()
    up = bit_totals(black, reps) + bit_totals(white, reps)
    differ = torch.zeros(reps, dtype=torch.int64, device=black.device)
    for nb in (torch.roll(white, 1, 0), torch.roll(white, -1, 0), white,
               _side(white, True)):
        differ += bit_totals(black ^ nb, reps)
    up, differ = up.cpu().numpy(), differ.cpu().numpy()
    m = ((2 * up - sites).astype(np.float64) / sites).astype(np.float32)
    e = ((-(2 * sites - 2 * differ)).astype(np.float64) / sites) \
        .astype(np.float32)
    return {"m": m, "e": e}

