"""Bitplane multi-spin coding: 32 replicas, 1 bit per spin, plain PyTorch.

Counterpart of ``repro.core.bitplane`` (Block, Virnau & Preis): bit r of
word ``(i, k)`` is the 0/1 spin of replica r at compact site ``(i, k)``,
so one ``(N, M/2)`` uint32 colour plane holds 32 lattices.  The
four-neighbour up-count of all 32 replicas is three bitplanes from a
carry-save adder; all 32 replicas at a site share one uint32 draw (one
Philox4x32-10 call at counter ``(offset, 0, site // 4, 0)`` per four
sites, lane ``site % 4``); the accept is the OR over the 10 (spin,
count) classes of ``class mask & (draw < t_class)`` with the thresholds
of :func:`repro_torch.core.multispin.acceptance_thresholds`.  This module
is the plain version of both CUDA kernels of
``repro_torch.kernels.bitplane``, which must match it bit for bit.

Shared draws couple the replicas: replicas that start equal stay equal,
so a run of 32 distinct replicas starts hot (``init_p_up = 0.5``), not
from an ordered lattice.

Word planes are ``torch.int32`` tensors holding the uint32 bits; the
bitwise arithmetic runs on them directly, the draws and thresholds on
uint32 values in int64.
"""
from __future__ import annotations

import math

import torch

from . import lattice as lat
from . import rng

N_REPLICAS = 32

#: groups of 4 sites per Philox chunk of the plain update
_CHUNK_GROUPS = 1 << 20

#: words per chunk of a per-replica bit count
_COUNT_CHUNK = 1 << 20


def _shifts(device) -> torch.Tensor:
    return torch.arange(N_REPLICAS, dtype=torch.int64, device=device)


# -- packing: replica axis <-> word bits -------------------------------------

def pack_replicas(planes01: torch.Tensor) -> torch.Tensor:
    """(32, N, C) 0/1 planes -> (N, C) int32 words, bit r = replica r."""
    if planes01.shape[0] != N_REPLICAS:
        raise ValueError(f"need {N_REPLICAS} replica planes, got "
                         f"{tuple(planes01.shape)}")
    shifts = _shifts(planes01.device)[:, None, None]
    return lat.u32_to_words((planes01.to(torch.int64) << shifts).sum(0))


def unpack_replicas(words: torch.Tensor) -> torch.Tensor:
    """(N, C) words -> (32, N, C) 0/1 int64 planes."""
    shifts = _shifts(words.device)[:, None, None]
    return (lat.words_to_u32(words)[None] >> shifts) & 1


def pack_lattices(fulls_pm1: torch.Tensor):
    """(32, N, M) +-1 replica lattices -> (black_words, white_words)."""
    planes = [lat.split_checkerboard(f) for f in fulls_pm1]
    return (pack_replicas(lat.to_binary(torch.stack([b for b, _ in planes]))),
            pack_replicas(lat.to_binary(torch.stack([w for _, w in planes]))))


def unpack_lattices(black_words, white_words, dtype=torch.int8):
    """(N, W) word planes -> (32, N, M) +-1 replica lattices."""
    black = lat.from_binary(unpack_replicas(black_words), dtype)
    white = lat.from_binary(unpack_replicas(white_words), dtype)
    return torch.stack([lat.merge_checkerboard(b, w)
                        for b, w in zip(black, white)])


def replica_lattice(black_words, white_words, r: int, dtype=torch.int8):
    """The (N, M) +-1 lattice of one replica (a single-bit extract)."""
    black = lat.from_binary((lat.words_to_u32(black_words) >> r) & 1, dtype)
    white = lat.from_binary((lat.words_to_u32(white_words) >> r) & 1, dtype)
    return lat.merge_checkerboard(black, white)


def init_words(n: int, m: int, p_up: float, seed: int, device, rows=None,
               cols=None):
    """Fresh ``(black_words, white_words)``: replica r is lane ``r % 4``
    of the init draws at counter lane c3 = ``r // 4``
    (``lattice.init_row_chunks``), so replica 0 is the single-lattice
    init of the same seed, and the replicas differ from one another.
    ``rows`` and ``cols`` select a block of the lattice, as in
    ``lattice.init_planes``."""
    i0, i1 = rows if rows is not None else (0, n)
    j0, j1 = cols if cols is not None else (0, m)
    black = torch.empty((i1 - i0, (j1 - j0) // 2), dtype=torch.int32,
                        device=device)
    white = torch.empty_like(black)
    for r0, r1, draws in lat.init_row_chunks(n, m, seed, device,
                                             replica_groups=N_REPLICAS // 4,
                                             rows=rows, cols=cols):
        words = torch.zeros((r1 - r0, j1 - j0), dtype=torch.int64,
                            device=device)
        for r in range(N_REPLICAS):
            words |= lat.spin_up(draws[r // 4][r % 4], p_up).to(
                torch.int64) << r
        b, w = lat.split_checkerboard(words)
        black[r0 - i0:r1 - i0] = lat.u32_to_words(b)
        white[r0 - i0:r1 - i0] = lat.u32_to_words(w)
    return black, white


# -- bit-sliced neighbour counting -------------------------------------------

def bit_count_neighbors(up, down, center, side):
    """Carry-save 4-input adder: bitplanes ``(n0, n1, n2)`` with the
    per-replica up-count ``n0 + 2 n1 + 4 n2`` in 0..4."""
    t = up ^ down
    s = t ^ center                      # low bit of up + down + center
    k = (up & down) | (center & t)      # its carry
    n0 = s ^ side
    k2 = s & side
    return n0, k ^ k2, k & k2


def neighbor_counts(op_words: torch.Tensor, is_black: bool):
    """``(n0, n1, n2)`` from the opposite colour plane: up/down rolls and
    the row-parity side tap, one word per site."""
    up = torch.roll(op_words, 1, dims=0)
    down = torch.roll(op_words, -1, dims=0)
    side = lat.side_shift(op_words, is_black)
    return bit_count_neighbors(up, down, op_words, side)


# -- shared randomness: one uint32 per site ----------------------------------

def site_randoms(seed: int, n_rows: int, n_cols: int, offset: int, device,
                 first_row: int = 0) -> torch.Tensor:
    """The (n_rows, n_cols) uint32 draws (int64) of rows ``first_row``
    onward of an ``n_cols``-wide plane: counter ``(offset, 0, site // 4,
    0)``, lane ``site % 4``, in row-major site order."""
    if n_cols % 4:
        raise ValueError(f"bitplane planes need a multiple-of-4 width, got "
                         f"{n_cols}")
    k0, k1 = rng.seed_keys(seed)
    g0 = first_row * n_cols // 4
    g = torch.arange(g0, g0 + n_rows * n_cols // 4, dtype=torch.int64,
                     device=device)
    lanes = rng.philox4x32(int(offset) & rng.MASK32, 0, g & rng.MASK32, 0,
                           k0, k1)
    return torch.stack(lanes, dim=-1).reshape(n_rows, n_cols)


# -- bit-parallel Metropolis accept ------------------------------------------

def flip_word_from_classes(target, counts, draws, thresholds):
    """``OR_c(class_mask_c & broadcast(u < t_c))`` over the 10 (s, nn)
    classes: the flip word of all 32 replicas (int32 words)."""
    n0, n1, n2 = counts
    not_t, not_n0, not_n1, not_n2 = ~target, ~n0, ~n1, ~n2
    thr = [int(v) for v in thresholds.tolist()]
    flip = torch.zeros_like(target)
    for s in (0, 1):
        s_mask = target if s else not_t
        for nn in range(5):
            mask = (s_mask
                    & (n0 if nn & 1 else not_n0)
                    & (n1 if nn & 2 else not_n1)
                    & (n2 if nn & 4 else not_n2))
            accept = -(draws < thr[s * 5 + nn]).to(target.dtype)
            flip |= mask & accept
    return flip


def flip_word_three(target, counts, draws, t4: int, t8: int):
    """The flip word of the three-threshold accept (``csrc/bitplane.cu``,
    ``Accept<true>``), for thresholds of a ferromagnet's layout
    (``repro_torch.kernels._words.three_thresholds``): the class mask of
    (s, c) = (1, 4) and (0, 0) where ``draws < t8``, of (1, 3) and
    (0, 1) where ``draws < t4``, of every other class where ``draws <
    0xFFFFFFFF``.  Equals :func:`flip_word_from_classes` for such
    thresholds."""
    n0, n1, n2 = counts
    m8 = (target & n2) | ~(target | n0 | n1 | n2)
    m4 = n0 & ~(target ^ n1)

    def below(threshold):
        return -(draws < threshold).to(target.dtype)

    return ((below(rng.MASK32) & ~(m4 | m8)) | (below(t4) & m4)
            | (below(t8) & m8))


def lane_draws(seed: int, gidx: torch.Tensor, lane: torch.Tensor,
               offset: int) -> torch.Tensor:
    """One uint32 draw (int64) per site from planes of uint32 group
    indices and lanes (int32 or int64): lane ``lane`` (0, 1, 2, else 3)
    of Philox at counter ``(offset, 0, gidx, 0)`` -- the per-site form of
    :func:`site_randoms`, for planes whose sites are not numbered row by
    row."""
    k0, k1 = rng.seed_keys(seed)
    l0, l1, l2, l3 = rng.philox4x32(int(offset) & rng.MASK32, 0,
                                    gidx.to(torch.int64) & rng.MASK32, 0,
                                    k0, k1)
    return torch.where(lane == 0, l0, torch.where(
        lane == 1, l1, torch.where(lane == 2, l2, l3)))


def update_bits(target_words, counts, thresholds, draws_of):
    """The new int32 target plane from its neighbour counts ``(n0, n1,
    n2)`` and ``draws_of(r0, r1)``, the draws of rows ``r0:r1``, a block
    of rows at a time."""
    n, w = target_words.shape
    n0, n1, n2 = counts
    out = torch.empty_like(target_words)
    rows = max(1, 4 * rng.chunk_limit(_CHUNK_GROUPS, out.device) // w)
    for r0 in range(0, n, rows):
        r1 = min(n, r0 + rows)
        t = target_words[r0:r1]
        out[r0:r1] = t ^ flip_word_from_classes(
            t, (n0[r0:r1], n1[r0:r1], n2[r0:r1]), draws_of(r0, r1),
            thresholds)
    return out


def update_color_bitplane(target_words, op_words, thresholds,
                          is_black: bool, seed: int, offset: int,
                          gidx=None, lane=None):
    """One bitplane half-sweep of all 32 replicas: the new int32 target
    plane.  Sites draw as :func:`site_randoms` numbers them or, where
    ``gidx`` and ``lane`` are given, as :func:`lane_draws` of those
    planes (a halo-extended shard's)."""
    n, w = target_words.shape
    if gidx is None:
        def draws_of(r0, r1):
            return site_randoms(seed, r1 - r0, w, offset,
                                target_words.device, first_row=r0)
    else:
        def draws_of(r0, r1):
            return lane_draws(seed, gidx[r0:r1], lane[r0:r1], offset)
    return update_bits(target_words, neighbor_counts(op_words, is_black),
                       thresholds, draws_of)


def run_sweeps_bitplane(black_words, white_words, thresholds, n_sweeps: int,
                        seed: int, start_offset: int = 0):
    """``n_sweeps`` full sweeps (black, then white) at offsets
    ``half_sweep_offset(start_offset, i, colour)``."""
    for i in range(n_sweeps):
        black_words = update_color_bitplane(
            black_words, white_words, thresholds, True, seed,
            rng.half_sweep_offset(start_offset, i, 0))
        white_words = update_color_bitplane(
            white_words, black_words, thresholds, False, seed,
            rng.half_sweep_offset(start_offset, i, 1))
    return black_words, white_words


# -- per-replica observables -------------------------------------------------

def bit_counts(words: torch.Tensor) -> torch.Tensor:
    """(32,) int64: how many words of the tensor have bit r set, a chunk
    of words at a time (no (32, N, C) stack)."""
    return plane_bit_counts(words.reshape(1, -1))


def plane_bit_counts(words: torch.Tensor) -> torch.Tensor:
    """:func:`bit_counts` of each ``(n, w)`` plane of ``(..., n, w)``
    words (an ensemble's: ``(B, 32)``), with chunks of about as many
    words of all planes together."""
    lead = words.shape[:-2]
    flat = words.reshape(*lead, -1)
    step = max(1, _COUNT_CHUNK // math.prod(lead))
    shifts = _shifts(words.device).to(words.dtype)
    total = torch.zeros((*lead, N_REPLICAS), dtype=torch.int64,
                        device=words.device)
    for i in range(0, flat.shape[-1], step):
        chunk = flat[..., i:i + step, None]
        total += ((chunk >> shifts) & 1).sum(-2, dtype=torch.int64)
    return total


def _means(total: torch.Tensor, count: int) -> torch.Tensor:
    return (total.to(torch.float64) / count).to(torch.float32)


def replica_sites(black_words) -> int:
    """Sites of one replica lattice of ``(..., n, w)`` word planes (of
    one member): ``2 n w``, the black and the white half."""
    return 2 * black_words.shape[-2] * black_words.shape[-1]


def up_counts(black_words, white_words) -> torch.Tensor:
    """(32,) int64: replica r's up spins, the set bits r of both planes;
    ``(B, 32)`` for an ensemble's ``(B, n, w)`` planes."""
    return plane_bit_counts(black_words) + plane_bit_counts(white_words)


def disagreements(black_words, white_words) -> torch.Tensor:
    """(32,) int64: ``D_r``, the bonds whose ends disagree in bit r.
    Every bond joins a black site and one of its 4 white neighbours (up,
    down, centre and the side tap), so XORing each black word with each
    neighbour counts every bond once.  ``(B, 32)`` for ``(B, n, w)``
    planes."""
    disagree = 0
    for nb in (torch.roll(white_words, 1, dims=-2),
               torch.roll(white_words, -1, dims=-2), white_words,
               lat.side_shift(white_words, is_black=True)):
        disagree += plane_bit_counts(black_words ^ nb)
    return disagree


def replica_counts(black_words, white_words) -> torch.Tensor:
    """(2, 32) int64: ``[0, r]`` = :func:`up_counts`, ``[1, r]`` =
    :func:`disagreements`; ``(B, 2, 32)`` for ``(B, n, w)`` planes."""
    return torch.stack([up_counts(black_words, white_words),
                        disagreements(black_words, white_words)], dim=-2)


def magnetizations_of(up: torch.Tensor, count: int) -> torch.Tensor:
    """Float32 mean spins ``(2 up - N) / N`` of int64 up counts of
    lattices of ``count`` sites, each rounded once from float64."""
    return _means(2 * up - count, count)


def energies_of(disagree: torch.Tensor, count: int) -> torch.Tensor:
    """Float32 energies per spin of int64 disagreement counts: a bond
    contributes ``1 - 2 (b xor w)``, so the bond sum is ``2 N - 2 D`` --
    the same integer as the sum over the merged lattice."""
    return _means(-(2 * count - 2 * disagree), count)


def observables_of(counts: torch.Tensor, count: int) -> dict:
    """``{"m": (..., 32), "e": (..., 32)}`` float32 of ``(..., 2, 32)``
    :func:`replica_counts` of lattices of ``count`` sites."""
    return {"m": magnetizations_of(counts[..., 0, :], count),
            "e": energies_of(counts[..., 1, :], count)}


def replica_observables(black_words, white_words) -> dict:
    """``{"m": (32,), "e": (32,)}`` float32, one value per replica
    (``(B, 32)`` each for an ensemble's planes)."""
    return observables_of(replica_counts(black_words, white_words),
                          replica_sites(black_words))
