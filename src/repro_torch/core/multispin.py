"""Multi-spin coding (paper S3.3): 8 spins per uint32 word, plain PyTorch.

Counterpart of ``repro.core.multispin``.  Spins are 0/1 nibbles, 8 per
uint32 word (nibble n of word w is compact column 8w + n); the neighbour
sums of a word take three packed adds; two Philox4x32-10 calls at
counters ``(2*offset, 0, widx, 0)`` and ``(2*offset + 1, 0, widx, 0)``,
``widx = row * W + col``, give the word's 8 draws (lanes of the first
call to nibbles 0-3, of the second to 4-7); a spin flips iff its raw
uint32 draw is below ``t[s * 5 + nn]`` (:func:`acceptance_thresholds`).
This module is the plain version of both CUDA kernels of
``repro_torch.kernels.multispin``, which must match it bit for bit.

Word planes are ``torch.int32`` tensors holding the uint32 bits; the
arithmetic runs on uint32 values widened to int64
(``lattice.words_to_u32``).  Every function here takes and returns int32
word planes.  The sweep functions also take an ensemble's ``(B, n, w)``
planes with a ``(B, 10)`` threshold table and a sequence of B seeds, one
a member, and update every member at once: member i's planes are those
of its own single-plane update.
"""
from __future__ import annotations

from typing import Sequence, Union

import torch

from . import lattice as lat
from . import metropolis as metro
from . import rng

#: words per Philox chunk: bounds the int64 temporaries of the draws
_CHUNK_WORDS = 1 << 21

#: rows per chunk of packing and unpacking
_PACK_CHUNK_SITES = 1 << 24


def acceptance_thresholds(inv_temp) -> torch.Tensor:
    """The 10 uint32 thresholds (int64 tensor on the host): entry
    ``s * 5 + c`` (s the 0/1 spin, c the count of up neighbours) is
    ``trunc(p * 2^32)`` where ``p < 1``, else ``0xFFFFFFFF``; ``p`` is the
    float32 ``exp(-2 beta (2s - 1)(2c - 4))`` of
    :func:`metropolis.acceptance_table`, whose entry ``s_index * 5 +
    nn_index`` has the same argument.  ``p < 1`` in float32 means
    ``p <= 1 - 2^-24``, so ``p * 2^32`` fits 32 bits exactly.  A class with
    ``p >= 1`` flips unless the draw is ``0xFFFFFFFF``."""
    p = metro.acceptance_table(inv_temp).to(torch.float64)
    scaled = torch.floor(p * 4294967296.0).to(torch.int64)
    return torch.where(p < 1.0, scaled, torch.full_like(scaled, rng.MASK32))


#: one seed, or a seed a member of ``(B, n, w)`` planes
Seeds = Union[int, Sequence[int]]


def _keys(seed: Seeds, device):
    """The Philox key lanes of ``seed``: two ints, or for a sequence of
    member seeds two ``(B, 1, 1)`` int64 tensors."""
    if not isinstance(seed, (list, tuple)):
        return rng.seed_keys(seed)
    keys = torch.tensor([rng.seed_keys(s) for s in seed], dtype=torch.int64,
                        device=device)
    return keys[:, 0, None, None], keys[:, 1, None, None]


def word_randoms(seed: Seeds, word_index: torch.Tensor, offset: int):
    """The 8 uint32 draws (int64) of each word: lanes of Philox at
    counters ``(2*offset, 0, widx, 0)`` and ``(2*offset + 1, 0, widx,
    0)``, key ``seed_keys(seed)``; ``2*offset`` wraps modulo 2^32.  A
    sequence of B seeds gives ``(B, ...)`` draws, member i's keyed on
    seed i."""
    k0, k1 = _keys(seed, word_index.device)
    lo = rng.philox4x32((2 * int(offset)) & rng.MASK32, 0, word_index, 0,
                        k0, k1)
    hi = rng.philox4x32((2 * int(offset) + 1) & rng.MASK32, 0, word_index,
                        0, k0, k1)
    return lo + hi


def flip_words(target: torch.Tensor, nn_words: torch.Tensor, draws,
               thresholds: torch.Tensor) -> torch.Tensor:
    """The flip word of each target word (uint32 values in int64); for
    ``(B, n, w)`` words ``thresholds`` is ``(B, 10)``, a table a
    member."""
    flip = torch.zeros_like(target)
    base = 0
    if thresholds.dim() == 2:
        base = (torch.arange(thresholds.shape[0], device=target.device)
                * metro.TABLE_SIZE)[:, None, None]
    flat = thresholds.reshape(-1)
    for nib in range(lat.SPINS_PER_WORD):
        sh = nib * lat.NIBBLE_BITS
        s = (target >> sh) & 1
        nn = (nn_words >> sh) & 0xF
        t = flat[base + s * 5 + nn]
        flip |= (draws[nib] < t).to(torch.int64) << sh
    return flip


def update_words(target_words, nn_words, thresholds, seed: Seeds,
                 offset: int, widx=None) -> torch.Tensor:
    """The new target word plane (int32) from its packed neighbour sums
    (uint32 values in int64).  Words are keyed on ``row * W + col`` or,
    where ``widx`` is given, on that plane of uint32 word indices (a
    shard's).  ``(B, n, w)`` planes take a ``(B, 10)`` table and B
    seeds."""
    n, w = target_words.shape[-2:]
    target = lat.words_to_u32(target_words)
    thr = thresholds.to(device=target.device, dtype=torch.int64)
    out = torch.empty_like(target_words, dtype=torch.int32)
    rows = max(1, rng.chunk_limit(_CHUNK_WORDS, target.device)
               // (target[..., 0, 0].numel() * w))
    for r0 in range(0, n, rows):
        r1 = min(n, r0 + rows)
        if widx is None:
            index = torch.arange(r0 * w, r1 * w, dtype=torch.int64,
                                 device=target.device).reshape(r1 - r0, w)
        else:
            index = widx[r0:r1].to(torch.int64)
        draws = word_randoms(seed, index & rng.MASK32, offset)
        rows_of = (..., slice(r0, r1), slice(None))
        flip = flip_words(target[rows_of], nn_words[rows_of], draws, thr)
        out[rows_of] = lat.u32_to_words(target[rows_of] ^ flip)
    return out


def update_color_packed(target_words, op_words, thresholds, is_black: bool,
                        seed: Seeds, offset: int, widx=None
                        ) -> torch.Tensor:
    """One packed half-sweep: the new target word plane (int32), keyed as
    :func:`update_words`."""
    return update_words(target_words,
                        lat.packed_neighbor_sums(op_words, is_black),
                        thresholds, seed, offset, widx)


def run_sweeps_packed(black_words, white_words, thresholds, n_sweeps: int,
                      seed: Seeds, start_offset: int = 0):
    """``n_sweeps`` full sweeps (black, then white) at offsets
    ``half_sweep_offset(start_offset, i, colour)``."""
    for i in range(n_sweeps):
        black_words = update_color_packed(
            black_words, white_words, thresholds, True, seed,
            rng.half_sweep_offset(start_offset, i, 0))
        white_words = update_color_packed(
            white_words, black_words, thresholds, False, seed,
            rng.half_sweep_offset(start_offset, i, 1))
    return black_words, white_words


def _row_chunks(plane: torch.Tensor):
    """Row ranges of ``(..., n, c)`` planes, about
    :data:`_PACK_CHUNK_SITES` sites of all leading planes together."""
    n, c = plane.shape[-2:]
    rows = max(1, _PACK_CHUNK_SITES // max(1, plane[..., 0, 0].numel() * c))
    for r0 in range(0, n, rows):
        yield r0, min(n, r0 + rows)


def pack_plane(plane_pm1: torch.Tensor) -> torch.Tensor:
    """A +-1 compact plane -> its int32 word plane, a block of rows at a
    time (the int64 temporaries of a whole plane would be 8 bytes a
    spin)."""
    n, c = plane_pm1.shape
    out = torch.empty((n, c // lat.SPINS_PER_WORD), dtype=torch.int32,
                      device=plane_pm1.device)
    for r0, r1 in _row_chunks(plane_pm1):
        out[r0:r1] = lat.u32_to_words(
            lat.pack_nibbles(lat.to_binary(plane_pm1[r0:r1])))
    return out


def unpack_plane(words: torch.Tensor, dtype=torch.int8) -> torch.Tensor:
    """Inverse of :func:`pack_plane`; ``(..., n, w)`` word planes (an
    ensemble's) give ``(..., n, 8 w)`` planes."""
    out = torch.empty((*words.shape[:-1], words.shape[-1]
                       * lat.SPINS_PER_WORD), dtype=dtype,
                      device=words.device)
    for r0, r1 in _row_chunks(out):
        out[..., r0:r1, :] = lat.from_binary(
            lat.unpack_nibbles(words[..., r0:r1, :]), dtype)
    return out


def pack_lattice(black_pm1, white_pm1):
    """+-1 compact planes -> int32 word planes."""
    return pack_plane(black_pm1), pack_plane(white_pm1)


def unpack_lattice(black_words, white_words, dtype=torch.int8):
    """int32 word planes -> +-1 compact planes."""
    return unpack_plane(black_words, dtype), unpack_plane(white_words, dtype)
