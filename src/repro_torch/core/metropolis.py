"""Checkerboard Metropolis with counter-based Philox, plain PyTorch.

Counterpart of ``repro.core.metropolis``: two compact +-1 int8 colour
planes, four-neighbour sums by rolls, and the Metropolis accept
``u < exp(-2 beta nn s)`` (or the heat-bath rule's sigmoid).  This
module is the plain version of both CUDA kernels of
``repro_torch.kernels.stencil``, which must match it bit for bit; its
:func:`philox_uniforms` and :func:`index_uniforms` are the plain version
of ``repro_torch.kernels.draws.philox_fill``.  :data:`run_sweeps`, the
``basic`` engine's loop, is :func:`run_sweeps_philox`: each half-sweep
draws the whole plane, then updates it (the engines draw through
``philox_fill`` instead).

The accept is a lookup in a 10-entry float32 table
(:func:`acceptance_table`), never a per-site ``exp``: ``torch.exp`` and
the JAX package's ``jnp.exp`` round some float32 arguments differently,
and a table computed once makes the CPU and the card agree exactly.  The
arguments ``-2 beta nn s`` are exact in float32 (``-2 beta`` is a power-
of-two scaling, nn in {0, +-2, +-4}, s = +-1), so a table built from the
JAX package's ``jnp.exp`` of the same arguments reproduces its flips.
The port's own table (float64 ``exp`` rounded once) decides flips as
``jnp.exp`` does at most temperatures but not at all: ``jnp.exp`` is not
correctly rounded, and where a flip-deciding entry differs by one ulp a
run leaves the JAX trajectory.
"""
from __future__ import annotations

import numpy as np
import torch

from . import lattice as lat
from . import rng

#: neighbour sums nn in {-4, -2, 0, 2, 4}, spins s in {-1, +1}: table
#: entry ``s_index * 5 + nn_index`` with s_index = (s + 1) / 2 and
#: nn_index = (nn + 4) / 2
TABLE_SIZE = 10

#: sites per Philox chunk in the plain version: bounds its int64
#: temporaries (about 20 live tensors of this many elements)
_CHUNK_SITES = 1 << 22


def acceptance_arguments(inv_temp) -> np.ndarray:
    """The 10 float32 arguments ``-2 beta nn s`` in table order, computed
    in float32 as the JAX package does (``beta = float32(inv_temp)``)."""
    a = np.float32(-2.0) * np.float32(inv_temp)
    return np.array([a * np.float32(nn) * np.float32(s)
                     for s in (-1, 1) for nn in (-4, -2, 0, 2, 4)],
                    dtype=np.float32)


#: the accept rules: Metropolis ``exp(arg)``, heat bath ``e^arg / (1 +
#: e^arg)`` (paper S2); both satisfy detailed balance on the checkerboard
RULES = ("metropolis", "heatbath")


def acceptance_table(inv_temp, rule: str = "metropolis") -> torch.Tensor:
    """The 10-entry float32 acceptance table on the host: ``exp`` (or, for
    ``rule="heatbath"``, ``sigmoid``) of :func:`acceptance_arguments` in
    float64, rounded once to float32."""
    if rule not in RULES:
        raise ValueError(f"rule must be one of {RULES}, got {rule!r}")
    args = torch.from_numpy(acceptance_arguments(inv_temp).astype(np.float64))
    table = torch.sigmoid(args) if rule == "heatbath" else torch.exp(args)
    return table.to(torch.float32)


def draw_bounds(table) -> np.ndarray:
    """The accept ``u < p`` of each float32 entry ``p`` of ``table`` as an
    exclusive bound on the raw uint32 draw: ``u < p`` iff ``draw < bound``,
    where ``u = float32(draw) * 2^-32`` rounds to nearest
    (``rng.u32_to_uniform``).  Rounding is monotone, so the bound is the
    least draw whose float32 reaches ``p * 2^32``: 0 where no draw flips
    (``p`` = 0, as the table underflows to at low temperature), 2^32 where
    every draw flips (``p`` > 1).  Returned as uint64."""
    target = np.asarray(table, np.float32).astype(np.float64) * 2.0 ** 32
    lo = np.zeros(target.shape, np.float64)
    hi = np.full(target.shape, 2.0 ** 32)      # float32(2^32) = 2^32
    for _ in range(33):                        # least x with f32(x) >= P
        mid = np.floor((lo + hi) / 2)
        reach = mid.astype(np.float32).astype(np.float64) >= target
        hi = np.where(reach, mid, hi)
        lo = np.where(reach, lo, mid + 1)
    return hi.astype(np.uint64)


def neighbor_sums(op_plane: torch.Tensor, is_black: bool) -> torch.Tensor:
    """Four-neighbour spin sums for every target cell, in int8
    (|sum| <= 4, so the narrow type is exact); ``(..., n, h)`` planes,
    leading axes (an ensemble's members) independent."""
    op = op_plane.to(torch.int8)
    up = torch.roll(op, 1, dims=-2)
    down = torch.roll(op, -1, dims=-2)
    return up + down + op + lat.side_shift(op, is_black)


def accept_flips(target, nn, uniforms, table):
    """The new target plane from its neighbour sums: flip iff
    ``u < table[s, nn]``."""
    index = (target > 0).to(torch.int64) * 5 + (nn.to(torch.int64) + 4) // 2
    accept = table.to(uniforms.device)[index]
    return torch.where(uniforms < accept, -target, target).to(target.dtype)


def update_color(target, op_plane, uniforms, table, is_black: bool):
    """One half-sweep with given uniforms: flip iff ``u < table[s, nn]``."""
    return accept_flips(target, neighbor_sums(op_plane, is_black), uniforms,
                        table)


def _lanes(bits, lanes: int):
    """The first ``lanes`` uint32 lanes of Philox calls as float32
    uniforms: one plane, or ``lanes`` of them stacked."""
    if lanes == 1:
        return rng.u32_to_uniform(bits[0])
    return torch.stack([rng.u32_to_uniform(b) for b in bits[:lanes]])


def philox_uniforms(n: int, h: int, seed: int, offset: int, device, *,
                    c1: int = 0, c3: int = 0, lanes: int = 1):
    """The (n, h) float32 uniforms of one half-sweep: lane 0 of Philox at
    counter ``(offset, c1, row*h + col, c3)``, key ``seed_keys(seed)``;
    ``lanes`` > 1 gives lanes 0 to ``lanes - 1`` of the same calls,
    ``(lanes, n, h)``.  The sweeps draw at c1 = c3 = 0; the other streams
    are in ``rng``'s table of lanes."""
    k0, k1 = rng.seed_keys(seed)
    shape = (n * h,) if lanes == 1 else (lanes, n * h)
    out = torch.empty(shape, dtype=torch.float32, device=device)
    chunk = rng.chunk_limit(_CHUNK_SITES, out.device)
    for s0 in range(0, n * h, chunk):
        s1 = min(n * h, s0 + chunk)
        idx = torch.arange(s0, s1, dtype=torch.int64, device=device)
        bits = rng.philox4x32(offset, c1, idx & rng.MASK32, c3, k0, k1)
        out[..., s0:s1] = _lanes(bits, lanes)
    return out.reshape(*shape[:-1], n, h)


def index_uniforms(index: torch.Tensor, seed: int, offset: int, *,
                   c1: int = 0, c3: int = 0, lanes: int = 1):
    """The float32 uniforms of lane 0 of Philox at counter ``(offset, c1,
    index, c3)`` for a plane of uint32 site indices (held in int32 or
    int64), a chunk at a time: the draws of a plane whose sites are not
    numbered row by row, as a halo-extended shard's are; ``lanes`` as in
    :func:`philox_uniforms`."""
    k0, k1 = rng.seed_keys(seed)
    flat = index.reshape(-1)
    shape = flat.shape if lanes == 1 else (lanes, *flat.shape)
    out = torch.empty(shape, dtype=torch.float32, device=index.device)
    chunk = rng.chunk_limit(_CHUNK_SITES, index.device)
    for s0 in range(0, flat.numel(), chunk):
        idx = flat[s0:s0 + chunk].to(torch.int64) & rng.MASK32
        bits = rng.philox4x32(offset, c1, idx, c3, k0, k1)
        out[..., s0:s0 + chunk] = _lanes(bits, lanes)
    return out.reshape(*shape[:-1], *index.shape)


def update_color_philox(target, op_plane, table, is_black: bool, seed: int,
                        offset: int):
    """One half-sweep drawing its uniforms from counter-based Philox."""
    n, h = target.shape
    u = philox_uniforms(n, h, seed, offset, target.device)
    return update_color(target, op_plane, u, table, is_black)


def run_sweeps_philox(black, white, table, n_sweeps: int, seed: int,
                      start_offset: int = 0):
    """``n_sweeps`` full sweeps (black, then white) at offsets
    ``half_sweep_offset(start_offset, i, colour)``.  ``start_offset`` is
    the cumulative half-sweep count already consumed, so a restored run
    continues the same stream."""
    for i in range(n_sweeps):
        black = update_color_philox(
            black, white, table, True, seed,
            rng.half_sweep_offset(start_offset, i, 0))
        white = update_color_philox(
            white, black, table, False, seed,
            rng.half_sweep_offset(start_offset, i, 1))
    return black, white


#: the ``basic`` engine's loop (paper S3.1's basic path): each half-sweep
#: first fills a whole plane of uniforms, then updates the colour with
#: them, which is what :func:`run_sweeps_philox` does
run_sweeps = run_sweeps_philox
