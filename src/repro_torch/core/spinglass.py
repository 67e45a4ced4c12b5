"""2D Edwards-Anderson +-J spin glass (paper S6's suggested extension).

Counterpart of ``repro.core.spinglass``: quenched couplings J = +-1 on
every bond, the checkerboard decomposition of the full ``(n, m)``
lattice, and the Metropolis accept on the coupling-weighted neighbour
sum.  ``j_up[i, j]`` is the bond between ``(i, j)`` and ``(i-1, j)``,
``j_left[i, j]`` the one to ``(i, j-1)``; the opposite bonds are their
rolls, so every bond is counted from both ends alike.

The weighted sums stay int8: |sum| <= 4.  The accept is a lookup in the
10-entry table of ``metropolis.acceptance_table``: the weighted sum
takes the values of the ferromagnet's, {0, +-2, +-4}.  The JAX package
calls ``jnp.exp`` per site, which is not correctly rounded on the CPU,
so its flips are the port's where the two tables agree (ROADMAP
Queue 3).

Draws: the couplings at Philox counter ``(0, 3, site, 0)`` (lane 0
``j_up``, lane 1 ``j_left``, ``site = i*m + j``); the half-sweep of
colour c at ``(offset, 0, k, 0)``, k the site's index in its compact
colour plane (``lattice.split_checkerboard``), offsets
``half_sweep_offset``'s.  So at ``p_ferro = 1`` a run is the
``basic_philox`` run from the same lattice bit for bit.  The JAX
package draws both from ``jax.random``.
"""
from __future__ import annotations

import torch

from . import metropolis as metro
from . import rng


def init_couplings(n: int, m: int, p_ferro: float, seed: int, device):
    """The quenched bonds ``(j_up, j_left)``, ``(n, m)`` int8 planes, from
    lanes 0 and 1 of Philox at ``(0, 3, i*m + j, 0)``: +1 where the
    uniform is below the float32 ``p_ferro``, as the JAX package's
    ``init_couplings`` decides.  A pure function of the seed, so two runs
    of one seed share a disorder sample."""
    from repro_torch.kernels.draws import philox_fill
    u = philox_fill([seed], 0, shape=(n, m), device=device,
                    c1=rng.COUPLING_LANE, lanes=2)[:, 0]
    below = u < torch.tensor(p_ferro, dtype=torch.float32, device=u.device)
    return tuple(torch.where(b, 1, -1).to(torch.int8) for b in below)


def _down_right(j_up, j_left):
    """The bonds to ``(i+1, j)`` and ``(i, j+1)``: the neighbour's own
    ``j_up`` and ``j_left``."""
    return torch.roll(j_up, -1, 0), torch.roll(j_left, -1, 1)


def weighted_neighbor_sums(full, j_up, j_left, bonds=None):
    """sum_j J_ij s_j for every site of the full lattice, in int8;
    ``bonds`` is ``_down_right(j_up, j_left)`` where the caller holds
    it."""
    j_down, j_right = _down_right(j_up, j_left) if bonds is None else bonds
    s = full.to(torch.int8)
    return (j_up * torch.roll(s, 1, 0) + j_down * torch.roll(s, -1, 0)
            + j_left * torch.roll(s, 1, 1) + j_right * torch.roll(s, -1, 1))


def energy_per_spin(full, j_up, j_left) -> torch.Tensor:
    """-1/N sum_<ij> J_ij s_i s_j, each bond once: an exact integer sum
    (int8 products, int64 sum) divided once, as a 0-d float32 tensor."""
    s = full.to(torch.int8)
    bonds = ((j_up * s * torch.roll(s, 1, 0)).sum(dtype=torch.int64)
             + (j_left * s * torch.roll(s, 1, 1)).sum(dtype=torch.int64))
    return (-bonds.to(torch.float64) / full.numel()).to(torch.float32)


def color_mask(n: int, m: int, color: int, device) -> torch.Tensor:
    """The sites with ``(i + j) % 2 == color``."""
    ii = torch.arange(n, device=device)[:, None]
    jj = torch.arange(m, device=device)[None, :]
    return (ii + jj) % 2 == color


def update_color(full, j_up, j_left, uniforms, table, color: int,
                 bonds=None, mask=None):
    """A Metropolis half-sweep of the sites of ``color`` with the ``(n,
    m)`` ``uniforms`` (as the JAX function takes them): flip iff ``u <
    table[s, nn]``, ``nn`` the weighted sum.  ``bonds`` and ``mask``
    (``color_mask``) where the caller holds them."""
    nn = weighted_neighbor_sums(full, j_up, j_left, bonds)
    flipped = metro.accept_flips(full, nn, uniforms, table)
    if mask is None:
        mask = color_mask(*full.shape, color, full.device)
    return torch.where(mask, flipped, full)


def color_uniforms(n: int, m: int, seed: int, offset: int, device):
    """The ``(n, m)`` uniforms of a half-sweep: each site's draw at its
    compact colour-plane index, ``(offset, 0, i*(m/2) + j//2, 0)``.  A
    column pair shares its draw, which serves the pair's site of either
    colour."""
    from repro_torch.kernels.draws import uniforms
    return uniforms((n, m // 2), seed, offset, device).repeat_interleave(
        2, dim=1)


def run_sweeps(full, j_up, j_left, table, n_sweeps: int, seed: int,
               start_offset: int = 0):
    """``n_sweeps`` sweeps (colour 0, then 1) at the offsets
    ``half_sweep_offset(start_offset, i, colour)``."""
    n, m = full.shape
    bonds = _down_right(j_up, j_left)
    masks = [color_mask(n, m, c, full.device) for c in (0, 1)]
    for i in range(n_sweeps):
        for c in (0, 1):
            u = color_uniforms(n, m, seed,
                               rng.half_sweep_offset(start_offset, i, c),
                               full.device)
            full = update_color(full, j_up, j_left, u, table, c, bonds,
                                masks[c])
    return full
