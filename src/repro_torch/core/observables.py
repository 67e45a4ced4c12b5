"""Observables of the 2D Ising model: magnetization and energy per spin.

Counterpart of ``repro.core.observables``.  The JAX package sums +-1
spins in float32, which is exact only up to 2^24 spins.  Here the sums
are integers (int64) and the quotient is taken in float64 and rounded
once to float32: for lattices up to 2^24 spins that is the JAX value bit
for bit, and at 2^30 spins the sum stays exact.  Results are 0-d float32
tensors on the planes' device; the compact-plane functions also take an
ensemble's ``(B, n, w)`` planes and give ``(B,)`` values, each equal to
the member's own, since the sums are integers.
"""
from __future__ import annotations

import math

import torch

from . import lattice as lat

T_CRITICAL = 2.269185  # 2 / ln(1 + sqrt(2)), J = 1

#: elements per chunk of an integer sum
_SUM_CHUNK = 1 << 24


def _int_sum(t: torch.Tensor) -> torch.Tensor:
    """Sum over the last two axes of an integer tensor in int64, a block
    of rows at a time (of every leading plane together): the int64 copy
    a whole-plane ``sum(dtype=int64)`` makes would take 4 GiB at 2^29
    sites.  A 2-D plane gives a 0-d sum, ``(B, n, w)`` planes ``(B,)``."""
    n, w = t.shape[-2:]
    rows = max(1, _SUM_CHUNK // max(1, t[..., 0, 0].numel() * w))
    return sum(t[..., i:i + rows, :].sum(dim=(-2, -1), dtype=torch.int64)
               for i in range(0, n, rows))


def _sites(plane: torch.Tensor) -> int:
    """Sites of one ``(..., n, w)`` plane (of one member)."""
    return plane.shape[-2] * plane.shape[-1]


def _mean(total: torch.Tensor, count: int) -> torch.Tensor:
    return (total.to(torch.float64) / count).to(torch.float32)


def magnetization(black: torch.Tensor, white: torch.Tensor) -> torch.Tensor:
    """Mean spin over the full lattice from the compact +-1 planes."""
    return _mean(_int_sum(black) + _int_sum(white),
                 _sites(black) + _sites(white))


def magnetization_full(full: torch.Tensor) -> torch.Tensor:
    """Mean spin of an (N, M) +-1 lattice."""
    return _mean(_int_sum(full), full.numel())


def energy_per_spin_full(full: torch.Tensor) -> torch.Tensor:
    """H / (J N_spins) = -(1/N) sum_<ij> s_i s_j, one roll per axis so
    that every vertical and horizontal bond counts once."""
    s = full.to(torch.int64)
    bonds = ((s * torch.roll(s, 1, dims=0)).sum()
             + (s * torch.roll(s, 1, dims=1)).sum())
    return _mean(-bonds, full.numel())


def energy_per_spin(black: torch.Tensor, white: torch.Tensor) -> torch.Tensor:
    """Energy per spin from the compact planes, without merging them.

    Every bond joins a black and a white site, so the bond sum is the sum
    over black sites of the spin times its four white neighbours: the
    same integer as :func:`energy_per_spin_full` of the merged lattice.
    Products stay int8 (|s * nn| <= 4) and only the sum widens.
    """
    nn = (torch.roll(white, 1, dims=-2) + torch.roll(white, -1, dims=-2)
          + white + lat.side_shift(white, is_black=True))
    return _mean(-_int_sum(black * nn), _sites(black) + _sites(white))


def magnetization_planes(planes: dict) -> torch.Tensor:
    """Mean spin of the tensor-core engine's four sublattice planes
    ``'00'``, ``'01'``, ``'10'``, ``'11'``."""
    total = sum(_int_sum(planes[k]) for k in ("00", "01", "10", "11"))
    return _mean(total, 4 * planes["00"].numel())


def energy_per_spin_planes(planes: dict) -> torch.Tensor:
    """Energy per spin without recomposing the lattice: every bond joins
    a black site (00 or 11) and a white one, so the bond sum is the sum
    over black sites of the spin times its four neighbours (the
    elementwise form of ``repro_torch.core.tensorcore``'s ``00`` and
    ``11`` sums, wrapped over the whole plane).  Products stay int8 and
    only the sums widen."""
    p = planes
    nn00 = (p["01"] + torch.roll(p["01"], 1, dims=1)
            + p["10"] + torch.roll(p["10"], 1, dims=0))
    bonds = _int_sum(p["00"] * nn00)
    del nn00
    nn11 = (p["10"] + torch.roll(p["10"], -1, dims=1)
            + p["01"] + torch.roll(p["01"], -1, dims=0))
    bonds = bonds + _int_sum(p["11"] * nn11)
    return _mean(-bonds, 4 * p["00"].numel())


def onsager_magnetization(temperature: float, j: float = 1.0) -> float:
    """Exact spontaneous magnetization (Onsager); 0 above T_c."""
    t = float(temperature)
    if t >= T_CRITICAL * j:
        return 0.0
    return (1.0 - math.sinh(2.0 * j / t) ** (-4.0)) ** 0.125


def _agm(a: float, b: float) -> float:
    """Arithmetic-geometric mean of two positive numbers."""
    while abs(a - b) > 1e-15 * a:
        a, b = (a + b) / 2.0, math.sqrt(a * b)
    return a


def onsager_energy(temperature: float, j: float = 1.0) -> float:
    """Exact energy per spin of the infinite lattice (Onsager):
    ``-J coth(2 beta J) [1 + (2/pi)(2 tanh^2(2 beta J) - 1) K(k)]`` with
    ``k = 2 sinh(2 beta J) / cosh^2(2 beta J)`` and the complete elliptic
    integral ``K(k) = pi / (2 AGM(1, sqrt(1 - k^2)))``; undefined at T_c
    itself, where k = 1."""
    b2 = 2.0 * j / float(temperature)
    k = 2.0 * math.sinh(b2) / math.cosh(b2) ** 2
    big_k = math.pi / (2.0 * _agm(1.0, math.sqrt(1.0 - k * k)))
    return -j / math.tanh(b2) * (
        1.0 + 2.0 / math.pi * (2.0 * math.tanh(b2) ** 2 - 1.0) * big_k)
