"""Wolff cluster updates (paper S2): the critical-slowing-down fix.

Counterpart of ``repro.core.wolff``.  A cluster grows from a seed site
as a breadth-first search over boolean masks: at every depth, each
neighbour of the frontier that carries the seed's spin and is not yet
in the cluster joins with probability ``p_add = 1 - exp(-2/T)``, tested
with its own uniform (bonds are tested again from every new frontier
site, as the algorithm asks); the cluster then flips.

Draws (``rng``'s table of lanes, c1 = 2): cluster ``c`` takes its seed
site from lane 0 of Philox at ``(c, 2, 0, 0)`` and its bond tests at
depth d from the ``(n, m)`` plane at ``(c, 2, i*m + j, d + 1)``, through
``repro_torch.kernels.draws.philox_fill`` on the card.  The JAX package
draws both from ``jax.random``; :func:`grow_cluster` takes the seed site
and the draws as arguments, so a test can feed it the JAX package's.

An empty frontier stays empty, so the search may run past its end
without changing the cluster: on the card it asks whether the frontier
is empty once every :data:`CHECK_EVERY` depths, since each question
waits for the device.
"""
from __future__ import annotations

import numpy as np
import torch

from . import rng

#: BFS depths between two tests of the frontier on the card (each test
#: a host sync); on the CPU every depth is tested
CHECK_EVERY = 16


def p_add(temperature: float) -> float:
    """``1 - exp(-2/T)`` in float32, the bond probability of a cluster:
    the float32 of ``-2/T``, its ``exp`` in float64 rounded once, and the
    float32 difference.  The JAX package takes ``jnp.exp`` in float32,
    not correctly rounded on the CPU (ROADMAP Queue 3)."""
    arg = np.float32(-2.0) / np.float32(temperature)
    return float(np.float32(1.0) - np.float32(np.exp(np.float64(arg))))


def _neighbor_or(mask):
    """Union of the four-neighbourhood of a boolean mask (periodic)."""
    return (torch.roll(mask, 1, 0) | torch.roll(mask, -1, 0)
            | torch.roll(mask, 1, 1) | torch.roll(mask, -1, 1))


def grow_cluster(lattice, site, p_add_f32: float, draw, check_every=None):
    """The cluster of the seed ``site`` (a flat index ``i*m + j``) on the
    ``(n, m)`` +-1 ``lattice``: a bool ``(n, m)`` mask.  ``draw(depth)``
    returns the ``(n, m)`` float32 uniforms of BFS step ``depth`` (0,
    1, ...); a neighbour joins where its uniform is below the float32
    ``p_add_f32``.  The frontier is tested for emptiness every
    ``check_every`` depths (default: :data:`CHECK_EVERY` on the card, 1
    on the CPU), which changes no result."""
    n, m = lattice.shape
    i, j = divmod(int(site), m)
    same = lattice == lattice[i, j]
    cluster = torch.zeros((n, m), dtype=torch.bool, device=lattice.device)
    cluster[i, j] = True
    frontier = cluster.clone()
    p = torch.tensor(p_add_f32, dtype=torch.float32, device=lattice.device)
    check = check_every or (CHECK_EVERY if lattice.device.type == "cuda"
                            else 1)
    depth = 0
    while True:
        for _ in range(check):
            candidates = _neighbor_or(frontier) & same & ~cluster
            frontier = candidates & (draw(depth) < p)
            cluster |= frontier
            depth += 1
        if not bool(frontier.any()):
            return cluster


def flip_cluster(lattice, cluster):
    """``(flipped lattice, cluster size)``, the size a 0-d int64 tensor."""
    return torch.where(cluster, -lattice, lattice), cluster.sum()


def seed_site(n: int, m: int, seed: int, cluster: int) -> int:
    """Cluster ``cluster``'s seed site: lane 0 of Philox at ``(cluster, 2,
    0, 0)`` scaled to ``[0, n*m)`` as ``(draw * n * m) >> 32``."""
    k0, k1 = rng.seed_keys(seed)
    bits = rng.philox4x32(int(cluster) & rng.MASK32, rng.WOLFF_LANE, 0, 0,
                          k0, k1)[0]
    return (int(bits) * n * m) >> 32


def bond_draws(n: int, m: int, seed: int, cluster: int, device):
    """``draw(depth)`` of cluster ``cluster``: the ``(n, m)`` uniforms at
    ``(cluster, 2, i*m + j, depth + 1)``."""
    from repro_torch.kernels.draws import uniforms

    def draw(depth):
        return uniforms((n, m), seed, int(cluster) & rng.MASK32, device,
                        c1=rng.WOLFF_LANE, c3=depth + 1)
    return draw


def wolff_step(lattice, temperature: float, seed: int, cluster: int):
    """One cluster flip, cluster number ``cluster`` of the stream of
    ``seed``: ``(lattice, size)``."""
    n, m = lattice.shape
    mask = grow_cluster(lattice, seed_site(n, m, seed, cluster),
                        p_add(temperature),
                        bond_draws(n, m, seed, cluster, lattice.device))
    return flip_cluster(lattice, mask)


def run_wolff(lattice, temperature: float, n_steps: int, seed: int,
              step_count: int = 0):
    """``n_steps`` cluster flips, clusters ``step_count`` to ``step_count
    + n_steps - 1``: ``(lattice, mean cluster size)``, the mean a 0-d
    float32 tensor (0 for no step)."""
    total = torch.zeros((), dtype=torch.int64, device=lattice.device)
    for i in range(n_steps):
        lattice, size = wolff_step(lattice, temperature, seed,
                                   step_count + i)
        total += size
    return lattice, (total.to(torch.float64)
                     / max(n_steps, 1)).to(torch.float32)
