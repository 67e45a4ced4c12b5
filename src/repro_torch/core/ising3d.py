"""3D Ising model on the cubic lattice (paper S2: no exact solution; the
critical temperature is known numerically, T_c ~= 4.5115 J).

Counterpart of ``repro.core.ising3d``: the checkerboard idea with one
more axis (colour ``(i + j + k) % 2``, six neighbours), on the whole
``(n0, n1, n2)`` int8 lattice, and its slab decomposition over a mesh
(:func:`make_ising3d_step`: slabs along axis 0, ring halos through
``distributed.ring_shift``).

The accept is a lookup in a 7-entry float32 table
(:func:`acceptance_table_3d`) indexed by ``nn * s`` in {-6, -4, ..., 6}:
the JAX package's argument ``-2 beta nn s`` is ``s`` times the float32
``(-2 beta) nn``, so the table holds every value it takes.  The JAX
package calls ``jnp.exp`` per site, not correctly rounded on the CPU, so
its flips are the port's where the two 7-entry tables decide them alike
(ROADMAP Queue 3).

Draws: the half-sweep of colour c at Philox counter ``(offset, 0, gi,
0)``, ``gi = (i * n1 + j) * n2 + k`` the site's flat global index and
``offset = half_sweep_offset(start, sweep, c)``, on the card through
``repro_torch.kernels.draws.philox_fill``.  This is the JAX mesh step's
layout, so the port's single-device run and its slab runs on any mesh
are one trajectory, and the mesh step is the JAX package's bit for bit.
The JAX package's single-device ``run_sweeps_3d`` draws from
``jax.random`` instead.
"""
from __future__ import annotations

import numpy as np
import torch

from . import distributed as dist
from . import rng

T_CRITICAL_3D = 4.5115  # numerically known, J = 1


def acceptance_arguments_3d(inv_temp) -> np.ndarray:
    """The 7 float32 arguments ``(-2 beta) * k`` for ``k = nn * s`` in
    {-6, ..., 6}, in float32 as the JAX package computes them."""
    a = np.float32(-2.0) * np.float32(inv_temp)
    return np.array([a * np.float32(k) for k in range(-6, 7, 2)],
                    dtype=np.float32)


def acceptance_table_3d(inv_temp) -> torch.Tensor:
    """``exp`` of :func:`acceptance_arguments_3d` in float64, rounded once
    to float32, on the host."""
    args = acceptance_arguments_3d(inv_temp).astype(np.float64)
    return torch.exp(torch.from_numpy(args)).to(torch.float32)


def neighbor_sums_3d(s: torch.Tensor) -> torch.Tensor:
    """Six-neighbour sums with periodic wrap, in int8 (|sum| <= 6)."""
    x = s.to(torch.int8)
    out = torch.zeros_like(x)
    for axis in range(3):
        out += torch.roll(x, 1, axis) + torch.roll(x, -1, axis)
    return out


def color_mask_3d(shape, color: int, device, row0: int = 0):
    """The sites of ``color``, ``(i + j + k) % 2 == color``, of a block
    whose first row is global row ``row0``."""
    ii = torch.arange(row0, row0 + shape[0], device=device)[:, None, None]
    jj = torch.arange(shape[1], device=device)[None, :, None]
    kk = torch.arange(shape[2], device=device)[None, None, :]
    return (ii + jj + kk) % 2 == color


def _accept(x, nn, uniforms, table, mask):
    """Flip the sites of ``mask`` whose uniform is below ``table[nn*s]``
    (entry ``(nn * s + 6) / 2``)."""
    k = nn.to(torch.int64) * x.to(torch.int64)
    accept = table.to(uniforms.device)[(k + 6) // 2]
    return torch.where(mask & (uniforms < accept), -x, x).to(x.dtype)


def update_color_3d(full, uniforms, table, color: int, mask=None):
    """A half-sweep of the sites of ``color`` with the given float32
    uniforms (the lattice's shape): flip iff ``u < table[nn * s]``."""
    if mask is None:
        mask = color_mask_3d(full.shape, color, full.device)
    return _accept(full, neighbor_sums_3d(full), uniforms, table, mask)


def magnetization_3d(full) -> torch.Tensor:
    """Mean spin: an exact int64 sum divided once, a 0-d float32."""
    total = full.sum(dtype=torch.int64)
    return (total.to(torch.float64) / full.numel()).to(torch.float32)


def run_sweeps_3d(full, table, n_sweeps: int, seed: int,
                  start_offset: int = 0):
    """``n_sweeps`` sweeps (colour 0, then 1) drawing at ``(offset, 0,
    gi, 0)``, offsets ``half_sweep_offset(start_offset, i, colour)``;
    ``table`` is :func:`acceptance_table_3d`."""
    from repro_torch.kernels.draws import uniforms
    masks = [color_mask_3d(full.shape, c, full.device) for c in (0, 1)]
    for i in range(n_sweeps):
        for c in (0, 1):
            u = uniforms(full.shape, seed,
                         rng.half_sweep_offset(start_offset, i, c),
                         full.device)
            full = update_color_3d(full, u, table, c, masks[c])
    return full


# -- distributed: slabs along axis 0, ring halos (paper S4 in 3D) ----------

def make_ising3d_step(mesh, *, n: int, seed: int = 0, n_sweeps: int = 1,
                      slab_axes=None):
    """The slab-decomposed 3D sweep over ``slab_axes`` (default: every
    mesh axis, flattened into the ring along the leading lattice axis)
    of the ``(n, n, n)`` lattice: returns ``(step, split, gather)``.

    The state is a list of shards, shard ``i`` (row-major over the mesh,
    on ``mesh.device_of(i)``) holding slab ``r``, its position on the
    ring of ``slab_axes`` (shards that differ only along other axes hold
    copies of one slab, as under the JAX package's sharding).
    ``step(shards, inv_temp, sweep0)`` advances them by ``n_sweeps``
    sweeps at offsets ``half_sweep_offset(sweep0, i, colour)`` --
    ``sweep0`` in half-sweep units, as the JAX package's argument of
    that name -- and returns new shards; ``split(full)`` cuts a whole
    lattice into shards, ``gather(shards)`` joins them on shard 0's
    device.  Each half-sweep exchanges the slabs' edge rows through
    ``distributed.ring_shift`` and updates every shard with the plain
    PyTorch operations, its draws keyed on global positions
    (``philox_fill`` of an index plane on the card)."""
    names = list(mesh.axis_names)
    slab_axes = tuple(slab_axes if slab_axes is not None else names)
    ring = mesh.axis_size(slab_axes)
    if n % ring:
        raise ValueError(f"{n} rows do not split into {ring} slabs")
    nl = n // ring
    shape = (nl, n, n)
    slab = [mesh.axis_index(i, slab_axes) for i in range(mesh.size)]
    index, masks = [], []
    for i, r in enumerate(slab):
        device = mesh.device_of(i)
        flat = torch.arange(nl * n * n, dtype=torch.int64, device=device)
        index.append((flat + r * nl * n * n).to(torch.int32).reshape(shape))
        masks.append([color_mask_3d(shape, c, device, row0=r * nl)
                      for c in (0, 1)])

    def split(full):
        return [full[r * nl:(r + 1) * nl].to(mesh.device_of(i)).contiguous()
                for i, r in enumerate(slab)]

    def gather(shards):
        first = {}
        for i, r in enumerate(slab):
            first.setdefault(r, i)
        device = shards[0].device
        return torch.cat([shards[first[r]].to(device) for r in range(ring)])

    def half(shards, table, color, offset):
        from repro_torch.kernels.draws import index_uniforms
        top = dist.ring_shift([x[-1:] for x in shards], mesh, slab_axes, +1)
        bottom = dist.ring_shift([x[:1] for x in shards], mesh, slab_axes,
                                 -1)
        out = []
        for i, x in enumerate(shards):
            nn = torch.cat([top[i], x[:-1]]) + torch.cat([x[1:], bottom[i]])
            for axis in (1, 2):
                nn += torch.roll(x, 1, axis) + torch.roll(x, -1, axis)
            u = index_uniforms(index[i], seed, offset)
            out.append(_accept(x, nn, u, table, masks[i][color]))
        return out

    def step(shards, inv_temp, sweep0: int):
        table = acceptance_table_3d(inv_temp)
        for i in range(n_sweeps):
            for c in (0, 1):
                shards = half(shards, table, c,
                              rng.half_sweep_offset(sweep0, i, c))
        return shards

    return step, split, gather
