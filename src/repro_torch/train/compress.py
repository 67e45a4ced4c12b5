"""int8 error-feedback gradient compression for the data-parallel sum.

Counterpart of ``repro.train.compress``.  Each rank quantizes (grad +
error carry) to int8 with a per-tensor scale, the int8 payloads are
summed in int32 and the scales averaged, and each rank carries its
quantization residual to the next step (error feedback keeps SGD/Adam
convergence; ``tests/test_torch_compress.py`` checks it).

``quantize`` is JAX's bit for bit on the same f32 input: ``torch.round``
rounds half to even, as ``jnp.round`` does.  JAX's synchronizers run
inside ``shard_map`` and sum with ``psum``; here they are functions over
the per-rank gradient trees of a :class:`repro_torch.launch.mesh.Mesh`
(a list, one tree a shard in the mesh's row-major order) that compute
what that ``psum`` computes.
"""
from __future__ import annotations

from typing import Sequence

import numpy as np
import torch

from .optim import leaves, tree_map


def quantize(x):
    scale = torch.clamp(torch.max(torch.abs(x)), min=1e-30) / 127.0
    q = torch.clamp(torch.round(x / scale), -127, 127).to(torch.int8)
    return q, scale


def dequantize(q, scale):
    return q.to(torch.float32) * scale


def compress_leaf(g, err):
    """One leaf: returns (int8 payload, scale, new_error)."""
    x = g.to(torch.float32) + err
    q, scale = quantize(x)
    new_err = x - dequantize(q, scale)
    return q, scale, new_err


def init_error_state(grads):
    return tree_map(lambda g: torch.zeros(g.shape, dtype=torch.float32,
                                          device=g.device), grads)


def _groups(n: int, mesh, axis_names) -> list:
    """The ranks that one ``psum`` over ``axis_names`` joins: all ``n``
    without a mesh, else those that share every other axis's
    coordinate."""
    if mesh is None:
        return [list(range(n))]
    if n != mesh.size:
        raise ValueError(f"{n} gradient trees for a mesh of {mesh.size}")
    axes = [axis_names] if isinstance(axis_names, str) else list(axis_names)
    groups = {}
    for i in range(n):
        coords = np.unravel_index(i, mesh.shape)
        rest = tuple(int(c) for name, c in zip(mesh.axis_names, coords)
                     if name not in axes)
        groups.setdefault(rest, {})[mesh.axis_index(i, axes)] = i
    return [[g[k] for k in sorted(g)] for g in groups.values()]


def make_compressed_psum(axis_names, mesh=None):
    """All-reduce per-rank gradient trees in int8 with error feedback:
    ``fn(grads, err_state) -> (synced, new_err)``, each a list of trees,
    one a rank.  The ranks of one sum are those of ``axis_names`` on
    ``mesh`` (all of them without one).  Each leaf of each rank becomes
    ``sum_i q_i (int32) * (sum_i s_i / n) / n``, placed on the rank's
    device; each rank's new error is its own residual."""

    def sync(grads: Sequence, err_state: Sequence):
        n = len(grads)
        per_rank = [[compress_leaf(g, e) for g, e in
                     zip(leaves(grads[r]), leaves(err_state[r]))]
                    for r in range(n)]
        synced = [[None] * len(per_rank[0]) for _ in range(n)]
        for group in _groups(n, mesh, axis_names):
            home = per_rank[group[0]][0][0].device
            count = len(group)
            for j in range(len(per_rank[0])):
                tot = sum(per_rank[r][j][0].to(home, torch.int32)
                          for r in group)
                s = sum(per_rank[r][j][1].to(home) for r in group)
                value = tot.to(torch.float32) * (s / count) / count
                for r in group:
                    synced[r][j] = value.to(per_rank[r][j][0].device)
        out = [_rebuild(grads[r], synced[r]) for r in range(n)]
        new_err = [_rebuild(grads[r], [c[2] for c in per_rank[r]])
                   for r in range(n)]
        return out, new_err

    return sync


def _rebuild(tree, values):
    """``tree``'s structure holding ``values`` in its leaves' order."""
    it = iter(values)
    return tree_map(lambda _: next(it), tree)


def make_dp_compressed_sync(mesh, dp_axes):
    """The standalone synchronizer over ``mesh``'s ``dp_axes``:
    (per-rank grads, per-rank err) -> (mean grads, new err), each a list
    of trees, one a shard of ``mesh``."""
    return make_compressed_psum(dp_axes, mesh)
