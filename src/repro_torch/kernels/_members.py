"""The member axis of the kernels' ensemble launches.

An ensemble (``api.session._EnsembleRunner``) holds the planes of its B
members stacked as ``(B, n, w)`` tensors, member i following the
trajectory of the single-mode run of its own (temperature, seed).  Where
the JAX package ``vmap``s each Pallas kernel over (state, inverse
temperature, seed) -- one launch whose grid has a member axis -- the
CUDA kernels take the member as ``blockIdx.z`` (``csrc/common.cuh``):
one launch updates every member's planes, each member's thresholds and
Philox keys one record of the launch's parameters.  The parameter space
(32764 bytes from CUDA 12.1 on, less 512 for the other arguments) over
the family's largest record bounds the members of one launch
(``<family>_max_members``); a larger ensemble takes ceil(B / limit)
launches a block of sweeps.  A single-mode launch is the same C call
with one member.

Here: the checks of batched planes, the members' key pairs, the split
into launches, and the plain batched versions, which apply a family's
single-member plain version to each member.
"""
from __future__ import annotations

import ctypes
from typing import Callable, Sequence

import torch

from repro_torch.core import rng


def check_batch(planes: Sequence[torch.Tensor], tables: Sequence,
                seeds: Sequence[int], check_member: Callable) -> int:
    """Raise unless ``planes`` are contiguous ``(B, n, w)`` tensors of one
    shape with one table and one seed a member, each member's planes
    what ``check_member`` takes; returns B."""
    first = planes[0]
    for p in planes:
        if p.dim() != 3 or not p.is_contiguous() or p.shape != first.shape:
            raise ValueError(f"batched planes must be contiguous (B, n, w) "
                             f"tensors of one shape, got {tuple(p.shape)} "
                             f"and {tuple(first.shape)}")
    members = first.shape[0]
    if members < 1 or len(tables) != members or len(seeds) != members:
        raise ValueError(f"{members} members need as many tables and seeds, "
                         f"got {len(tables)} and {len(seeds)}")
    check_member(*(p[0] for p in planes))
    return members


def keys_arg(seeds: Sequence[int]):
    """The members' Philox key pairs ``(k0, k1)`` (``rng.seed_keys``) as
    one ctypes array of 2 B uint32 values."""
    keys = [k for seed in seeds for k in rng.seed_keys(int(seed))]
    return (ctypes.c_uint32 * len(keys))(*keys)


def member_chunks(lib, family: str, members: int):
    """``(first, stop)`` member ranges of the launches that take
    ``members`` members: at most the library's
    ``<family>_max_members()`` each."""
    limit = getattr(lib, f"{family}_max_members")()
    if limit < 1:
        raise RuntimeError(f"{family}: the kernels take no member")
    return [(lo, min(members, lo + limit))
            for lo in range(0, members, limit)]


def as_batch(plane: torch.Tensor) -> torch.Tensor:
    """A ``(n, w)`` plane as a batch of one member (a view), a batch as
    it is."""
    return plane if plane.dim() == 3 else plane[None]


def per_member(fn: Callable, planes: Sequence[torch.Tensor], tables,
               seeds, **kwargs):
    """The plain batched version: ``fn(*member planes, table, seed=,
    **kwargs)`` of each member, stacked on a leading member axis (a
    tensor, or a pair of them where ``fn`` returns a pair)."""
    outs = [fn(*(p[i] for p in planes), tables[i], seed=int(seeds[i]),
               **kwargs) for i in range(planes[0].shape[0])]
    if isinstance(outs[0], torch.Tensor):
        return torch.stack(outs)
    return tuple(torch.stack(parts) for parts in zip(*outs))
