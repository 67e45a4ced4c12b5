"""The device mesh of a sharded run (counterpart of ``repro.launch.mesh``).

A :class:`Mesh` names its axes and holds the devices its shards live
on.  Shard ``i`` is the ``i``-th position of the mesh in row-major order
and lives on ``devices[i % len(devices)]``: a mesh larger than the
machine puts several shards on one device, where the JAX package would
refuse it.  That changes no result, since the draws are keyed on global
lattice positions; it lets a sharded run be tested on one card, as the
JAX package's tests force several host devices.

:func:`make_production_mesh` and :func:`make_debug_mesh` are the JAX
package's factories, functions and not module constants: importing
this module builds no mesh.  The dry-run puts the production mesh's
512 shards on the meta device.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Sequence, Tuple

import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class Mesh:
    """Mesh ``shape`` with one name per axis, over ``devices``."""

    shape: Tuple[int, ...]
    axis_names: Tuple[str, ...]
    devices: Tuple[torch.device, ...]

    @property
    def size(self) -> int:
        return math.prod(self.shape)

    def device_of(self, i: int) -> torch.device:
        return self.devices[i % len(self.devices)]

    def axis_size(self, axes: Sequence[str]) -> int:
        """Positions of the ring formed by the product of ``axes``."""
        return math.prod(self.shape[self.axis_names.index(a)] for a in axes)

    def axis_index(self, i: int, axes: Sequence[str]) -> int:
        """Shard ``i``'s position on the ring of ``axes`` (most
        significant first)."""
        coords = np.unravel_index(i, self.shape)
        idx = 0
        for a in axes:
            d = self.axis_names.index(a)
            idx = idx * self.shape[d] + int(coords[d])
        return idx

    def neighbor(self, i: int, axes: Sequence[str], shift: int) -> int:
        """The shard that shard ``i`` receives from when the ring of
        ``axes`` shifts by ``shift``: +1 the previous position, -1 the
        next, the other axes' coordinates kept."""
        coords = list(np.unravel_index(i, self.shape))
        idx = (self.axis_index(i, axes) - shift) % self.axis_size(axes)
        for a in reversed(axes):
            d = self.axis_names.index(a)
            idx, coords[d] = divmod(idx, self.shape[d])
        return int(np.ravel_multi_index(coords, self.shape))


def make_mesh(shape, axis_names, device=None) -> Mesh:
    """A mesh over the CUDA cards (``device=None``; raises where there
    is none) or with every shard on ``device``."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; pass device='cpu' to run "
                "the plain PyTorch versions of the kernels")
        devices = tuple(torch.device("cuda", i)
                        for i in range(torch.cuda.device_count()))
    else:
        devices = (torch.device(device),)
    return Mesh(tuple(int(d) for d in shape), tuple(axis_names), devices)


def make_production_mesh(*, multi_pod: bool = False, device=None) -> Mesh:
    """The JAX package's production mesh: one pod (16, 16) with axes
    ``("data", "model")``, or two, (2, 16, 16) with ``("pod", "data",
    "model")``, where ``pod`` is an outer data-parallel ring.  Every
    shard sits on ``device`` (``"meta"`` for the dry-run, which counts
    a step's work without memory); ``device=None`` spreads the shards
    over the CUDA cards, as :func:`make_mesh`."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return make_mesh(shape, axes, device)


def make_debug_mesh(n_devices: int = 0, model: int = 2,
                    device=None) -> Mesh:
    """A small ``("data", "model")`` mesh of ``n_devices`` shards (0:
    one a CUDA card, or one on ``device``), ``model`` of them (at most
    ``n_devices``) on the model axis."""
    if not n_devices:
        n_devices = (torch.cuda.device_count() if device is None
                     and torch.cuda.is_available() else 1)
    model = min(model, n_devices)
    return make_mesh((n_devices // model, model), ("data", "model"),
                     device)
