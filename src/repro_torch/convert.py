"""Carry a run's state between the JAX package and this one.

The JAX engines' ``state_arrays()`` are dicts of numpy planes:
``black``/``white`` int8 for ``basic``, ``basic_philox`` and
``stencil_pallas``, ``black_words``/``white_words`` uint32 for the
multispin engines, ``black_bits``/``white_bits`` uint32 for the bitplane
engines; the whole int8 ``lattice`` for ``wolff``, and beside it the
int8 couplings ``j_up``/``j_left`` for ``spinglass``; the ``tensorcore``
engine's are four int8 planes ``plane_00`` ... ``plane_11``.  This
package holds the int8 planes as int8 tensors and the uint32 planes as
int32 tensors with the same bits (PyTorch has no uint32 arithmetic on
the CPU); the numpy side is always uint32, since the digest framing
writes the dtype.
An ensemble's arrays carry the batch axis first, ``(B, n, w)`` planes
under the same names, in both packages.
Together with the shared ``.npz`` layout (``spec_json``, ``step_count``,
``state_<name>``), a run saved by either package restores in the other.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.tensorcore import PLANE_KEYS

#: numpy dtype of the reference's planes -> the numpy view of the same
#: bits that converts to the torch dtype holding them
_HOLDER = {np.dtype(np.int8): np.int8, np.dtype(np.uint32): np.int32}


def state_from_reference(arrays, device, keys=("black", "white"),
                         dtype=np.int8, batched: bool = False):
    """Named 2-D numpy planes of ``dtype``, one a key (``batched``: an
    ensemble's 3-D ``(B, n, w)`` planes) -> a tuple of tensors of one
    shape on ``device`` (always copies: the planes are updated in place
    later, and must not alias the caller's arrays)."""
    dtype = np.dtype(dtype)
    ndim = 3 if batched else 2
    planes = []
    for key in keys:
        if key not in arrays:
            raise ValueError(f"state arrays lack {key!r}: {sorted(arrays)}")
        a = np.asarray(arrays[key])
        if a.dtype != dtype or a.ndim != ndim:
            raise ValueError(f"state plane {key!r} must be {ndim}-D {dtype}, "
                             f"got {a.dtype} {a.shape}")
        host = np.ascontiguousarray(a).view(_HOLDER[dtype])
        planes.append(torch.tensor(host, device=device))
    for key, p in zip(keys[1:], planes[1:]):
        if p.shape != planes[0].shape:
            raise ValueError(f"{keys[0]} {tuple(planes[0].shape)} and {key} "
                             f"{tuple(p.shape)} planes differ")
    return tuple(planes)


def state_to_reference(state, keys=("black", "white"), dtype=np.int8) -> dict:
    """Tensors, one a key -> host numpy copies of ``dtype`` under
    ``keys``, the JAX engine's ``state_arrays()`` layout (an ensemble's
    ``(B, n, w)`` planes as they are: the JAX ensemble's layout)."""
    return {k: p.detach().cpu().numpy().view(dtype).copy()
            for k, p in zip(keys, state)}


def planes_to_reference(planes: dict) -> dict:
    """The tensor-core engine's four planes -> host int8 numpy copies
    under ``plane_XX``, whatever the device dtype."""
    return {f"plane_{k}": planes[k].detach().to(torch.int8).cpu().numpy()
            for k in PLANE_KEYS}


def planes_from_reference(arrays, device, shape) -> dict:
    """``plane_XX`` arrays of ``shape`` -> four int8 tensors on
    ``device`` (copies: the planes are updated in place later)."""
    planes = {}
    for k in PLANE_KEYS:
        key = f"plane_{k}"
        if key not in arrays:
            raise ValueError(f"state arrays lack {key!r}: {sorted(arrays)}")
        a = np.asarray(arrays[key])
        if a.dtype != np.int8 or a.shape != tuple(shape):
            raise ValueError(f"state plane {key!r} must be int8 of shape "
                             f"{tuple(shape)}, got {a.dtype} {a.shape}")
        planes[k] = torch.tensor(np.ascontiguousarray(a), device=device)
    return planes
