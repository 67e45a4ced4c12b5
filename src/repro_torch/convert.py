"""Carry a run's state between the JAX package and this one.

The JAX ``stencil_pallas`` engine's ``state_arrays()`` is a dict of two
numpy int8 planes, ``black`` and ``white``, each ``(n, m/2)``; this
package holds the same planes as int8 tensors on a device.  Together
with the shared ``.npz`` layout (``spec_json``, ``step_count``,
``state_black``, ``state_white``), a run saved by either package
restores in the other.
"""
from __future__ import annotations

import numpy as np
import torch


def state_from_reference(arrays, device):
    """``{"black", "white"}`` numpy int8 planes -> ``(black, white)``
    int8 tensors on ``device`` (always copies: the planes are updated in
    place later, and must not alias the caller's arrays)."""
    planes = []
    for key in ("black", "white"):
        if key not in arrays:
            raise ValueError(f"state arrays lack {key!r}: {sorted(arrays)}")
        a = np.asarray(arrays[key])
        if a.dtype != np.int8 or a.ndim != 2:
            raise ValueError(f"state plane {key!r} must be 2-D int8, got "
                             f"{a.dtype} {a.shape}")
        planes.append(torch.tensor(a, dtype=torch.int8, device=device))
    if planes[0].shape != planes[1].shape:
        raise ValueError(f"black {tuple(planes[0].shape)} and white "
                         f"{tuple(planes[1].shape)} planes differ")
    return planes[0], planes[1]


def state_to_reference(state) -> dict:
    """``(black, white)`` tensors -> ``{"black", "white"}`` host numpy
    int8 copies, the JAX engine's ``state_arrays()`` layout."""
    black, white = state
    return {"black": black.detach().cpu().numpy().copy(),
            "white": white.detach().cpu().numpy().copy()}
