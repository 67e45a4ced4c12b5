"""Sweeps of the fused tensor-core kernel (counterpart of
``repro.kernels.tensorcore.ops``)."""
from __future__ import annotations

from repro_torch.core import rng

from .tensorcore import DEFAULT_BLOCK, tensorcore_update


def run_sweeps_tensorcore(planes: dict, inv_temp, n_sweeps: int, *,
                          seed: int = 0, start_offset: int = 0,
                          block: int = DEFAULT_BLOCK) -> dict:
    """``n_sweeps`` full sweeps, black then white, at Philox offsets
    ``half_sweep_offset(start_offset, i, colour)``; updates ``planes`` in
    place and returns it."""
    for i in range(n_sweeps):
        for color_index, color in enumerate(("black", "white")):
            tensorcore_update(
                planes, color, inv_temp, seed=seed, block=block,
                offset=rng.half_sweep_offset(start_offset, i, color_index))
    return planes
