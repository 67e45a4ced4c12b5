"""Sweeps of the per-half-sweep stencil kernel (counterpart of
``repro.kernels.stencil.ops``)."""
from __future__ import annotations

from repro_torch.core import metropolis, rng

from .stencil import stencil_update


def run_sweeps_stencil(black, white, inv_temp, n_sweeps: int, *,
                       seed: int = 0, start_offset: int = 0):
    """``n_sweeps`` full sweeps, black then white, of
    :func:`stencil_update` at Philox offsets ``half_sweep_offset(
    start_offset, i, colour)``; the acceptance table is made once.
    Updates the int8 planes in place and returns ``(black, white)``.

    The JAX wrapper's ``block_rows`` and ``interpret`` are TPU tiling and
    Pallas options: the card's kernel has no row blocks, and CPU planes
    take the plain version."""
    table = metropolis.acceptance_table(inv_temp)
    for i in range(n_sweeps):
        stencil_update(black, white, table, is_black=True, seed=seed,
                       offset=rng.half_sweep_offset(start_offset, i, 0))
        stencil_update(white, black, table, is_black=False, seed=seed,
                       offset=rng.half_sweep_offset(start_offset, i, 1))
    return black, white
