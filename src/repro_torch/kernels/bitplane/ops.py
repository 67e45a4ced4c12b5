"""Sweeps of the per-half-sweep bitplane kernel (counterpart of
``repro.kernels.bitplane.ops``)."""
from __future__ import annotations

from repro_torch.core import multispin as ms
from repro_torch.core import rng

from .bitplane import bitplane_update


def run_sweeps_bitplane_kernel(black_words, white_words, inv_temp,
                               n_sweeps: int, *, seed: int = 0,
                               start_offset: int = 0):
    """``n_sweeps`` full sweeps, black then white, of all 32 replicas
    with :func:`bitplane_update` at Philox offsets ``half_sweep_offset(
    start_offset, i, colour)``; the thresholds are made once.  Updates
    the word planes in place and returns ``(black_words, white_words)``.

    The JAX wrapper's ``block_rows`` and ``interpret`` are TPU tiling and
    Pallas options: the card's kernel has no row blocks, and CPU planes
    take the plain version."""
    thresholds = ms.acceptance_thresholds(inv_temp)
    for i in range(n_sweeps):
        bitplane_update(black_words, white_words, thresholds, is_black=True,
                        seed=seed,
                        offset=rng.half_sweep_offset(start_offset, i, 0))
        bitplane_update(white_words, black_words, thresholds, is_black=False,
                        seed=seed,
                        offset=rng.half_sweep_offset(start_offset, i, 1))
    return black_words, white_words
