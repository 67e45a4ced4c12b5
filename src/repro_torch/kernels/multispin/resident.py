"""``multispin_sweeps_resident``: k packed sweeps per launch, CUDA and plain.

Replaces the Pallas kernel ``src/repro/kernels/multispin/resident.py``
(``multispin_sweeps_resident``), which keeps both whole word planes in
TPU VMEM for ``n_sweeps`` sweeps.  On the card (``csrc/multispin.cu``,
the word loop it shares with the shard kernel) each block loads a tile
of both word planes plus a halo of at least 2k word rows and word
columns into shared memory, runs 2k half-sweeps on it and writes back
the tile.  The draws are keyed on the global word index, so the result
is bit for bit k applications of the half-sweep; the accept takes the
thresholds as the 16-entry ``key_table``.  It is bound by instruction
issue (the paired Philox and the accept), the halo's redundant words
included; the planner (``repro_torch.kernels.resident``) picks the tile
and k.

A run longer than the plan's k takes ceil(n_sweeps / k) launches, an
ensemble's (:func:`multispin_sweeps_resident_batched`) as many for all
its members.
"""
from __future__ import annotations

from repro_torch.core import multispin as ms
from repro_torch.kernels._members import check_batch, per_member
from repro_torch.kernels._words import (check_resident_args, check_words,
                                        launch_resident)

from .multispin import library


def multispin_sweeps_resident_plain(black, white, thresholds, *,
                                    n_sweeps: int, seed: int,
                                    start_offset: int):
    """The plain PyTorch version: ``n_sweeps`` applications of the
    packed half-sweep pair."""
    return ms.run_sweeps_packed(black, white, thresholds, n_sweeps, seed,
                                start_offset)


def multispin_sweeps_resident(black, white, thresholds, *, n_sweeps: int,
                              seed: int, start_offset: int, plan):
    """``n_sweeps`` full sweeps of the word planes ``(black, white)``
    from the cumulative Philox offset ``start_offset``; returns new planes
    and leaves the inputs as they were.  ``plan`` is the planner's
    ``ResidentPlan`` for this lattice.  CPU planes take the plain
    version; CUDA planes launch the kernel."""
    check_words(black, white)
    check_resident_args(black, n_sweeps, plan)
    if black.device.type == "cpu":
        return multispin_sweeps_resident_plain(
            black, white, thresholds, n_sweeps=n_sweeps, seed=seed,
            start_offset=start_offset)
    return launch_resident(library(), "multispin", multispin_sweeps_resident,
                           black, white, [thresholds], n_sweeps=n_sweeps,
                           seeds=[seed], start_offset=start_offset, plan=plan)


def multispin_sweeps_resident_batched_plain(black, white, tables, *,
                                            n_sweeps: int, seeds,
                                            start_offset: int):
    """The plain batched version: :func:`multispin_sweeps_resident_plain`
    of each member (its table and seed), stacked."""
    return per_member(multispin_sweeps_resident_plain, (black, white),
                      tables, seeds, n_sweeps=n_sweeps,
                      start_offset=start_offset)


def multispin_sweeps_resident_batched(black, white, tables, *,
                                      n_sweeps: int, seeds,
                                      start_offset: int, plan):
    """:func:`multispin_sweeps_resident` of B members from one offset:
    ``(B, n, w)`` planes, a threshold table and a seed a member, each
    block of sweeps one launch of the kernel's member axis (counted in
    ``multispin_sweeps_resident.launches``).  CPU planes take the plain
    batched version."""
    check_batch((black, white), tables, seeds, check_words)
    check_resident_args(black, n_sweeps, plan)
    if black.device.type == "cpu":
        return multispin_sweeps_resident_batched_plain(
            black, white, tables, n_sweeps=n_sweeps, seeds=seeds,
            start_offset=start_offset)
    return launch_resident(library(), "multispin", multispin_sweeps_resident,
                           black, white, list(tables), n_sweeps=n_sweeps,
                           seeds=list(seeds), start_offset=start_offset,
                           plan=plan)


#: kernel launches since the count was last set to 0 (a batched launch
#: counts once)
multispin_sweeps_resident.launches = 0
