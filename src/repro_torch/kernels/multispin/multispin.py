"""``multispin_update``: one packed half-sweep, CUDA kernel and plain version.

Replaces the Pallas kernel ``src/repro/kernels/multispin/multispin.py``
(``multispin_update``), which stages row blocks i-1, i, i+1 of the word
planes into TPU VMEM.  On the card (``csrc/multispin.cu``) one thread
updates one target word of 8 spins: five op-word reads (up, down,
centre, and the neighbour word of the nibble funnel shift), three packed
adds, two Philox4x32-10 calls for the 8 draws and 8 compares with the
10 uint32 thresholds.  It is bound by the Philox arithmetic, not by its
12 bytes per word.  Each thread reads only its own target word, so the
kernel updates the target plane in place, and so does the wrapper on
every device.

Philox is keyed on both lanes of the 64-bit seed (``seed_keys``), as the
JAX package's oracle and its resident kernel are; its per-half-sweep
Pallas kernel keys on the seed's low 32 bits only, so the two agree for
seeds below 2^32.

Word planes and thresholds as in ``repro_torch.kernels._words``.
:func:`multispin_update_batched` runs an ensemble's ``(B, n, w)`` planes
in one launch of the kernel's member axis (``kernels._members``),
counted in ``multispin_update.launches``.
"""
from __future__ import annotations

import torch

from repro_torch.core import multispin as ms
from repro_torch.kernels import _build
from repro_torch.kernels._members import check_batch
from repro_torch.kernels._words import check_words, declare, launch_update
from repro_torch.kernels.errors import note_in_place


def multispin_update_plain(target, op_words, thresholds, *, is_black: bool,
                           seed: int, offset: int) -> torch.Tensor:
    """The plain PyTorch version: returns the updated target plane."""
    return ms.update_color_packed(target, op_words, thresholds, is_black,
                                  seed, offset)


def library():
    """The compiled ``csrc/multispin.cu`` with its C signatures declared."""
    return declare(_build.load("multispin"), "multispin")


def multispin_update(target, op_words, thresholds, *, is_black: bool,
                     seed: int, offset: int) -> torch.Tensor:
    """One packed colour half-sweep of ``target`` against ``op_words``,
    in place; ``seed`` a 64-bit int, ``offset`` the uint32 Philox offset
    of this half-sweep.  CPU planes take the plain version; CUDA planes
    launch the kernel.  Returns ``target``."""
    check_words(target, op_words)
    if target.device.type == "cpu":
        target.copy_(multispin_update_plain(
            target, op_words, thresholds, is_black=is_black, seed=seed,
            offset=offset))
        note_in_place()
        return target
    return launch_update(library(), "multispin", multispin_update, target,
                         op_words, [thresholds], is_black=is_black,
                         seeds=[seed], offset=offset)


def multispin_update_batched_plain(targets, ops, tables, *, is_black: bool,
                                   seeds, offset: int) -> torch.Tensor:
    """The plain batched version: the packed half-sweep of every member
    at once (its table and seed), which gives each member's
    :func:`multispin_update_plain`."""
    return ms.update_color_packed(targets, ops, torch.stack(list(tables)),
                                  is_black, [int(s) for s in seeds], offset)


def multispin_update_batched(targets, ops, tables, *, is_black: bool,
                             seeds, offset: int) -> torch.Tensor:
    """:func:`multispin_update` of B members at one offset, in place:
    ``(B, n, w)`` planes, a threshold table and a seed a member.  CPU
    planes take the plain batched version; CUDA planes launch the
    kernel's member axis."""
    check_batch((targets, ops), tables, seeds, check_words)
    if targets.device.type == "cpu":
        targets.copy_(multispin_update_batched_plain(
            targets, ops, tables, is_black=is_black, seeds=seeds,
            offset=offset))
        note_in_place()
        return targets
    return launch_update(library(), "multispin", multispin_update, targets,
                         ops, list(tables), is_black=is_black,
                         seeds=list(seeds), offset=offset)


#: kernel launches since the count was last set to 0 (a batched launch
#: counts once)
multispin_update.launches = 0
