"""``bitplane_update``: one half-sweep of 32 replicas, CUDA and plain.

Replaces the Pallas kernel ``src/repro/kernels/bitplane/bitplane.py``
(``bitplane_update``), which stages row blocks i-1, i, i+1 into TPU VMEM.
On the card (``csrc/bitplane.cu``) one thread updates a group of 4
consecutive words of a row: one Philox4x32-10 call at counter
``(offset, 0, group, 0)`` gives the 4 sites' shared draws, each word
gets the carry-save neighbour count and the accept.  One thread per
site would compute every Philox call four times.  Each thread reads
only its own target words, so the kernel updates the target plane in
place, and so does the wrapper on every device.

Word planes and thresholds as in ``repro_torch.kernels._words``, the
planes' width a multiple of 4.  The accept is the kernel's
three-threshold one where the thresholds have a ferromagnet's layout
(``_words.accept_arg``), else its general 10-class one: each wrapper
counts every launch in ``launches`` and those of the general accept
also in ``general_launches``.  :func:`bitplane_update_batched` runs an
ensemble's ``(B, n, w)`` planes in one launch of the kernel's member
axis (``kernels._members``), with the three-threshold accept only where
every member's table takes it.
"""
from __future__ import annotations

import torch

from repro_torch.core import bitplane as bp
from repro_torch.kernels import _build
from repro_torch.kernels._members import check_batch, per_member
from repro_torch.kernels._words import check_words, declare, launch_update
from repro_torch.kernels.errors import note_in_place


def bitplane_update_plain(target, op_words, thresholds, *, is_black: bool,
                          seed: int, offset: int) -> torch.Tensor:
    """The plain PyTorch version: returns the updated target plane."""
    return bp.update_color_bitplane(target, op_words, thresholds, is_black,
                                    seed, offset)


def check_bit_planes(*planes: torch.Tensor) -> None:
    """:func:`check_words`, plus a width of whole 4-site groups and
    16-byte aligned rows (the kernel moves a group as one vector)."""
    check_words(*planes, align=16)
    if planes[0].shape[1] % 4:
        raise ValueError(f"bitplane planes need a multiple-of-4 width, got "
                         f"{tuple(planes[0].shape)}")


def library():
    """The compiled ``csrc/bitplane.cu`` with its C signatures declared."""
    return declare(_build.load("bitplane"), "bitplane")


def bitplane_update(target, op_words, thresholds, *, is_black: bool,
                    seed: int, offset: int) -> torch.Tensor:
    """One colour half-sweep of all 32 replicas of ``target`` against
    ``op_words``, in place.  CPU planes take the plain version; CUDA
    planes launch the kernel.  Returns ``target``."""
    check_bit_planes(target, op_words)
    if target.device.type == "cpu":
        target.copy_(bitplane_update_plain(
            target, op_words, thresholds, is_black=is_black, seed=seed,
            offset=offset))
        note_in_place()
        return target
    return launch_update(library(), "bitplane", bitplane_update, target,
                         op_words, [thresholds], is_black=is_black,
                         seeds=[seed], offset=offset)


def bitplane_update_batched_plain(targets, ops, tables, *, is_black: bool,
                                  seeds, offset: int) -> torch.Tensor:
    """The plain batched version: :func:`bitplane_update_plain` of each
    member (its table and seed), stacked."""
    return per_member(bitplane_update_plain, (targets, ops), tables, seeds,
                      is_black=is_black, offset=offset)


def bitplane_update_batched(targets, ops, tables, *, is_black: bool, seeds,
                            offset: int) -> torch.Tensor:
    """:func:`bitplane_update` of B members at one offset, in place:
    ``(B, n, w)`` planes, a threshold table and a seed a member.  CPU
    planes take the plain batched version; CUDA planes launch the
    kernel's member axis, with the three-threshold accept where every
    member's table has a ferromagnet's layout."""
    check_batch((targets, ops), tables, seeds, check_bit_planes)
    if targets.device.type == "cpu":
        targets.copy_(bitplane_update_batched_plain(
            targets, ops, tables, is_black=is_black, seeds=seeds,
            offset=offset))
        note_in_place()
        return targets
    return launch_update(library(), "bitplane", bitplane_update, targets,
                         ops, list(tables), is_black=is_black,
                         seeds=list(seeds), offset=offset)


#: kernel launches since the count was last set to 0 (a batched launch
#: counts once), and of them those of the general accept
bitplane_update.launches = 0
bitplane_update.general_launches = 0
