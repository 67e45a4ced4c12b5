#!/usr/bin/env python3
"""Smoke run of the PyTorch port (``src/repro_torch``) on one CUDA card.

    python3 chip_smoke.py

Three kernel families, each a per-half-sweep kernel, a k-sweep kernel
and a shard kernel of the sharded resident tier (k sweeps of one
halo-extended shard, keyed on index planes): stencil (int8 planes),
multispin (8 nibble spins per uint32 word) and bitplane (32 replicas per
uint32 word); and the fused tensor-core kernel ``tensorcore_update``
(four int8 sublattice planes, banded products on the tensor cores).
The six single-device kernels of the three families also take an
ensemble's members as a grid axis (``BatchSpec``: B members' stacked
planes in one launch).  The eleventh kernel, ``philox_fill``, replaces no
TPU kernel: it draws the uniforms of the engines whose update is plain
PyTorch (``basic_philox``, ``basic``, ``spinglass``, ``wolff`` and the 3D
model).  Phases, each of which raises (and so exits non-zero) when it
fails:

1. the card's name and power limit, torch and CUDA versions;
2. build every CUDA source of ``src/repro_torch/csrc`` with nvcc (one
   nvcc per source, started together), read each kernel's SASS
   instruction mix with cuobjdump (the tensor-core kernel must hold
   ``HMMA``), the stencil k-sweep and shard kernels' site loops per
   site update (``repro_torch.analysis.sass``: no float accept in
   them), ``tensorcore_update``'s loop per plane position at the main
   path's tile, the bitplane k-sweep and shard kernels' group loop in
   every instance (both accepts) and the multispin ones' word loop per
   word, and ``stencil_update``'s row loop on device memory per site
   (no integer division in these), by pipe, and check each family's
   planner shared memory against its library's own query;
3. each kernel against its plain PyTorch version on the card, 0
   mismatches required, at small shapes, ragged tiles, a halo wider than
   the plane, seeds of at least 2^32, offsets near 2^31 and 2^32, and
   the main path's full plane; for the stencil k-sweep and shard
   kernels also plane widths 3, 5, 127, 129 and 130, tiles whose width
   is not a multiple of their 4-cell words, ``n_sweeps`` 1 to 3, and
   T = 0.05 from all-up planes, where no spin may flip; for
   ``stencil_update`` widths 3, 5, 127, 129, 130 and 256 at odd row
   counts and the cold check; for the multispin k-sweep and shard
   kernels word widths 1, 3, 5, 31, 33 and 129, tiles whose width is
   not a multiple of 4 or of a warp, ``n_sweeps`` 1 to 3 and the same
   cold check; for the three bitplane kernels both accepts (the
   three-threshold one at T = 3.0 and at T = 0.05, where t4 = t8 = 0,
   and the general one for a shuffled table, each launch counted as
   its accept's), ``n_sweeps`` 1 to 3, tiles that do not divide the
   plane, halos wider than the plane, and the cold check; each kernel's
   time and its plain version's at the full plane, and both sweep
   tiers' times;
   ``tensorcore_update`` at every block it takes on small ragged planes
   (also at T = 0.05 from all-up planes, where no spin may flip), at
   planes of 512^2 with blocks 16 and 64 (int8 and bf16) and at the main
   path's 16384^2 planes with block 128, both colours; on planes of one
   tile more than a multiple of its persistent grid; at block 128 on a
   512^2 lattice, both colours and types, with a hot table (every entry
   1) and the cold one from all-up planes; at every tile it takes; a
   block of 8 must raise; each shard kernel on whole extended planes,
   with random planes and random index planes and with the driver's own
   wrapped index planes (at 512^2 and at the main path's shard),
   ``n_sweeps`` 1, 2 and 3, and its time at the main path's shard; the
   bitplane one also at extended widths that are not whole groups and
   on planes of which some 4-word groups are one Philox group and some
   not; the six single-device kernels' member axis against their plain
   batched versions (each member's single-member plain version): B = 3
   members of distinct temperatures and seeds (2^31 + 11 and 2^32 - 1
   among them) at the small and ragged shapes, ``n_sweeps`` 1 to 3 and
   an odd tile grid, for bitplane also a batch of a shuffled table and
   ferromagnet tables (the general accept for the whole launch), then
   at the ensemble main path's shape, with each one's time there;
   ``philox_fill`` on row-major planes and index planes (random int32,
   and a 3D slab's int64 global positions), 1 to 16 members of distinct
   seeds, lanes 1 and 2, offsets near 2^31 and 2^32, the streams' c1 =
   0, 2 and 3 with c3 > 0, and at the main path's (32768, 16384) plane,
   timed there beside its plain version and (a note: another function)
   ``torch.rand``;
4. the Session at 512^2 for each engine: the card's k-sweep tier, its
   per-half-sweep tier (``resident_budget_bytes=0``) and the CPU plain
   versions give one ``state_digest``, and restore-continue equals the
   uninterrupted run; the same for ``tensorcore`` (block 64, one tier);
   sharded sessions: each ``_pallas`` engine on meshes (1, 1), (2, 2),
   (4, 1) and (2, 1, 2) (the sharded resident tier), ``multispin`` and
   ``bitplane`` on (2, 2) (the per-half-sweep distributed tier, plain
   PyTorch, no kernel), ``stencil_pallas`` on (2, 2) with no shard plan
   (``resident_budget_bytes=0``: the "basic" distributed step, whose
   draws launch ``philox_fill`` once a shard a half-sweep): each the
   single-mode digest; saved on
   (2, 2) and restored on (4, 1) and in single mode, and a single-mode
   checkpoint restored on (2, 2): the same digest; ensembles of 3
   members of each of the five counter-based engines: every member's
   ``state_digest(member=i)`` the single-mode digest of its (T, seed) on
   the k-sweep tier, the per-half-sweep tier and the CPU, one launch a
   block of sweeps for all members; restore-continue of an ensemble
   checkpoint; ``rebind`` to new members on the same engine and plan
   equal to a fresh session;
5. the main paths: ``stencil_pallas`` and ``multispin_pallas`` at
   32768^2 (2^30 spins) from an ordered start at T = 2.0, ``run(200)``
   and ``measure()``, |m| within 2e-3 of Onsager's value;
   ``bitplane_pallas`` at 16384^2 x 32 replicas (2^33 replica-spins)
   from a hot start at T = 3.0, ``run(200)`` and ``measure()``, each
   replica's energy within 2e-3 of Onsager's exact value, each |m| below
   0.01, no two replicas equal; flips/ns of each; then each spec on the
   per-half-sweep tier, whose planes must equal the k-sweep tier's after
   the same sweeps; ``tensorcore`` at 32768^2, block 128, from an ordered
   start at T = 2.0: ``run(200)`` and ``measure()``, |m| within 2e-3 of
   Onsager's value, exactly 600 launches of ``tensorcore_update``;
6. the main paths of the sharded tier, on a 2 x 2 mesh of shards on the
   one card: ``stencil_pallas`` and ``multispin_pallas`` at 32768^2
   (T = 2.0, ordered start) and ``bitplane_pallas`` at 16384^2 x 32
   (T = 3.0, hot start), ``run(200)`` then ``measure()``, the gates of
   phase 5; ``halo_exchanges`` = ceil(200 / k) and 4 ceil(200 / k)
   launches of the family's shard kernel in ``run(200)``;
7. the ensemble main paths at full width, a temperature scan as users
   run one: ``stencil_pallas`` and ``multispin_pallas`` with 16 members
   of 8192^2 (8 temperatures x 2 seeds, ordered start), ``bitplane_pallas``
   with 16 members of 4096^2 x 32 replicas (4 x 4, hot start):
   ``run(200)`` launches the k-sweep kernel ceil(200 / k) times for all
   members and no other kernel; the first and last members' planes
   equal their single-mode sessions'; after ``measure()`` the members
   at T <= 2.0 within 2e-3 of Onsager's |m|, at T = 2.5 |m| < 0.01
   (bitplane: every replica's energy within 2e-3 of its member's exact
   value, every |m| < 0.01, no two replicas of a member equal); 10
   sweeps on the per-half-sweep tier launch its kernel 20 times and give
   the k-sweep tier's planes; flips/ns beside single mode's; then 64
   members of 512^2 at T_c against 64 single-mode sessions one after
   another, timed in turn;
8. the analysis front door: the Fig. 5/6 scan at its default size
   (``python -m repro_torch.analysis.figures``: multispin, 13
   temperatures as one ensemble a size, sizes 32 and 64, 1500
   thermalizing sweeps, then 2000 samples 4 sweeps apart), the
   Binder-crossing T_c within 2 % of 2.269185, one graph replay a sample
   after the first;
   each size's ``measure()`` again through the graph and as the loop,
   both equal to the figure's samples; each counter-based engine on both
   tiers at 512^2, single mode and an ensemble of 3, graph against loop,
   ``basic_philox`` too on its one tier (its draws from ``philox_fill``);
   ``python -m repro_torch run spec.json --record`` on the card, the
   record validated by ``repro_torch.perf.schema``; ``--dry-run`` with no
   launch and no device memory, and in a process that sees no card;
9. the engines of plain updates, one session at a time, each path
   launching ``philox_fill`` and no other kernel (ms, flips/ns, peak
   device memory beside the card): ``basic_philox`` at 32768^2 (T = 2.0,
   ordered start, ``run(200)``: 400 launches), whose planes must be
   phase 5's ``stencil_pallas`` planes after its ``run(200)`` (held on the
   host and compared bit for bit: a CRC32C digest of 2^30 spins on the
   host takes about a minute), and ``basic`` of the same spec, whose
   planes must be ``basic_philox``'s; ``spinglass`` at 16384^2 (p_ferro
   0.5, inverse temperature 2, hot start, ``run(200)``: the energy must
   fall by more than 0.3 and |m| stay below 0.01) and at 8192^2 (p_ferro
   1, T = 2.0, ordered), whose lattice must be ``basic_philox``'s;
   ``wolff`` at 1024^2 (T = 1.8, ordered, 60 cluster flips: |m| > 0.80,
   the mean cluster size printed) and at 512^2 (T = 2.269, 100 flips);
   the 3D model at 512^3 (T = 3.5 from all up, 60 sweeps: |m| > 0.85;
   T = 8: |m| < 0.2), and on 4 slabs of a (4, 1) mesh on the one card,
   whose lattice must be the single device's; then at 512^2 each
   engine's card digest must be the CPU's, ``basic_philox`` as an
   ensemble of 3 (one launch a half-sweep for all members) and on a 2 x
   2 mesh (one launch a shard a half-sweep) single mode's, a checkpoint
   written by the JAX package (``tests/data/torch_port/``) must continue
   to the JAX digest, and the
   3D model at 32^3 the CPU's lattice, on one device and on slabs;
10. telemetry, resilience and the checkpointer (:func:`phase_10`): the
   supervised ``multispin_pallas`` 32768^2 run (T = 2.0, ordered, 200
   sweeps in chunks of 50, a checkpoint every 100) preempted at 150, its
   step 150 corrupted, resumed from step 100 under an injected transient
   fault and an injected demotion (one retry, one demotion, the rest on
   the per-half-sweep tier) to the digest of an uninterrupted
   ``run(200)``, each checkpoint's write and validation timed with the
   host CRC32C's share; ``python -m repro_torch.resilience.chaos`` at
   4096^2, an ensemble of 4 and a 2 x 2 mesh resumed on 1 x 2, exit 0;
   ``stencil_pallas`` 32768^2 ``run(20)`` under a ballast that leaves
   less free than the k-sweep tier's second copy of the planes: one
   demotion for ``OutOfMemoryError``, the undisturbed run's planes, no
   memory left over; a k-sweep tile over the card's opt-in shared memory
   demoting on its first launch, the digest unchanged; the traced CLI
   run (10 samples 10 apart at 32768^2): a valid trace whose counters
   are the plan's (1 dispatch, 100 sweeps, 100 x 2^30 flips and draws,
   9 graph replays, no recovery counter moved); ``run(200)`` untraced
   (no host synchronization under sync debug mode "error") and traced,
   its dispatch span at least its launches' CUDA-event time; the
   weakscale rows of (D, 1) meshes, D = 1, 2, 4, whose halo counters are
   their plans' exchanges and bytes.

Every counter-based ``measure()`` (phases 5, 7 and 8) launches its
sweeps from the host and replays one captured CUDA graph of a sample's
observables for every sample after the first
(``repro_torch.analysis.measure``): after it, the same plan from host
copies of the planes it started from runs as the loop of launches on
the card, driven as its own path, and its samples and final planes must
be the graph's; the line ``measure() graph against loop`` holds both
wall times, the graph's capture and instantiation seconds, its replays
and the device memory each took above the planes.

Every Session path is driven with all eleven kernels' launch counts set
to 0 just before it and read just after it: each path must launch the
kernel of its tier and no other (a per-half-sweep distributed path
none), and a bitplane path its kernel's three-threshold accept only.
The last lines are the ensemble rates, the graph against the loop, the
``kernels`` JSON
(``launches`` from the full-size path of the kernel's tier, for the
shard kernels its ``run(200)``, and every path's count; for the six
single-device kernels also ``batched``: the member axis at the ensemble
shape, its launches on the ensemble path), the peak device memory, the
``nvidia-smi`` line and the device JSON.  Without a CUDA device, or
without the package beside this script, it exits non-zero and prints no
result.
"""
from __future__ import annotations

import dataclasses
import json
import math
import os
import subprocess
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"

FULL_N = 32768
BITPLANE_N = 16384
SMALL_N = 512
TEMPERATURE = 2.0
BITPLANE_TEMPERATURE = 3.0
SEED = 2 ** 33 + 5          # both Philox key lanes non-zero
HALF_SWEEP_CHECK = 10       # sweeps of the full-size half-sweep-tier paths
TC_BLOCK = 128              # tensorcore main path's block (the default)
TC_SMALL_PLANE = 512        # plane side of the small tensorcore checks
TC_COLD_T = 0.05            # a temperature whose table holds exact zeros
#: tensorcore planes of 5 x 53 tiles of the kernel's 64 x 128: one more
#: than a grid of 2 x 132 blocks (or 132), so a block takes one tile more
TC_RAGGED = (320, 6784)
#: tensorcore planes whose largest dividing tile (64, 32, 16 rows; 128,
#: 64, 32, 16 columns) is each tile the kernel takes: (tile, planes)
TC_TILE_PLANES = tuple(((r, c), (h, w))
                       for r, h in ((64, 128), (32, 96), (16, 80))
                       for c, w in ((128, 256), (64, 192), (32, 160),
                                    (16, 144)))
HBM_BYTES_PER_S = 3.35e12   # H100 SXM data sheet
#: instructions per element update that no implementation of the
#: kernels' algorithm avoids, by the SM pipe that executes them (the
#: pipes run concurrently).  Integer multiplies run on the FMA pipe: a
#: wide multiply (both halves, IMAD.WIDE.U32, or the high half alone,
#: IMAD.HI) under "wide", at FMA_WIDE_SLOTS slots of the pipe, a low-half
#: multiply and a float add under "fma", one slot; logic, adds, shifts
#: and compares on the ALU pipe, conversions on the XU pipe.
#: * stencil, per site: lane 0 of Philox4x32-10 at counter
#:   (offset, 0, site, 0), key and offset the same for every site: 17
#:   products, 16 wide and one low half (round 8's product of lane z,
#:   whose high half only lanes 2 and 3 need), and 17 three-input XORs
#:   once the rounds' lanes that depend on the offset alone and the last
#:   rounds' unused lanes are taken out; 2 three-input adds
#:   (neighbour sum, table index), 1 compare, 1 select; 1 uint32 -> float
#:   conversion.
#: * multispin, per word of 8 spins: two full Philox4x32-10 calls at
#:   counters (2 off, 0, w, 0) and (2 off + 1, 0, w, 0), whose lanes x
#:   alone differ.  Round 0's product of w and round 1's product of its
#:   lane x (hi(M1 w) ^ k0, with that XOR) are the same for both calls;
#:   then each call takes 2 wide multiplies in each of rounds 2 to 9 and
#:   18 XORs (2 a round; round 0's offset product and round 1's third
#:   lane are the same for every word): 2 + 2 x 16 = 34 wide multiplies,
#:   1 + 2 x 18 = 37 XORs (an earlier count, 35 wide multiplies, shared
#:   round 0's product only); 1 funnel shift and 2 three-input
#:   adds for the neighbour sums; per nibble 1 index, 1 compare and 1
#:   merge into the flip word; 1 final XOR.
#: * bitplane, per word of 32 replicas: a quarter of one Philox call
#:   with the offset's work hoisted (HoistedPhilox::lanes: 18 wide
#:   multiplies, 19 XORs per 4-site group); 5 three-input logic
#:   operations of the carry-save count (sum and carry of up, down and
#:   centre, then the count's three bits with the side word); the
#:   three-threshold accept of a ferromagnet's table (three distinct
#:   thresholds: 0xFFFFFFFF, t4, t8): 4 three-input logic operations
#:   for the three class masks (m4 = n0 & ~(t ^ n1); m8 from t, n2 and
#:   n0 | n1 | n2, two; the rest ~(m4 | m8)), then per mask 1 compare of
#:   the draw with its threshold and 1 XOR of the mask into the word
#:   under that predicate: 10 (the general 10-class accept, which a
#:   table of another layout takes, counts 10 compares, 10 selects and 9
#:   muxes).
#:   The shard kernels count as their families: the bitplane one draws
#:   once per 4-word group too on the main path's index planes (the
#:   driver's at k = 2 make every group one Philox group, lanes 0 to 3).
#: * tensorcore, per plane position (a site of each of the two target
#:   planes): lanes 0 and 1 of one Philox4x32-10 call at counter
#:   (offset, 0, position, 0): lane 0's 16 wide multiplies, one low half
#:   and 17 XORs, as for stencil, since round 9's one wide multiply
#:   gives both lanes; per site 1 compare of the draw with the bound and
#:   1 merge of the flip (the sums come out of the products as the
#:   bound's index: they start at 2^23 + 2^22 + 4 inside the mma, so no
#:   float add); on the tensor pipe the banded products' FLOP at the
#:   kernel's own tile (``tensorcore_flop_per_position``).
#: * draws (``philox_fill``), per element of lane 0 at counter (offset,
#:   c1, index, c3), offset, lanes and key the same for every element:
#:   stencil's Philox, 16 wide multiplies, one low half and 17 XORs; 1
#:   uint32 -> float conversion and 1 float multiply by 2^-32.  (All four
#:   lanes would take 18 wide multiplies, 19 XORs and 4 conversions and
#:   multiplies; the main path draws lane 0.)
PIPE_OPS = {
    "stencil": {"wide": 16, "fma": 1, "alu": 21, "xu": 1},
    "multispin": {"wide": 2 + 2 * 16, "fma": 0,
                  "alu": 1 + 2 * 18 + 3 + 8 * 3 + 1, "xu": 0},
    "bitplane": {"wide": 18 / 4, "fma": 0, "alu": 19 / 4 + 5 + 4 + 3 * 2,
                 "xu": 0},
    "tensorcore": {"wide": 16, "fma": 1, "alu": 17 + 2 * 2, "xu": 0},
    "draws": {"wide": 16, "fma": 1 + 1, "alu": 17, "xu": 1},
}
#: FMA-pipe slots of one wide multiply: ``python -m
#: repro_torch.analysis.issue_rate`` times lane-0 Philox (16 wide
#: multiplies and 1 low half a site) at about 0.56 SM clocks a site on an
#: H100 SXM at 700 W (PERF.md), near what two of the pipe's 64 slots a
#: clock a wide multiply predict (33 / 64 = 0.516), far from one (0.27)
FMA_WIDE_SLOTS = 2
#: ALU-pipe slots of one wide multiply besides those: ``issue_rate`` runs
#: chains of a high-half multiply with a shift or XOR at two thirds of
#: the rate of low-half ones (20.63 against 30.64 products a clock, H100
#: SXM at 700 W, PERF.md; 20.88 against 31.04 before), and the paired
#: Philox and the multispin accept take the sum of their times, not the
#: larger: as if a wide multiply also took an ALU slot
WIDE_ALU_SLOTS = 1
#: results per clock per SM on compute capability 9.0 (CUDA C++
#: Programming Guide, arithmetic instruction throughput): 32-bit integer
#: multiply 64, add, logic and compare 64, type conversions 16; dense bf16
#: FLOP on the tensor cores 4096 (989 TFLOP/s on the H100 SXM data sheet
#: is 4096 per clock on each of 132 SMs at its 1830 MHz boost clock)
PIPE_PER_CLOCK_PER_SM = {"fma": 64, "alu": 64, "xu": 16, "tensor": 4096}
#: four schedulers per SM, each dispatching one warp instruction per
#: clock
DISPATCH_PER_CLOCK_PER_SM = 4 * 32
#: the eleven kernels: family, tier, TPU kernel replaced
KERNELS = {
    "stencil_update": ("stencil", "half-sweep",
                       "src/repro/kernels/stencil/stencil.py:76"),
    "stencil_sweeps_resident": ("stencil", "k-sweep",
                                "src/repro/kernels/stencil/resident.py:91"),
    "multispin_update": ("multispin", "half-sweep",
                         "src/repro/kernels/multispin/multispin.py:87"),
    "multispin_sweeps_resident": (
        "multispin", "k-sweep", "src/repro/kernels/multispin/resident.py:103"),
    "bitplane_update": ("bitplane", "half-sweep",
                        "src/repro/kernels/bitplane/bitplane.py:72"),
    "bitplane_sweeps_resident": (
        "bitplane", "k-sweep", "src/repro/kernels/bitplane/resident.py:91"),
    "tensorcore_update": ("tensorcore", "half-sweep",
                          "src/repro/kernels/tensorcore/tensorcore.py:97"),
    "stencil_shard_sweeps": ("stencil", "shard",
                             "src/repro/dist/kernels.py:69"),
    "multispin_shard_sweeps": ("multispin", "shard",
                               "src/repro/dist/kernels.py:101"),
    "bitplane_shard_sweeps": ("bitplane", "shard",
                              "src/repro/dist/kernels.py:132"),
    # not a TPU kernel: the draws the JAX package computes in jnp
    "philox_fill": ("draws", "fill",
                    "none: src/repro/core/rng.py:112 uniforms, in jnp"),
}
ENGINE_FAMILY = {"stencil_pallas": "stencil",
                 "multispin_pallas": "multispin",
                 "bitplane_pallas": "bitplane"}
#: bytes per extended cell of a shard kernel's index planes in device
#: memory (uint32 site or word index; bitplane: group index and lane)
SHARD_INDEX_BYTES = {"stencil": 4, "multispin": 4, "bitplane": 8}
#: stencil k-sweep cases at the kernel's 4-cell words and 32-word rows:
#: (rows, plane width, tile rows, tile columns, k, n_sweeps)
STENCIL_EDGE_CASES = ((12, 3, 5, 3, 1, 2), (20, 5, 8, 5, 2, 3),
                      (16, 127, 8, 120, 2, 2), (10, 129, 5, 120, 1, 1),
                      (16, 130, 8, 13, 3, 3), (48, 256, 16, 248, 2, 3))
#: the same for the stencil shard kernel: (extended plane, n_sweeps,
#: tile)
STENCIL_SHARD_EDGE_CASES = (((12, 3), 1, (6, 3, 64)),
                            ((14, 5), 2, (6, 5, 64)),
                            ((10, 127), 2, (8, 120, 256)),
                            ((10, 129), 1, (5, 120, 64)),
                            ((16, 130), 3, (8, 13, 96)),
                            ((40, 512), 2, (16, 248, 256)))
#: the multispin k-sweep cases: word widths 1, 3, 31, 33 and 129, tiles
#: whose width is not a multiple of 4 or of a warp, a halo wider than the
#: plane, n_sweeps 1 to 3, 16-byte loads on inner tiles: (rows, words,
#: tile rows, tile words, k, n_sweeps, start offset)
MULTISPIN_EDGE_CASES = ((12, 1, 5, 1, 1, 2, 2 ** 31 - 2),
                        (20, 3, 8, 3, 2, 3, 2 ** 32 - 3),
                        (16, 31, 8, 12, 2, 2, 2 ** 31 - 1),
                        (10, 33, 5, 33, 1, 1, 2 ** 32 - 1),
                        (16, 129, 8, 120, 3, 3, 2 ** 32 - 3),
                        (48, 256, 16, 120, 2, 3, 2 ** 31 - 2))
#: the same for the multispin shard kernel: (extended plane, n_sweeps,
#: tile)
MULTISPIN_SHARD_EDGE_CASES = (((12, 3), 1, (6, 3, 64)),
                              ((14, 5), 2, (6, 5, 64)),
                              ((10, 129), 1, (5, 120, 64)),
                              ((16, 33), 3, (8, 13, 96)),
                              ((40, 512), 2, (16, 120, 256)))
#: the redesigned kernels' inner loops in phase 2's SASS: (library,
#: kernel (a part of its name: every kernel whose name holds it), the
#: element a pass updates, bytes it stores a element, an
#: opcode the loop holds, the memory it updates, whether a division is
#: barred from it): tensorcore_update's column-tile loop on int8 planes at
#: the main path's tile (a position stores a byte of each target), the
#: bitplane k-sweep and shard kernels' group loop (every instance: both
#: accepts) and the multispin ones' word loop (a word stores 4 bytes),
#: and stencil_update's row loop on device memory (a site stores a byte)
SASS_LOOPS = (
    ("tensorcore", "tensorcore_update_kernel<a,{tile_rows},{tile_cols}>",
     "position", 2, "HMMA", "shared", False),
    ("bitplane", "bitplane_sweeps_kernel", "word", 4, "IMAD.WIDE", "shared",
     True),
    ("multispin", "multispin_sweeps", "word", 4, "IMAD.WIDE", "shared",
     True),
    ("stencil", "stencil_update_kernel", "site", 1, "IMAD.WIDE", "global",
     True),
)
#: the SASS of a 32-bit integer division or remainder by a value known
#: only at run time: a reciprocal on the XU pipe and its conversions
DIVISION_OPCODES = ("MUFU", "I2F", "I2FP", "F2I", "F2IP")
#: stencil_update's planes: widths 3, 5, 127, 129 and 130 (cell by
#: cell), 256 (words), odd row counts and rows past one thread's 16:
#: (rows, plane width)
STENCIL_UPDATE_CASES = ((13, 3), (21, 5), (17, 127), (33, 129), (15, 130),
                        (35, 256))
#: the bitplane accepts' k-sweep cases: k 1 to 3, tiles that do not
#: divide the plane, halos wider than the plane: (rows, words, tile rows,
#: tile words, k, n_sweeps)
BITPLANE_ACCEPT_CASES = ((30, 12, 7, 8, 3, 3), (40, 52, 16, 20, 1, 2),
                         (64, 64, 24, 56, 2, 3), (20, 4, 6, 4, 2, 2),
                         (100, 300, 40, 120, 2, 4))
#: ... and shard cases: (extended plane, n_sweeps, tile)
BITPLANE_ACCEPT_SHARD_CASES = (((14, 10), 3, (14, 10, 64)),
                               ((30, 41), 2, (12, 20, 64)),
                               ((40, 136), 1, (16, 120, 256)))
#: the bitplane kernels' accepts: the three-threshold one at the main
#: path's temperature and at TC_COLD_T (t4 = t8 = 0), the general one
#: for a table of another layout (the thresholds of T = 2.4 shuffled)
BITPLANE_SHUFFLE = (3, 8, 1, 0, 9, 5, 7, 2, 4, 6)
MESH = (2, 2)               # the sharded main paths' mesh
SMALL_MESHES = ((1, 1), (2, 2), (4, 1), (2, 1, 2))
#: the ensemble main paths: a temperature scan as users run one (the
#: examples/figures.py scan at a research lattice size, two seeds a
#: temperature), 16 members of 8192^2 (2^30 spins, as the single path's
#: 32768^2); bitplane 16 members of 4096^2 x 32 replicas (2^33
#: replica-spins)
ENSEMBLE_N = 8192
BITPLANE_ENSEMBLE_N = 4096
ENSEMBLE_TEMPS = (1.5, 1.8, 2.0, 2.1, 2.2, 2.269, 2.3, 2.5)
ENSEMBLE_SEEDS = (7, 2 ** 31 + 11)
BITPLANE_ENSEMBLE_TEMPS = (2.5, 2.75, 3.0, 3.5)
BITPLANE_ENSEMBLE_SEEDS = (7, 8, 2 ** 31 + 11, 2 ** 32 - 1)
#: the member-axis checks: 3 members of distinct temperatures and seeds
#: (a member's seed is a uint32 Philox key: its top bit and 2^32 - 1)
CHECK_TEMPS = (2.0, 2.5, 3.0)
CHECK_SEEDS = (7, 2 ** 31 + 11, 2 ** 32 - 1)
#: the member-axis k-sweep cases beside the small and ragged ones, of an
#: odd tile grid: (rows, plane width, tile rows, tile columns, k,
#: n_sweeps)
BATCHED_EDGE_CASES = {"stencil": (16, 130, 8, 13, 3, 3),
                      "multispin": (16, 129, 8, 120, 3, 3),
                      "bitplane": (30, 12, 7, 8, 3, 3)}
#: every engine an ensemble takes (the counter-based ones) and its family
ENSEMBLE_ENGINES = {"stencil_pallas": "stencil", "multispin": "multispin",
                    "multispin_pallas": "multispin", "bitplane": "bitplane",
                    "bitplane_pallas": "bitplane"}
#: the small-member path: 64 seeds at T_c on 512^2, one ensemble against
#: 64 single-mode sessions one after another
SMALL_ENSEMBLE_MEMBERS = 64
SMALL_ENSEMBLE_T = 2.269
#: sweeps of the 512^2 ensemble parity checks
ENSEMBLE_CHECK_SWEEPS = 20
#: philox_fill's main-path shape: the lane-0 uniforms of one half-sweep
#: of basic_philox at 32768^2, a (32768, 16384) plane
FILL_SHAPE = (FULL_N, FULL_N // 2)
#: philox_fill's checks: (members, shape or None for an index plane of
#: INDEX_SHAPE, offset, c1, c3, lanes): a row-major plane of an odd
#: element count, B = 16 members of distinct seeds, index planes, offsets
#: near 2^31 and 2^32, the lanes c1 of the sweeps (0), Wolff (2) and the
#: couplings (3) with c3 > 0, 1 and 2 lanes
FILL_CASES = ((1, (1001, 1003), 5, 0, 0, 1),
              (16, (64, 130), 2 ** 32 - 1, 0, 0, 1),
              (16, None, 2 ** 32 - 2, 2, 5, 2),
              (3, (33, 65), 2 ** 31, 3, 1, 2),
              (4, (5, 7), 2 ** 31 - 1, 2, 7, 1),
              (1, None, 2 ** 32 - 3, 0, 0, 1))
FILL_INDEX_SHAPE = (77, 129)
FILL_SEEDS = tuple([SEED] + [977 * i + 3 for i in range(1, 15)]
                   + [2 ** 32 - 1])
#: phase 9: the engines of plain updates at full size, one session at a
#: time; then at 512^2 (32^3) the card against the CPU
SPINGLASS_N = 16384
SPINGLASS_FERRO_N = 8192
WOLFF_N, WOLFF_T, WOLFF_FLIPS = 1024, 1.8, 60
WOLFF_TC_N, WOLFF_TC_T, WOLFF_TC_FLIPS = 512, 2.269, 100
CUBE_N = 512
CUBE_SWEEPS = 60
SMALL_CUBE_N = 32
SMALL_SWEEPS = 20
#: the temperature of phase 9's card-against-CPU Wolff check: small
#: clusters, so the CPU's plain draws (a plane a BFS depth) stay quick
SMALL_WOLFF_T, SMALL_WOLFF_FLIPS = 3.0, 4
#: a basic_philox checkpoint written by the JAX package (its generator
#: ``make_jax_checkpoint.py`` beside it) and its digests
JAX_CHECKPOINT = ROOT / "tests" / "data" / "torch_port" / "basic_philox_512"
#: phase 10: the supervised main path (multispin_pallas at FULL_N^2):
#: sweeps, chunk, checkpoint cadence, and the step whose chunk stops it
SUPERVISE_SWEEPS, SUPERVISE_CHUNK, SUPERVISE_EVERY = 200, 50, 100
SUPERVISE_STOP = 150
#: the chaos drills through the CLI: lattice, engine, member temperatures
#: and the drill's sweeps, cadence and chunk
CHAOS_N = 4096
CHAOS_ARGS = ("--engine", "multispin_pallas", "--sweeps", "256",
              "--every", "64", "--chunk", "32")
CHAOS_TEMPS = "1.8,2.0,2.2,2.4"
#: the out-of-memory drill: stencil_pallas at FULL_N^2 (planes 2 x 512
#: MiB); the device memory it leaves free: less than the k-sweep tier's
#: second copy of the planes (1 GiB), more than the half-sweep tier needs
OOM_SWEEPS = 20
OOM_FREE_BYTES = 256 << 20
#: the shared-memory drill: stencil_pallas at SMEM_N^2, its plan's tile
#: rows raised to SMEM_TILE_ROWS (about 1 MB a block, over the card's
#: 227 KB)
SMEM_N, SMEM_SWEEPS, SMEM_TILE_ROWS = 4096, 4, 1024
#: the traced main path: the CLI's measured trajectory, the in-process
#: run's sweeps
TRACE_MEASURE, TRACE_EVERY, TRACE_SWEEPS = 10, 10, 200
#: weakscale rows: shard counts D of (D, 1) meshes, rows per shard,
#: columns, sweeps a call, calls
WEAKSCALE_SHARDS = (1, 2, 4)
WEAKSCALE_BASE_N, WEAKSCALE_COLS = 2048, 8192
WEAKSCALE_SWEEPS, WEAKSCALE_TRIALS = 4, 2


def check(ok: bool, what: str) -> None:
    if not ok:
        raise RuntimeError(f"chip_smoke: {what}")


def phase_10(drive, timed_ms) -> None:
    """Telemetry, resilience and the checkpointer on the card: the
    supervised main path at full size (preempted, its newest step
    corrupted, resumed under an injected transient fault and an injected
    demotion, to the uninterrupted digest), the chaos drill through the
    CLI (an ensemble; a 2 x 2 mesh resumed on 1 x 2), a real
    ``OutOfMemoryError`` and a shared-memory overflow demoting with the
    trajectory unchanged, the traced CLI run's counters and the fence of
    the ``dispatch`` span, and the weakscale rows' halo counters.
    ``drive(path, family, tier, fn)`` is :func:`main`'s: each path
    launches its tier's kernel and no other.  Raises on any failed
    gate."""
    import torch

    import repro_torch.telemetry as tel
    from repro_torch.api import EngineSpec, LatticeSpec, RunSpec, Session
    from repro_torch.ckpt import Checkpointer
    from repro_torch.dist import weakscale
    from repro_torch.dist.planner import plan_shard_resident
    from repro_torch.kernels import errors as kernel_errors
    from repro_torch.kernels.stencil import stencil as stencil_kernels
    from repro_torch.resilience import Supervisor, degrade, faults, integrity
    from repro_torch.telemetry import diff_counters, validate_trace

    def counters():
        return tel.REGISTRY.snapshot()

    env = dict(os.environ, PYTHONPATH=str(SRC))
    spec = RunSpec(lattice=LatticeSpec(FULL_N, FULL_N, init_p_up=1.0),
                   engine=EngineSpec("multispin_pallas"),
                   temperature=TEMPERATURE, seed=SEED)
    degrade.reset_demotions()

    # -- 10.1 the supervised main path at full size -------------------------
    t1 = time.perf_counter()
    ref = Session.open(spec)
    ref.run(SUPERVISE_SWEEPS)
    t2 = time.perf_counter()
    want = ref.state_digest()
    digest_s = time.perf_counter() - t2
    print(f"phase 10: uninterrupted run({SUPERVISE_SWEEPS}) of "
          f"multispin_pallas {FULL_N}^2 digest {want}: the digest of "
          f"{sum(a.nbytes for a in ref._runner.state_arrays().values())} "
          f"B of planes took {digest_s:.2f} s on the host")
    del ref
    # the host CRC32C's share of each checkpoint write and validation
    timings, crc_s = [], [0.0]
    real = (integrity.crc32c, Checkpointer._write,
            integrity.validate_step_dir, integrity.verify_arrays)

    def timed_crc(data, value=0):
        t = time.perf_counter()
        try:
            return real[0](data, value)
        finally:
            crc_s[0] += time.perf_counter() - t

    def timed(kind, fn):
        def wrapper(*args, **kwargs):
            c, t = crc_s[0], time.perf_counter()
            try:
                return fn(*args, **kwargs)
            finally:
                timings.append((kind, time.perf_counter() - t, crc_s[0] - c))
        return wrapper

    integrity.crc32c = timed_crc
    Checkpointer._write = timed("write", real[1])
    integrity.validate_step_dir = timed("validate", real[2])
    integrity.verify_arrays = timed("verify arrays", real[3])
    path = f"multispin_pallas {FULL_N}^2 supervised"
    try:
        with tempfile.TemporaryDirectory() as d:
            def stop(sup):
                if sup.session.step_count >= SUPERVISE_STOP:
                    sup.request_stop()

            def first():
                return Supervisor(spec, d, every_sweeps=SUPERVISE_EVERY,
                                  chunk=SUPERVISE_CHUNK,
                                  on_chunk=stop).run(SUPERVISE_SWEEPS)

            t2 = time.perf_counter()
            r1 = drive(f"{path} to preemption", "multispin", "k-sweep", first)
            first_s = time.perf_counter() - t2
            print(f"phase 10: {path}: {r1.status} at {r1.step_count} in "
                  f"{first_s:.2f} s, checkpoints {r1.checkpoints_written}")
            check(r1.status == "preempted"
                  and r1.step_count == SUPERVISE_STOP
                  and r1.checkpoints_written == [SUPERVISE_EVERY,
                                                 SUPERVISE_STOP],
                  f"{path}: not preempted at {SUPERVISE_STOP} with two "
                  f"checkpoints")
            faults.flip_byte(d, SUPERVISE_STOP)
            base = counters()

            def second():
                plan = faults.FaultPlan(transient_dispatches=1,
                                        resident_oom=1)
                with faults.injected(plan):
                    sup = Supervisor(spec, d, every_sweeps=SUPERVISE_EVERY,
                                     chunk=SUPERVISE_CHUNK)
                    return sup, sup.run(SUPERVISE_SWEEPS), plan

            t2 = time.perf_counter()
            sup, r2, plan = drive(f"{path} resumed", "multispin",
                                  "half-sweep", second)
            second_s = time.perf_counter() - t2
            got = diff_counters(base, counters())
            recovery = {k: got.get(k, 0) for k in (
                "resilience.resume", "ckpt.quarantine", "resilience.retry",
                "resident.demote")}
            print(f"phase 10: {path} resumed: from step "
                  f"{sup.resumed_from}, {r2.status} at {r2.step_count} in "
                  f"{second_s:.2f} s, checkpoints {r2.checkpoints_written}, "
                  f"faults fired {plan.fired}, counters {recovery}, digest "
                  f"{r2.digest} (uninterrupted {want}); steps left "
                  f"{sorted(os.listdir(d))}")
            # the JAX supervisor skips a corrupt step without quarantining
            # it (Checkpointer.latest_step, then an explicit load_arrays):
            # ckpt.quarantine stays 0, as there
            check(sup.resumed_from == SUPERVISE_EVERY
                  and recovery == {"resilience.resume": 1,
                                   "ckpt.quarantine": 0,
                                   "resilience.retry": 1,
                                   "resident.demote": 1},
                  f"{path}: resumed from {sup.resumed_from}, counters "
                  f"{recovery}")
            check(sup.session.engine.resident_plan is None,
                  f"{path}: the injected demotion left the k-sweep tier")
            check(r2.completed and r2.digest == want,
                  f"{path}: digest {r2.digest}, not the uninterrupted "
                  f"{want}")
            del sup
    finally:
        (integrity.crc32c, Checkpointer._write, integrity.validate_step_dir,
         integrity.verify_arrays) = real
        degrade.reset_demotions()
    for kind, seconds, crc in timings:
        print(f"phase 10: {path}: checkpoint {kind} {seconds:.2f} s, of it "
              f"CRC32C {crc:.2f} s ({100 * crc / max(seconds, 1e-9):.1f} %)")
    print(f"phase 10: {path}: host CRC32C {crc_s[0]:.2f} s in all (the "
          f"digests' included)")

    # -- 10.2 the chaos drill through the CLI --------------------------------
    # the subprocesses need the card's memory that this one has cached
    torch.cuda.empty_cache()
    for drill, extra in (("ensemble", ("--temps", CHAOS_TEMPS)),
                         ("mesh", ("--mesh", "2x2", "--resume-mesh",
                                   "1x2"))):
        with tempfile.TemporaryDirectory() as d:
            t2 = time.perf_counter()
            proc = subprocess.run(
                [sys.executable, "-m", "repro_torch.resilience.chaos",
                 "--device", "cuda", "--n", str(CHAOS_N), "--workdir", d,
                 *CHAOS_ARGS, *extra], env=env, capture_output=True,
                text=True, timeout=900)
            lines = proc.stdout.strip().splitlines()
            print(f"phase 10: chaos drill ({drill}, {CHAOS_N}^2): exit "
                  f"{proc.returncode} in {time.perf_counter() - t2:.2f} s; "
                  + " | ".join(l for l in lines if l.startswith(
                      ("supervised run", "# chaos run exit", "# resumed",
                       "chaos drill"))))
            if proc.returncode != 0:
                print(proc.stdout[-4000:] + proc.stderr[-4000:],
                      file=sys.stderr)
            check(proc.returncode == 0, f"chaos drill {drill} failed")

    # -- 10.3 a real out-of-memory demotion, and a shared-memory one --------
    oom_spec = dataclasses.replace(spec, engine=EngineSpec("stencil_pallas"))
    ref = Session.open(oom_spec)
    ref.run(OOM_SWEEPS)
    session = Session.open(oom_spec)
    check(session.engine.resident_plan is not None,
          "stencil_pallas plans no k-sweep tier at full size")
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    before = torch.cuda.memory_allocated()
    free = torch.cuda.mem_get_info()[0]
    ballast = torch.empty(free - OOM_FREE_BYTES, dtype=torch.uint8,
                          device="cuda")
    free_left = torch.cuda.mem_get_info()[0]
    base = counters()
    path = f"stencil_pallas {FULL_N}^2 run({OOM_SWEEPS}) out of memory"
    drive(path, "stencil", "half-sweep", lambda: session.run(OOM_SWEEPS))
    demoted = diff_counters(base, counters())["resident.demote"]
    reason = degrade.demotion_reason("stencil", FULL_N, FULL_N) or ""
    del ballast
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    left = torch.cuda.memory_allocated() - before
    same = session.step_count == ref.step_count and all(
        torch.equal(a, b) for a, b in zip(session.state, ref.state))
    print(f"phase 10: {path}: {free_left} B free under the ballast; "
          f"{demoted} demotion, reason {reason[:160]!r}; planes equal to "
          f"an undisturbed run's at step {ref.step_count}: {same} (so "
          f"its digest is theirs); device memory left above the planes "
          f"after the ballast is freed: {left} B")
    check(demoted == 1 and reason.startswith("OutOfMemoryError"),
          f"{path}: {demoted} demotions, reason {reason!r}")
    check(same, f"{path}: the demoted run's planes differ")
    check(left < 1 << 20, f"{path}: {left} B left over")
    del session, ref
    degrade.reset_demotions()

    smem_spec = dataclasses.replace(
        oom_spec, lattice=LatticeSpec(SMEM_N, SMEM_N, init_p_up=1.0))
    ref = Session.open(smem_spec)
    ref.run(SMEM_SWEEPS)
    session = Session.open(smem_spec)
    lib = stencil_kernels.library()
    plan = session.engine.resident_plan
    need = lib.stencil_resident_smem_bytes(SMEM_TILE_ROWS, plan.tile_cols,
                                           plan.k)
    limit = kernel_errors.max_shared_memory(lib, session.device)
    # a plan for a budget above the card's: the planner's own rule keeps
    # the family's tile, so the tile is raised by hand
    session.engine.resident_plan = dataclasses.replace(
        plan, tile_rows=SMEM_TILE_ROWS, smem_bytes=need, budget_bytes=need)
    base = counters()
    path = f"stencil_pallas {SMEM_N}^2 run({SMEM_SWEEPS}) shared memory"
    drive(path, "stencil", "half-sweep", lambda: session.run(SMEM_SWEEPS))
    demoted = diff_counters(base, counters())["resident.demote"]
    reason = degrade.demotion_reason("stencil", SMEM_N, SMEM_N) or ""
    digests = (session.state_digest(), ref.state_digest())
    print(f"phase 10: {path}: tile {SMEM_TILE_ROWS} x {plan.tile_cols} "
          f"needs {need} B, the card's opt-in maximum {limit} B; "
          f"{demoted} demotion, reason {reason[:160]!r}; digests {digests}")
    check(need > limit and demoted == 1
          and reason.startswith("SharedMemoryOverflow"),
          f"{path}: {demoted} demotions, reason {reason!r}")
    check(digests[0] == digests[1], f"{path}: digest differs")
    del session, ref
    degrade.reset_demotions()

    # -- 10.4 the traced run -------------------------------------------------
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory() as d:
        trace = os.path.join(d, "t.json")
        t2 = time.perf_counter()
        proc = subprocess.run(
            [sys.executable, "-m", "repro_torch", "run", "--engine",
             "multispin_pallas", "--n", str(FULL_N), "--init-p-up", "1.0",
             "--temperature", str(TEMPERATURE), "--seed", str(SEED),
             "--n-measure", str(TRACE_MEASURE), "--measure-every",
             str(TRACE_EVERY), "--trace", trace], env=env,
            capture_output=True, text=True, timeout=600)
        cli_s = time.perf_counter() - t2
        if proc.returncode != 0:
            print(proc.stdout[-4000:] + proc.stderr[-4000:], file=sys.stderr)
        check(proc.returncode == 0, "the traced CLI run failed")
        with open(trace) as f:
            doc = json.load(f)
        summary = subprocess.run(
            [sys.executable, "-m", "repro_torch.telemetry", "summarize",
             trace], env=env, capture_output=True, text=True, timeout=120)
    validate_trace(doc)
    got = doc["metrics"]["counters"]
    sweeps = TRACE_MEASURE * TRACE_EVERY
    spans = sorted({e["name"] for e in doc["traceEvents"]})
    print(f"phase 10: traced CLI run ({cli_s:.2f} s): span types {spans}; "
          f"counters {got}; summarize exit {summary.returncode}")
    recovery = {k: v for k, v in got.items()
                if k.startswith(("resilience.", "resident.", "ckpt."))}
    check(got["dispatches"] == 1 and got["sweeps"] == sweeps
          and got["spin_flips"] == got["philox_draws"] == sweeps * FULL_N ** 2
          and got["measure.graph_replays"] == TRACE_MEASURE - 1
          and got["halo_exchanges"] == got["halo_bytes"] == 0
          and not any(recovery.values()),
          f"traced CLI run: counters {got}")
    check(summary.returncode == 0 and "dispatches" in summary.stdout,
          "telemetry summarize failed on the trace")

    session = Session.open(spec)
    session.run(2)
    path = f"multispin_pallas {FULL_N}^2 run({TRACE_SWEEPS})"
    untraced_ms = drive(f"{path} untraced", "multispin", "k-sweep",
                        lambda: timed_ms(lambda: session.run(TRACE_SWEEPS),
                                         reps=1, warmup=False))

    def sync_checked():
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            session.run(TRACE_SWEEPS)
        finally:
            torch.cuda.set_sync_debug_mode(0)

    drive(f"{path} sync debug mode error", "multispin", "k-sweep",
          sync_checked)
    # CUDA events just before the dispatch's first launch and just after
    # its last, both inside its span: the span must last at least as long
    marks = []
    launch = session.engine.resident_sweeps

    def marked(*args, **kwargs):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        out = launch(*args, **kwargs)
        end.record()
        marks.append((start, end))
        return out

    session.engine.resident_sweeps = marked
    tel.TRACER.clear()
    tel.enable()
    try:
        traced_ms = drive(f"{path} traced", "multispin", "k-sweep",
                          lambda: timed_ms(lambda: session.run(TRACE_SWEEPS),
                                           reps=1, warmup=False))
    finally:
        tel.disable()
        del session.engine.resident_sweeps
    dispatches = [e for e in tel.TRACER.events if e["name"] == "dispatch"]
    tel.TRACER.clear()
    check(len(dispatches) == len(marks) == 1,
          f"{path} traced: {len(dispatches)} dispatch spans, {len(marks)} "
          f"marked launches")
    span_ms = dispatches[0]["dur_us"] / 1e3
    device_ms = marks[0][0].elapsed_time(marks[0][1])
    print(f"phase 10: {path}: untraced {untraced_ms:.3f} ms, traced "
          f"{traced_ms:.3f} ms; the dispatch span {span_ms:.3f} ms against "
          f"its launches' CUDA-event time {device_ms:.3f} ms; no host "
          f"synchronization under sync debug mode 'error' untraced")
    check(span_ms >= device_ms,
          f"{path}: the dispatch span ({span_ms} ms) closed before its "
          f"launches finished ({device_ms} ms): the fence did not wait")
    del session

    # -- 10.5 weakscale rows: the halo counters against the plans ------------
    for family, engine in weakscale.FAMILY_ENGINES.items():
        rows = drive(f"weakscale {family}", family, "shard",
                     lambda: weakscale.measure_rows(
                         WEAKSCALE_SHARDS, base_n=WEAKSCALE_BASE_N,
                         cols=WEAKSCALE_COLS, sweeps=WEAKSCALE_SWEEPS,
                         trials=WEAKSCALE_TRIALS, families=(family,)))
        for row in rows:
            shards = row["derived"]["devices"]
            plan = plan_shard_resident(family, WEAKSCALE_BASE_N * shards,
                                       WEAKSCALE_COLS, shards, 1)
            ex = plan.exchanges(WEAKSCALE_SWEEPS)
            print(f"phase 10: weakscale row {row['name']}: {row['us']:.1f} "
                  f"us a call, {row['derived']}; plan k = {plan.k}, "
                  f"{ex} exchanges of {plan.halo_bytes_per_exchange} B")
            check(row["derived"]["halo_exchanges_per_call"] == ex
                  and row["derived"]["halo_kb_per_call"] == round(
                      ex * plan.halo_bytes_per_exchange / 1024, 3),
                  f"weakscale {row['name']}: halo counters against the "
                  f"plan")


def nvidia_smi(query: str) -> str:
    out = subprocess.run(
        ["nvidia-smi", f"--query-gpu={query}", "--format=csv,noheader"],
        check=True, capture_output=True, text=True).stdout
    return out.strip().splitlines()[0]


def tensorcore_flop_per_position(rows: int, cols: int) -> float:
    """Tensor-core FLOP per plane position of ``csrc/tensorcore.cu`` at
    its tile of rows x cols: for each 16 x 8 output tile, the mma.sync
    k-steps of its four banded products whose K tile is not all zero (the
    only ones the kernel runs; the column products' K is cols deep, the
    row products' rows deep), 2 * 16 * 8 * 16 FLOP each."""
    steps = 0
    for r0 in range(0, rows, 16):
        for c0 in range(0, cols, 8):
            for lo, hi, depth in ((c0 - 1, c0 + 7, cols), (c0, c0 + 8, cols),
                                  (r0, r0 + 16, rows),
                                  (r0 - 1, r0 + 15, rows)):
                steps += sum(1 for k0 in range(0, depth, 16)
                             if lo <= k0 + 15 and hi >= k0)
    return steps * 2 * 16 * 8 * 16 / (rows * cols)


def clocks_per_element(family: str) -> float:
    """SM clocks per element update at the busiest pipe, or at the
    dispatch rate (of the pipes other than the tensor cores' FLOP) where
    that is lower."""
    ops = dict(PIPE_OPS[family])
    wide = ops.pop("wide")
    ops["fma"] += FMA_WIDE_SLOTS * wide
    ops["alu"] += WIDE_ALU_SLOTS * wide
    pipes = max(ops[p] / PIPE_PER_CLOCK_PER_SM[p] for p in ops)
    issued = wide + sum(v for p, v in PIPE_OPS[family].items()
                        if p not in ("tensor", "wide"))
    return max(pipes, issued / DISPATCH_PER_CLOCK_PER_SM)


def bound(family: str, bytes_moved: float, updates: float,
          sm_clocks_per_s: float):
    t_bytes = bytes_moved / HBM_BYTES_PER_S
    t_ops = updates * clocks_per_element(family) / sm_clocks_per_s
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


def tc_random_planes(torch, h: int, dtype, seed: int, w=None) -> dict:
    """Four random (h, w or h) +-1 sublattice planes of ``dtype`` on the
    card."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    return {k: (torch.randint(0, 2, (h, w or h), generator=g, device="cuda",
                              dtype=torch.int8) * 2 - 1).to(dtype)
            for k in ("00", "01", "10", "11")}


def cold_all_up(family: str, n: int):
    """All-up (n, 132) int8 stencil planes, (n, 20) multispin word planes
    or (n, 44) bitplane word planes on the card and the family's table at
    TC_COLD_T, where an up spin's flip against 4 up neighbours has bound
    0 (no spin may flip)."""
    import torch
    from repro_torch.core import metropolis, multispin
    if family == "stencil":
        return (torch.ones((n, 132), dtype=torch.int8, device="cuda"),
                metropolis.acceptance_table(1.0 / TC_COLD_T))
    word, w = (0x11111111, 20) if family == "multispin" else (-1, 44)
    return (torch.full((n, w), word, dtype=torch.int32, device="cuda"),
            multispin.acceptance_thresholds(1.0 / TC_COLD_T))


def bitplane_accept_tables() -> dict:
    """The bitplane kernels' tables by accept (BITPLANE_SHUFFLE)."""
    import torch
    from repro_torch.core import multispin
    return {"three": multispin.acceptance_thresholds(
                1.0 / BITPLANE_TEMPERATURE),
            "three (cold)": multispin.acceptance_thresholds(1.0 / TC_COLD_T),
            "general": multispin.acceptance_thresholds(1.0 / 2.4)[
                torch.tensor(BITPLANE_SHUFFLE)]}


def ensemble_batch(family: str):
    """``(lattice side, BatchSpec)`` of the family's ensemble main path."""
    from repro_torch.api import BatchSpec
    if family == "bitplane":
        return BITPLANE_ENSEMBLE_N, BatchSpec(BITPLANE_ENSEMBLE_TEMPS,
                                              BITPLANE_ENSEMBLE_SEEDS,
                                              grid=True)
    return ENSEMBLE_N, BatchSpec(ENSEMBLE_TEMPS, ENSEMBLE_SEEDS, grid=True)


def member_tables(family: str, temps) -> list:
    """The family's table at each temperature."""
    from repro_torch.core import metropolis, multispin
    make = metropolis.acceptance_table if family == "stencil" \
        else multispin.acceptance_thresholds
    return [make(1.0 / t) for t in temps]


def member_limit(family: str) -> int:
    """The most members one launch of the family's kernels takes."""
    import importlib
    lib = importlib.import_module(
        f"repro_torch.kernels.{family}.{family}").library()
    return getattr(lib, f"{family}_max_members")()


def random_batch(family: str, members: int, n: int, h: int, seed: int):
    """Two random ``(members, n, h)`` planes of the family's kind on the
    card."""
    import torch
    from repro_torch.analysis.tune_resident import random_planes
    planes = [random_planes(family, n, h, seed + i) for i in range(members)]
    return tuple(torch.stack(p) for p in zip(*planes))


def replica_disagreements(torch, words) -> "torch.Tensor":
    """(31, 32) int64: entry [d-1, r] counts the sites where replica r
    and replica (r + d) % 32 differ, summed over the given word planes."""
    from repro_torch.core import bitplane, lattice
    out = []
    for d in range(1, 32):
        total = 0
        for w in words:
            u = lattice.words_to_u32(w)
            rot = ((u >> d) | (u << (32 - d))) & 0xFFFFFFFF
            total = total + bitplane.bit_counts(
                lattice.u32_to_words(u ^ rot))
            del u, rot
        out.append(total)
    return torch.stack(out)


def main() -> int:
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    if not (SRC / "repro_torch" / "csrc").is_dir():
        print(f"chip_smoke: {SRC / 'repro_torch'} not found",
              file=sys.stderr)
        return 1
    sys.path.insert(0, str(SRC))
    import importlib

    from repro_torch.api import (BatchSpec, EngineSpec, LatticeSpec,
                                 MeshSpec, RunSpec, Session, SweepSpec)
    from repro_torch.core import distributed, metropolis, multispin
    from repro_torch.core import observables
    from repro_torch.analysis import sass
    from repro_torch.analysis.tune_resident import random_planes, timed_ms
    from repro_torch.dist import driver as shard_driver
    from repro_torch.dist import planner as shard_planner
    from repro_torch.kernels import _build, resident
    from repro_torch.kernels.tensorcore.tensorcore import (CUDA_BLOCKS,
                                                           kernel_geometry)
    from repro_torch.launch.mesh import make_mesh

    t_start = time.perf_counter()
    phase_s = {}
    wrappers, plains = {}, {}
    for name, (family, tier, _) in KERNELS.items():
        pkg = importlib.import_module(
            "repro_torch.dist.kernels" if tier == "shard"
            else f"repro_torch.kernels.{family}")
        wrappers[name] = getattr(pkg, name)
        plains[name] = getattr(pkg, f"{name}_plain")

    # -- 1. card -------------------------------------------------------------
    card_line = nvidia_smi("name,power.limit")
    max_sm_mhz = float(nvidia_smi("clocks.max.sm").split()[0])
    props = torch.cuda.get_device_properties(0)
    sm_clocks_per_s = props.multi_processor_count * max_sm_mhz * 1e6
    print(f"phase 1: card {card_line}; torch {torch.__version__}, CUDA "
          f"{torch.version.cuda}, python {sys.version.split()[0]}; "
          f"{props.multi_processor_count} SMs at max {max_sm_mhz:.0f} MHz; "
          "bound: SM clocks per element update " + ", ".join(
              f"{f} {clocks_per_element(f):.6f} (ops by pipe {PIPE_OPS[f]})"
              for f in PIPE_OPS))

    # -- 2. build ------------------------------------------------------------
    t0 = time.perf_counter()
    builds = _build.build()
    for b in builds.values():
        print(f"phase 2: built csrc/{b.name}.cu in {b.seconds:.2f} s")
        for line in b.ptxas_summary():
            print(f"  ptxas {line}")
        code = sass.disassemble(b.path, _build.nvcc())
        for kernel, mix in sass.sass_mix(code).items():
            print(f"  SASS {kernel}: {mix}")
            if kernel.startswith("tensorcore_update_kernel"):
                check(mix.get("tensor", 0) > 0,
                      f"{kernel} holds no HMMA: its products are not on "
                      f"the tensor cores")
        if b.name == "stencil":
            # the two k-sweep kernels' site loops, per site update
            loops = sass.site_loops(code, "stencil_sweeps_kernel")
            check(bool(loops), "no site loop found in stencil_sweeps_kernel")
            for loop in loops:
                pipes = {p: round(v, 2) for p, v in loop["per_site"].items()}
                print(f"  SASS site loop {loop['kernel']} {loop['range']}: "
                      f"{loop['sites']} sites a pass, per site "
                      f"{loop['per_site_total']:.2f} instructions {pipes}")
                check(not any(op.split(".")[0] in ("I2F", "I2FP", "FMUL",
                                                   "FSETP")
                              for op in loop["opcodes_per_site"]),
                      f"{loop['kernel']}: a float accept in the site loop")
        for (library, kernel, unit, bytes_per, holds, memory,
             no_division) in SASS_LOOPS:
            if library != b.name:
                continue
            if library == "tensorcore":
                kernel = kernel.format(**kernel_geometry(FULL_N // 2,
                                                         FULL_N // 2))
            loops = [lp for lp in sass.site_loops(code, kernel, memory)
                     if any(op.startswith(holds)
                            for op in lp["opcodes_per_site"])]
            check(bool(loops), f"no {unit} loop found in {kernel}")
            instances = {lp["kernel"] for lp in loops}
            if library == "bitplane":
                # <shard, three, batch>: the k-sweep kernel of one member
                # and of an ensemble, the shard kernel, each accept
                check(instances >= {f"{kernel}<{shard},{three},{batch}>"
                                    for shard, batch in (("false", "false"),
                                                         ("false", "true"),
                                                         ("true", "false"))
                                    for three in ("false", "true")},
                      f"{kernel}: not every instance has a group loop "
                      f"({sorted(instances)})")
            for loop in loops:
                pipes = {p: round(v * bytes_per, 2)
                         for p, v in loop["per_site"].items()}
                top = {o: round(v * bytes_per, 2) for o, v in
                       list(loop["opcodes_per_site"].items())[:8]}
                print(f"  SASS {unit} loop {loop['kernel']} {loop['range']}: "
                      f"{loop['sites'] // bytes_per} {unit}s a pass, per "
                      f"{unit} {loop['per_site_total'] * bytes_per:.2f} "
                      f"instructions {pipes}; most issued {top}")
                if no_division:
                    check(not any(op.split(".")[0] in DIVISION_OPCODES
                                  for op in loop["opcodes_per_site"]),
                          f"{loop['kernel']}: an integer division in the "
                          f"{unit} loop")
    from repro_torch.dist import kernels as shard_kernels
    for family in ("stencil", "multispin", "bitplane"):
        lib = importlib.import_module(
            f"repro_torch.kernels.{family}.{family}").library()
        query = getattr(lib, f"{family}_resident_smem_bytes")
        g = resident.GEOMETRY[family]
        for tr, tc, k in ((g.tile_rows, g.tile_cols, g.max_k), (128, 256, 1),
                          (7, 8, 3)):
            check(query(tr, tc, k) == resident.smem_bytes(tr, tc, k, family),
                  f"{family} planner and kernel disagree on shared memory")
        shard_query = getattr(shard_kernels.library(family),
                              f"{family}_shard_smem_bytes")
        for (tr, tc), k in ((shard_planner.SHARD_TILES[family], 2),
                            ((7, 8), 3)):
            check(shard_query(tr, tc, k)
                  == shard_planner.shard_smem_bytes(family, tr, tc, k),
                  f"{family} shard planner and kernel disagree on shared "
                  f"memory")
    phase_s[2] = time.perf_counter() - t0

    # -- 3. kernels against their plain versions -----------------------------
    t0 = time.perf_counter()
    full_plane = {"stencil": (FULL_N, FULL_N // 2),
                  "multispin": (FULL_N, FULL_N // 16),
                  "bitplane": (BITPLANE_N, BITPLANE_N // 2)}
    tables = {"stencil": metropolis.acceptance_table(1.0 / TEMPERATURE),
              "multispin": multispin.acceptance_thresholds(1.0 / TEMPERATURE),
              "bitplane": multispin.acceptance_thresholds(
                  1.0 / BITPLANE_TEMPERATURE)}
    # cases, mismatches, max abs err, plain ms at the full plane
    stats = {name: [0, 0, 0, 0.0] for name in KERNELS}

    def compare(name, got, want, plain_ms=None):
        s = stats[name]
        for a, b in zip(got, want):
            s[0] += 1
            s[1] += int((a != b).sum())
            s[2] = max(s[2], int((a.to(torch.int64) - b.to(torch.int64))
                                 .abs().max()))
        if plain_ms is not None:
            s[3] = plain_ms

    # per bitplane kernel and accept: comparisons, mismatches
    accept_stats = {}

    def check_accept(name, accept, launch, plain):
        """``launch()`` (the kernel) against ``plain()`` for one bitplane
        accept; every launch of the general accept, and only those, must
        be counted as such."""
        wrapper = wrappers[name]
        before = (wrapper.launches, wrapper.general_launches)
        got = launch()
        torch.cuda.synchronize()
        launched = wrapper.launches - before[0]
        general = wrapper.general_launches - before[1]
        check(launched > 0 and general == (launched if accept == "general"
                                           else 0),
              f"{name}: {general} of {launched} launches took the general "
              f"accept for the {accept} table")
        bad = stats[name][1]
        compare(name, got, plain())
        tally = accept_stats.setdefault(name, {}).setdefault(accept, [0, 0])
        tally[0] += len(got)
        tally[1] += stats[name][1] - bad

    def plain_timed(fn):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        out = fn()
        end.record()
        torch.cuda.synchronize()
        return out, start.elapsed_time(end)

    kernel_ms, plans = {}, {}
    for family, (fn, fh) in full_plane.items():
        update = f"{family}_update"
        sweeps = f"{family}_sweeps_resident"
        table = tables[family]
        small_h = SMALL_N * fh // fn
        ragged_h = 12 if family == "bitplane" else 7
        for (n, h), cases in (
                ((SMALL_N, small_h), [(True, 0, SEED), (False, 7, SEED),
                                      (True, 2 ** 31 - 1, 12345),
                                      (False, 2 ** 31, 2 ** 40 + 11),
                                      (True, 2 ** 32 - 1, 2 ** 35 + 1)]),
                ((30, ragged_h), [(False, 2 ** 32 - 2, SEED)]),
                ((fn, fh), [(True, 2, SEED), (False, 2 ** 32 - 1, SEED)])):
            for is_black, offset, seed in cases:
                target, op = random_planes(family, n, h, offset + n)
                want, plain_ms = plain_timed(lambda: plains[update](
                    target, op, table, is_black=is_black, seed=seed,
                    offset=offset))
                got = wrappers[update](target.clone(), op, table,
                                       is_black=is_black, seed=seed,
                                       offset=offset)
                torch.cuda.synchronize()
                compare(update, [got], [want], plain_ms if n == fn else None)
                del target, op, want, got
        if family == "stencil":
            # cell by cell (widths 3 to 130) and by words, odd row counts;
            # at TC_COLD_T from all-up planes no spin may flip
            for n, h in STENCIL_UPDATE_CASES:
                for is_black, offset in ((True, 2 ** 31 - 1),
                                         (False, 2 ** 32 - 1)):
                    target, op = random_planes(family, n, h, n + h)
                    want = plains[update](target, op, table,
                                          is_black=is_black, seed=SEED,
                                          offset=offset)
                    got = wrappers[update](target.clone(), op, table,
                                           is_black=is_black, seed=SEED,
                                           offset=offset)
                    torch.cuda.synchronize()
                    compare(update, [got], [want])
            for h in (130, 256):
                up = torch.ones((35, h), dtype=torch.int8, device="cuda")
                got = wrappers[update](
                    up.clone(), up, metropolis.acceptance_table(
                        1.0 / TC_COLD_T), is_black=True, seed=SEED, offset=5)
                torch.cuda.synchronize()
                compare(update, [got], [up])
            del target, op, want, got, up
        if family == "bitplane":
            for accept, thr in bitplane_accept_tables().items():
                for n, h in ((SMALL_N, small_h), (30, ragged_h), (2, 4)):
                    target, op = random_planes(family, n, h, n + h)
                    check_accept(update, accept, lambda: [wrappers[update](
                        target.clone(), op, thr, is_black=False, seed=SEED,
                        offset=2 ** 32 - 1)], lambda: [plains[update](
                            target, op, thr, is_black=False, seed=SEED,
                            offset=2 ** 32 - 1)])
            del target, op

        small_plan = resident.plan_resident(family, SMALL_N, SMALL_N)
        full_plan = plans[family] = resident.plan_resident(family, fn, fn)
        check(small_plan is not None and full_plan is not None,
              f"{family}: no k-sweep plan at the default budget")
        col_unit = resident.GEOMETRY[family].col_align
        ragged = dataclasses.replace(small_plan, k=2, tile_rows=48,
                                     tile_cols=10 * col_unit)
        wide = dataclasses.replace(
            resident.plan_resident(
                family, 30, ragged_h * resident.GEOMETRY[family].col_divisor),
            k=3, tile_rows=7, tile_cols=2 * col_unit)
        sweep_cases = [
            (SMALL_N, small_h, dataclasses.replace(small_plan, k=1), 1, 0,
             SEED),
            (SMALL_N, small_h, dataclasses.replace(small_plan, k=3), 3,
             2 ** 32 - 3, 2 ** 40 + 11),
            (SMALL_N, small_h, ragged, 5, 2 ** 31 - 2, SEED),
            (30, ragged_h, wide, 3, 10, SEED),
            (fn, fh, full_plan, full_plan.k, 6, SEED)]
        if family == "stencil":
            # the kernel's 4-cell words and 32-word rows: plane widths 3,
            # 5, 127, 129, 130, tiles whose width is not a multiple of 4
            for n, h, tr, tc, k, n_sweeps in STENCIL_EDGE_CASES:
                sweep_cases.append((n, h, dataclasses.replace(
                    small_plan, n=n, m=2 * h, k=k, tile_rows=tr,
                    tile_cols=tc), n_sweeps, 2 ** 32 - 3, SEED))
        if family == "multispin":
            for n, h, tr, tc, k, n_sweeps, start in MULTISPIN_EDGE_CASES:
                for seed in (SEED, 2 ** 40 + 11):
                    sweep_cases.append((n, h, dataclasses.replace(
                        small_plan, n=n, m=16 * h, k=k, tile_rows=tr,
                        tile_cols=tc), n_sweeps, start, seed))
        for (n, h, plan, n_sweeps, start, seed) in sweep_cases:
            b, w = random_planes(family, n, h, n_sweeps + n)
            want, plain_ms = plain_timed(lambda: plains[sweeps](
                b, w, table, n_sweeps=n_sweeps, seed=seed,
                start_offset=start))
            got = wrappers[sweeps](b, w, table, n_sweeps=n_sweeps, seed=seed,
                                   start_offset=start, plan=plan)
            torch.cuda.synchronize()
            compare(sweeps, got, want, plain_ms if n == fn else None)
            del b, w, want, got
        if family == "bitplane":
            for (n, h, tr, tc, k, n_sweeps), (accept, thr) in [
                    (case, table) for case in BITPLANE_ACCEPT_CASES
                    for table in bitplane_accept_tables().items()]:
                b, w = random_planes(family, n, h, n + h + k)
                plan = dataclasses.replace(small_plan, n=n, m=2 * h, k=k,
                                           tile_rows=tr, tile_cols=tc)
                check_accept(sweeps, accept, lambda: wrappers[sweeps](
                    b, w, thr, n_sweeps=n_sweeps, seed=SEED,
                    start_offset=2 ** 32 - 3, plan=plan),
                    lambda: plains[sweeps](b, w, thr, n_sweeps=n_sweeps,
                                           seed=SEED,
                                           start_offset=2 ** 32 - 3))
        # T = TC_COLD_T from all-up planes: bound 0, no spin may flip
        up, cold = cold_all_up(family, 40)
        plan = dataclasses.replace(
            small_plan, n=40, m=up.shape[1] * resident.GEOMETRY[
                family].col_divisor, k=3, tile_rows=16,
            tile_cols=120 if family == "stencil" else 12)
        got = wrappers[sweeps](up, up.clone(), cold, n_sweeps=3, seed=SEED,
                               start_offset=2 ** 32 - 3, plan=plan)
        torch.cuda.synchronize()
        compare(sweeps, got, (up, up))
        del up, got
        for name in (update, sweeps):
            cases, bad, err, _ = stats[name]
            print(f"phase 3: {name}: {cases} plane comparisons with the "
                  f"plain version, {bad} mismatches, max abs err {err}")
            check(bad == 0, f"{name} disagrees with its plain version")

        b, w = random_planes(family, fn, fh, 1)
        kernel_ms[update] = timed_ms(lambda: wrappers[update](
            b, w, table, is_black=True, seed=SEED, offset=0), reps=20)
        kernel_ms[sweeps] = timed_ms(lambda: wrappers[sweeps](
            b, w, table, n_sweeps=full_plan.k, seed=SEED, start_offset=0,
            plan=full_plan), reps=max(2, 16 // full_plan.k))
        print(f"phase 3: {family}: ms per full sweep of a {fn}^2 lattice: "
              f"k-sweep tier {kernel_ms[sweeps] / full_plan.k:.4f} (k = "
              f"{full_plan.k}, tile {full_plan.tile_rows} x "
              f"{full_plan.tile_cols}, threads {full_plan.threads}), "
              f"half-sweep tier {2 * kernel_ms[update]:.4f}")
        del b, w

    # the fused tensor-core kernel: small planes at blocks 16 and 64 in
    # both plane types, then the main path's planes at its block
    tc_update = "tensorcore_update"
    tc_plane = (FULL_N // 2, FULL_N // 2)
    tc_beta = 1.0 / TEMPERATURE
    # every block the kernel takes, on (2B, 3B) planes, both types and
    # colours: at TEMPERATURE from random planes, and at TC_COLD_T from
    # all-up planes, where the table's -8 beta entries underflow to 0
    for block in CUDA_BLOCKS:
        for dtype in (torch.int8, torch.bfloat16):
            for color in ("black", "white"):
                for temp, up in ((TEMPERATURE, False), (TC_COLD_T, True)):
                    planes = tc_random_planes(torch, 2 * block, dtype,
                                              block, 3 * block)
                    if up:
                        planes = {k: v.abs() for k, v in planes.items()}
                    want = plains[tc_update](planes, color, 1.0 / temp,
                                             seed=SEED, offset=block,
                                             block=block)
                    got = wrappers[tc_update](
                        {k: v.clone() for k, v in planes.items()}, color,
                        1.0 / temp, seed=SEED, offset=block, block=block)
                    torch.cuda.synchronize()
                    compare(tc_update, [got[k] for k in sorted(got)],
                            [want[k] for k in sorted(want)])
    for (h, block, dtype, cases) in (
            (TC_SMALL_PLANE, 16, torch.int8,
             [("black", 0, SEED), ("white", 2 ** 32 - 1, 2 ** 40 + 11)]),
            (TC_SMALL_PLANE, 64, torch.int8,
             [("black", 2 ** 31, 12345), ("white", 7, SEED)]),
            (TC_SMALL_PLANE, 16, torch.bfloat16,
             [("black", 3, SEED), ("white", 2 ** 31 - 1, SEED)]),
            (TC_SMALL_PLANE, 64, torch.bfloat16,
             [("black", 2 ** 32 - 2, 2 ** 35 + 1), ("white", 5, SEED)]),
            (tc_plane[0], TC_BLOCK, torch.int8,
             [("black", 2, SEED), ("white", 2 ** 32 - 1, SEED)])):
        for color, offset, seed in cases:
            planes = tc_random_planes(torch, h, dtype, offset + h + block)
            want, plain_ms = plain_timed(lambda: plains[tc_update](
                planes, color, tc_beta, seed=seed, offset=offset,
                block=block))
            got = wrappers[tc_update](
                {k: v.clone() for k, v in planes.items()}, color, tc_beta,
                seed=seed, offset=offset, block=block)
            torch.cuda.synchronize()
            compare(tc_update, [got[k] for k in sorted(got)],
                    [want[k] for k in sorted(want)],
                    plain_ms if h == tc_plane[0] else None)
            del planes, want, got
    # the persistent grid: a plane whose tiles are not a multiple of the
    # grid's blocks; both colours at block 128 on a 512^2 lattice; a hot
    # table (inverse temperature 0: every entry 1, nearly every spin
    # flips) and the cold one from all-up planes (no spin flips); every
    # tile the kernel takes, each on planes whose largest tile it is
    ragged = kernel_geometry(TC_RAGGED[0], TC_RAGGED[1])
    check(ragged["tiles"] > ragged["blocks"]
          and ragged["tiles"] % ragged["blocks"] != 0,
          f"tensorcore: {TC_RAGGED} planes have {ragged} tiles and blocks")
    tc_cases = [(TC_RAGGED, 64, torch.int8, color, tc_beta, False)
                for color in ("black", "white")]
    tc_cases += [((SMALL_N // 2,) * 2, TC_BLOCK, dtype, color, beta, up)
                 for dtype in (torch.int8, torch.bfloat16)
                 for color in ("black", "white")
                 for beta, up in ((tc_beta, False), (0.0, False),
                                  (1.0 / TC_COLD_T, True))]
    for tile, shape in TC_TILE_PLANES:
        geometry = kernel_geometry(*shape)
        check((geometry["tile_rows"], geometry["tile_cols"]) == tile,
              f"tensorcore: {shape} planes take {geometry}, not {tile}")
        tc_cases.append((shape, 16, torch.int8, "white", tc_beta, False))
    for shape, block, dtype, color, beta, up in tc_cases:
        planes = tc_random_planes(torch, shape[0], dtype, shape[1] + block,
                                  shape[1])
        if up:
            planes = {k: v.abs() for k, v in planes.items()}
        want = plains[tc_update](planes, color, beta, seed=SEED,
                                 offset=2 ** 32 - 1, block=block)
        got = wrappers[tc_update]({k: v.clone() for k, v in planes.items()},
                                  color, beta, seed=SEED, offset=2 ** 32 - 1,
                                  block=block)
        torch.cuda.synchronize()
        compare(tc_update, [got[k] for k in sorted(got)],
                [want[k] for k in sorted(want)])
        flipped = sum(int((got[k] != planes[k]).sum()) for k in got)
        if beta == 0.0:
            # p = 1 flips every draw but the top 2^-25 of them
            check(flipped > 0.999 * 2 * planes["00"].numel(),
                  "tensorcore: a hot table left spins unflipped")
        if up:
            check(flipped == 0,
                  "tensorcore: a cold table flipped an aligned spin")
        del planes, want, got
    print(f"phase 3: {tc_update}: {TC_RAGGED} planes: tile "
          f"{ragged['tile_rows']} x {ragged['tile_cols']}, {ragged['tiles']} "
          f"tiles on {ragged['blocks']} blocks; hot and cold tables, every "
          f"tile of {[t for t, _ in TC_TILE_PLANES]} checked")
    planes = tc_random_planes(torch, 64, torch.int8, 1)
    before = wrappers[tc_update].launches
    try:
        wrappers[tc_update](planes, "black", tc_beta, block=8)
        raised = False
    except ValueError:
        raised = True
    check(raised and wrappers[tc_update].launches == before,
          "tensorcore_update took a block of 8 on the card")
    cases, bad, err, _ = stats[tc_update]
    print(f"phase 3: {tc_update}: {cases} plane comparisons with the plain "
          f"version, {bad} mismatches, max abs err {err}; block 8 raises")
    check(bad == 0, f"{tc_update} disagrees with its plain version")
    tc_geometry = kernel_geometry(*tc_plane)
    PIPE_OPS["tensorcore"]["tensor"] = tensorcore_flop_per_position(
        tc_geometry["tile_rows"], tc_geometry["tile_cols"])
    planes = tc_random_planes(torch, tc_plane[0], torch.int8, 2)
    kernel_ms[tc_update] = timed_ms(lambda: wrappers[tc_update](
        planes, "black", tc_beta, seed=SEED, offset=0, block=TC_BLOCK),
        reps=20)
    print(f"phase 3: tensorcore: ms per full sweep of a {FULL_N}^2 lattice "
          f"(planes {tc_plane[0]}^2, block {TC_BLOCK}, the kernel's tile "
          f"{tc_geometry['tile_rows']} x {tc_geometry['tile_cols']}, "
          f"{tc_geometry['tiles']} tiles on {tc_geometry['blocks']} blocks): "
          f"{2 * kernel_ms[tc_update]:.4f}; plain version "
          f"{stats[tc_update][3]:.1f} ms per half-sweep; bound: SM clocks "
          f"per position {clocks_per_element('tensorcore'):.6f} (ops by "
          f"pipe {PIPE_OPS['tensorcore']})")
    del planes
    full_plane["tensorcore"] = tc_plane

    # the shard kernels on whole extended planes: random planes with
    # random index planes (lanes 0..5: 4 and 5 take lane 3), then the
    # driver's own wrapped index planes of 2 x 2 shards at 512^2 (k = 1,
    # 2, 3) and at the main path's full size; the time of each kernel at
    # the main path's shard
    gen = torch.Generator(device="cuda").manual_seed(7)
    shard_plans, shard_shape = {}, {}
    for family in ("stencil", "multispin", "bitplane"):
        fn = full_plane[family][0]
        name = f"{family}_shard_sweeps"
        table = tables[family]
        divisor = resident.GEOMETRY[family].col_divisor

        def random_index(shape):
            index = [torch.randint(-2 ** 31, 2 ** 31 - 1, shape, generator=gen,
                                   device="cuda", dtype=torch.int32)]
            if family == "bitplane":
                index.append(torch.randint(0, 6, shape, generator=gen,
                                           device="cuda", dtype=torch.int32))
            return index

        def mixed_groups(n, w):
            """Index planes of 4-word Philox groups (lanes 0..3), some
            broken: a lane past 3, a group of two gidx, lanes out of
            order."""
            cols = torch.arange(w, device="cuda")
            g = (torch.arange(n, device="cuda")[:, None] * 1000
                 + cols[None, :] // 4)
            ln = (cols % 4).expand(n, w).clone()
            ln[3, 8], g[5, 13] = 7, g[5, 13] + 1
            ln[9, 20:24] = torch.tensor([1, 0, 2, 3], device="cuda")
            return [g.to(torch.int32), ln.to(torch.int32)]

        def driver_index(n, k, i):
            """The plan of ``MESH`` at ``n``^2 (k pinned unless None) and
            shard ``i``'s index planes."""
            pin = {} if k is None else {"k_cap": k, "max_overlap": 100.0}
            plan = shard_planner.plan_shard_resident(family, n, n, *MESH,
                                                     **pin)
            check(plan is not None and k in (None, plan.k),
                  f"{family}: no {MESH} shard plan at {n}^2, k = {k}")
            grid = distributed.ShardGrid.of(
                make_mesh(MESH, ("data", "model")), n, n // divisor)
            return plan, shard_driver.index_planes(plan, grid, i)

        cases = [((14, 10), 1, random_index((14, 10)), None),
                 ((14, 10), 3, random_index((14, 10)), None),
                 ((40, 36), 2, random_index((40, 36)), (16, 8, 128))]
        for k, i in ((1, 0), (2, 3), (3, 1)):
            plan, index = driver_index(SMALL_N, k, i)
            ext = (plan.n_loc + 2 * plan.halo, plan.w_loc + 2 * plan.halo)
            cases.append((ext, k, index,
                          (plan.tile_rows, plan.tile_cols, plan.threads)))
        for shape, n_sweeps, case_tile in {
                "stencil": STENCIL_SHARD_EDGE_CASES,
                "multispin": MULTISPIN_SHARD_EDGE_CASES}.get(family, ()):
            cases.append((shape, n_sweeps, random_index(shape), case_tile))
        if family == "bitplane":
            # extended widths that are not whole groups; groups of which
            # some are one Philox group and some not
            for shape, n_sweeps, case_tile in (((30, 41), 2, (12, 20, 64)),
                                               ((22, 7), 3, (8, 4, 128))):
                cases.append((shape, n_sweeps, random_index(shape),
                              case_tile))
            cases.append(((40, 72), 2, mixed_groups(40, 72), (16, 16, 256)))
            # both accepts, on random and on mixed index planes
            for (shape, n_sweeps, case_tile), (accept, thr) in [
                    (case, table) for case in BITPLANE_ACCEPT_SHARD_CASES
                    for table in bitplane_accept_tables().items()]:
                b, w = random_planes(family, *shape, shape[1] + n_sweeps)
                for index in [random_index(shape)] + (
                        [mixed_groups(*shape)] if shape[1] >= 24 else []):
                    check_accept(name, accept, lambda: wrappers[name](
                        b, w, thr, *index, n_sweeps=n_sweeps, seed=SEED,
                        start_offset=2 ** 32 - 3, tile=case_tile),
                        lambda: plains[name](
                            b, w, thr, *index, n_sweeps=n_sweeps, seed=SEED,
                            start_offset=2 ** 32 - 3))
        plan, index = driver_index(fn, None, 3)
        shard_plans[family] = plan
        ext = shard_shape[family] = (plan.n_loc + 2 * plan.halo,
                                     plan.w_loc + 2 * plan.halo)
        tile = (plan.tile_rows, plan.tile_cols, plan.threads)
        cases.append((ext, plan.k, index, tile))
        for shape, n_sweeps, index, case_tile in cases:
            b, w = random_planes(family, *shape, shape[0] + n_sweeps)
            want, plain_ms = plain_timed(lambda: plains[name](
                b, w, table, *index, n_sweeps=n_sweeps, seed=SEED,
                start_offset=2 ** 32 - 3))
            got = wrappers[name](b, w, table, *index, n_sweeps=n_sweeps,
                                 seed=SEED, start_offset=2 ** 32 - 3,
                                 tile=case_tile)
            torch.cuda.synchronize()
            compare(name, got, want, plain_ms if shape == ext else None)
            del b, w, want, got
        up, cold = cold_all_up(family, 40)
        got = wrappers[name](
            up, up.clone(), cold, *random_index(tuple(up.shape)),
            n_sweeps=3, seed=SEED, start_offset=2 ** 32 - 3,
            tile=(16, 120, 256) if family == "stencil" else (16, 12, 64))
        torch.cuda.synchronize()
        compare(name, got, (up, up))
        del up, got
        cases, bad, err, _ = stats[name]
        print(f"phase 3: {name}: {cases} plane comparisons with the plain "
              f"version, {bad} mismatches, max abs err {err}")
        check(bad == 0, f"{name} disagrees with its plain version")
        b, w = random_planes(family, *ext, 1)
        kernel_ms[name] = timed_ms(lambda: wrappers[name](
            b, w, table, *index, n_sweeps=plan.k, seed=SEED, start_offset=0,
            tile=tile), reps=8)
        print(f"phase 3: {name}: {kernel_ms[name]:.4f} ms per launch "
              f"({plan.k} sweeps) at the {ext[0]} x {ext[1]} extended shard "
              f"of a {MESH[0]} x {MESH[1]} mesh of {fn}^2 (tile {tile[0]} x "
              f"{tile[1]}, {tile[2]} threads, {plan.smem_bytes} B shared); "
              f"x {MESH[0] * MESH[1]} shards per {plan.k} sweeps: "
              f"{MESH[0] * MESH[1] * kernel_ms[name] / plan.k:.4f} ms per "
              f"sweep; plain version {stats[name][3]:.1f} ms")
        del b, w, index
    for name in ("bitplane_update", "bitplane_sweeps_resident",
                 "bitplane_shard_sweeps"):
        tallies = accept_stats[name]
        print(f"phase 3: {name}: " + "; ".join(
            f"{accept} accept {n} plane comparisons, {bad} mismatches"
            for accept, (n, bad) in tallies.items()))
        check(all(n > 0 and bad == 0 for n, bad in tallies.values())
              and {"three", "general"} <= set(tallies),
              f"{name}: an accept was not held against the plain version")

    # the six kernels' member axis: B = 3 members of distinct
    # temperatures and seeds in one launch against the plain batched
    # version (each member's single-member plain version), at the small
    # and ragged shapes, n_sweeps 1 to 3 and an odd tile grid; bitplane
    # with a batch of a shuffled table and ferromagnet tables, which
    # takes the general accept; then one comparison and the times at the
    # ensemble main path's shape (16 members, 2^30 sites or 2^33
    # replica-sites)
    batched = {}
    ensemble_shape = {}
    for family in ("stencil", "multispin", "bitplane"):
        fn, fh = full_plane[family]
        pkg = importlib.import_module(f"repro_torch.kernels.{family}")
        update = f"{family}_update"
        sweeps = f"{family}_sweeps_resident"
        for name in (update, sweeps):
            batched[name] = {"comparisons": 0, "mismatches": 0,
                             "max_abs_err": 0, "by_accept": {}}

        def compare_batched(name, got, want, accept="three"):
            s = batched[name]
            for a, b in zip(got, want):
                s["comparisons"] += 1
                bad = int((a != b).sum())
                s["mismatches"] += bad
                s["max_abs_err"] = max(s["max_abs_err"], int(
                    (a.to(torch.int64) - b.to(torch.int64)).abs().max()))
                tally = s["by_accept"].setdefault(accept, [0, 0])
                tally[0] += 1
                tally[1] += bad

        def launch_batched(name, accept, fn):
            """``fn()`` (a batched kernel call); each of its launches
            must take the accept of its tables."""
            wrapper = wrappers[name]
            before = (wrapper.launches,
                      getattr(wrapper, "general_launches", 0))
            got = fn()
            torch.cuda.synchronize()
            launched = wrapper.launches - before[0]
            general = getattr(wrapper, "general_launches", 0) - before[1]
            check(launched >= 1 and general == (
                launched if accept == "general" else 0),
                f"{name}: {general} of {launched} batched launches took "
                f"the general accept for {accept} tables")
            return got

        table_sets = {"three": member_tables(family, CHECK_TEMPS)}
        if family == "bitplane":
            table_sets["general"] = [bitplane_accept_tables()["general"]] \
                + table_sets["three"][1:]
        small_h = SMALL_N * fh // fn
        ragged_h = 12 if family == "bitplane" else 7
        small_plan = resident.plan_resident(family, SMALL_N, SMALL_N)
        col_unit = resident.GEOMETRY[family].col_align
        divisor = resident.GEOMETRY[family].col_divisor
        n, h, tr, tc, k, n_sweeps = BATCHED_EDGE_CASES[family]
        sweep_cases = [
            (SMALL_N, small_h, dataclasses.replace(small_plan, k=1), 1),
            (SMALL_N, small_h, dataclasses.replace(small_plan, k=3), 3),
            (SMALL_N, small_h, dataclasses.replace(
                small_plan, k=2, tile_rows=48, tile_cols=10 * col_unit), 2),
            (30, ragged_h, dataclasses.replace(
                small_plan, n=30, m=ragged_h * divisor, k=3, tile_rows=7,
                tile_cols=2 * col_unit), 3),
            (n, h, dataclasses.replace(small_plan, n=n, m=h * divisor, k=k,
                                       tile_rows=tr, tile_cols=tc),
             n_sweeps)]
        for accept, tabs in table_sets.items():
            for n, h in ((SMALL_N, small_h), (30, ragged_h)):
                for is_black, offset in ((True, 2 ** 31 - 1),
                                         (False, 2 ** 32 - 1)):
                    t, o = random_batch(family, 3, n, h, n + h)
                    want = getattr(pkg, f"{update}_batched_plain")(
                        t, o, tabs, is_black=is_black, seeds=CHECK_SEEDS,
                        offset=offset)
                    got = launch_batched(update, accept, lambda: getattr(
                        pkg, f"{update}_batched")(
                            t.clone(), o, tabs, is_black=is_black,
                            seeds=CHECK_SEEDS, offset=offset))
                    compare_batched(update, [got], [want], accept)
            for n, h, plan, n_sweeps in sweep_cases:
                b, w = random_batch(family, 3, n, h, n + n_sweeps)
                want = getattr(pkg, f"{sweeps}_batched_plain")(
                    b, w, tabs, n_sweeps=n_sweeps, seeds=CHECK_SEEDS,
                    start_offset=2 ** 32 - 3)
                got = launch_batched(sweeps, accept, lambda: getattr(
                    pkg, f"{sweeps}_batched")(
                        b, w, tabs, n_sweeps=n_sweeps, seeds=CHECK_SEEDS,
                        start_offset=2 ** 32 - 3, plan=plan))
                compare_batched(sweeps, got, want, accept)
            # one member over the library's limit: the launches split
            # into a full one and a trailing member (the single-member
            # instance), ceil(B / limit) launches a block
            limit = member_limit(family)
            over = limit + 1
            over_tabs = [tabs[i % len(tabs)] for i in range(over)]
            over_tabs[-1] = tabs[0]
            over_seeds = CHECK_SEEDS + tuple(range(100, 97 + over))
            n, h, plan, _ = sweep_cases[3]
            n_sweeps = 2 * plan.k - 1
            t, o = random_batch(family, over, n, h, over)
            want = getattr(pkg, f"{update}_batched_plain")(
                t, o, over_tabs, is_black=False, seeds=over_seeds,
                offset=2 ** 32 - 1)
            before = wrappers[update].launches
            got = launch_batched(update, accept, lambda: getattr(
                pkg, f"{update}_batched")(
                    t.clone(), o, over_tabs, is_black=False,
                    seeds=over_seeds, offset=2 ** 32 - 1))
            update_launches = wrappers[update].launches - before
            compare_batched(update, [got], [want], accept)
            want = getattr(pkg, f"{sweeps}_batched_plain")(
                t, o, over_tabs, n_sweeps=n_sweeps, seeds=over_seeds,
                start_offset=2 ** 32 - 3)
            before = wrappers[sweeps].launches
            got = launch_batched(sweeps, accept, lambda: getattr(
                pkg, f"{sweeps}_batched")(
                    t, o, over_tabs, n_sweeps=n_sweeps, seeds=over_seeds,
                    start_offset=2 ** 32 - 3, plan=plan))
            sweep_launches = wrappers[sweeps].launches - before
            compare_batched(sweeps, got, want, accept)
            print(f"phase 3: {family} {accept}: {over} members (the limit "
                  f"{limit} + 1) of {n} x {h}: {update_launches} launches "
                  f"of {update}, {sweep_launches} of {sweeps} for "
                  f"{n_sweeps} sweeps at k = {plan.k}; mismatches so far "
                  f"{batched[update]['mismatches']}, "
                  f"{batched[sweeps]['mismatches']}")
            check(update_launches == 2 and sweep_launches == 4,
                  f"{family}: {over} members took {update_launches} and "
                  f"{sweep_launches} launches, not 2 and 4")
        del t, o, b, w, want, got
        # the ensemble main path's shape and tables
        en, batch = ensemble_batch(family)
        seeds = batch.member_seeds
        tabs = member_tables(family, batch.member_temperatures)
        eh = en * fh // fn
        ensemble_shape[family] = (batch.size, en, eh)
        plan = resident.plan_resident(family, en, en)
        b, w = random_batch(family, batch.size, en, eh, 11)
        want, plain_ms = plain_timed(lambda: getattr(
            pkg, f"{update}_batched_plain")(
                b, w, tabs, is_black=True, seeds=seeds, offset=5))
        got = launch_batched(update, "three", lambda: getattr(
            pkg, f"{update}_batched")(b.clone(), w, tabs, is_black=True,
                                      seeds=seeds, offset=5))
        compare_batched(update, [got], [want])
        batched[update]["plain_ms"] = plain_ms
        del want, got
        want, plain_ms = plain_timed(lambda: getattr(
            pkg, f"{sweeps}_batched_plain")(
                b, w, tabs, n_sweeps=plan.k, seeds=seeds, start_offset=6))
        got = launch_batched(sweeps, "three", lambda: getattr(
            pkg, f"{sweeps}_batched")(b, w, tabs, n_sweeps=plan.k,
                                      seeds=seeds, start_offset=6,
                                      plan=plan))
        compare_batched(sweeps, got, want)
        batched[sweeps]["plain_ms"] = plain_ms
        del want, got
        batched[update]["ms"] = timed_ms(lambda: getattr(
            pkg, f"{update}_batched")(b, w, tabs, is_black=True, seeds=seeds,
                                      offset=0), reps=20)
        batched[sweeps]["ms"] = timed_ms(lambda: getattr(
            pkg, f"{sweeps}_batched")(b, w, tabs, n_sweeps=plan.k,
                                      seeds=seeds, start_offset=0,
                                      plan=plan), reps=8)
        batched[sweeps]["n_sweeps"] = plan.k
        del b, w
        for name in (update, sweeps):
            s = batched[name]
            print(f"phase 3: {name} batched: {s['comparisons']} plane "
                  f"comparisons with the plain batched version (3 members, "
                  f"and {ensemble_shape[family][0]} at "
                  f"{ensemble_shape[family]}), "
                  f"{s['mismatches']} mismatches, max abs err "
                  f"{s['max_abs_err']}, by accept {s['by_accept']}; "
                  f"{s['ms']:.4f} ms a launch at {ensemble_shape[family]}, "
                  f"plain {s['plain_ms']:.1f}")
            check(s["mismatches"] == 0,
                  f"{name}: the member axis disagrees with the plain "
                  f"batched version")
        if family == "bitplane":
            check({"three", "general"} <= set(batched[sweeps]["by_accept"]),
                  "bitplane: an accept of the member axis was not held")

    # philox_fill, the draws of the engines of plain updates: float32
    # uniforms against the plain version's, 0 mismatches; row-major
    # planes and index planes (random int32, and a 3D slab's global
    # positions), 16 members, the streams' lanes, then the main path's
    # plane, timed beside torch.rand (another function: a note)
    fill = "philox_fill"
    fill_stats = stats[fill]

    def compare_fill(got, want, plain_ms=None):
        fill_stats[0] += got.shape[0] * got.shape[1]
        fill_stats[1] += int((got != want).sum())
        fill_stats[2] = max(fill_stats[2],
                            float((got - want).abs().max()))
        if plain_ms is not None:
            fill_stats[3] = plain_ms

    for members, shape, offset, c1, c3, lanes in FILL_CASES:
        seeds = list(FILL_SEEDS[:members])
        kw = dict(c1=c1, c3=c3, lanes=lanes)
        if shape is None and members == 1:
            # slab 3 of a 32 x 16 x 16 lattice: global flat positions, int64
            kw["index"] = (torch.arange(8 * 16 * 16, device="cuda")
                           + 3 * 8 * 16 * 16).reshape(8, 16, 16)
        elif shape is None:
            kw["index"] = torch.randint(-2 ** 31, 2 ** 31 - 1,
                                        FILL_INDEX_SHAPE, generator=gen,
                                        device="cuda", dtype=torch.int32)
        else:
            kw.update(shape=shape, device="cuda")
        got = wrappers[fill](seeds, offset, **kw)
        torch.cuda.synchronize()
        compare_fill(got, plains[fill](seeds, offset, **kw))
        del got
    want, plain_ms = plain_timed(lambda: plains[fill](
        [SEED], 2 ** 32 - 1, shape=FILL_SHAPE, device="cuda"))
    got = wrappers[fill]([SEED], 2 ** 32 - 1, shape=FILL_SHAPE,
                         device="cuda")
    torch.cuda.synchronize()
    compare_fill(got, want, plain_ms)
    del want, got
    kernel_ms[fill] = timed_ms(lambda: wrappers[fill](
        [SEED], 0, shape=FILL_SHAPE, device="cuda"), reps=20)
    rand_ms = timed_ms(lambda: torch.rand(FILL_SHAPE, device="cuda"),
                       reps=20)
    print(f"phase 3: {fill}: {fill_stats[0]} plane comparisons with the "
          f"plain version (lanes 1 and 2, c1 0, 2, 3, B up to 16, index "
          f"planes), {fill_stats[1]} mismatches, max abs err "
          f"{fill_stats[2]}; {kernel_ms[fill]:.4f} ms a launch at "
          f"{FILL_SHAPE} (lane 0), plain version {plain_ms:.1f} ms; "
          f"torch.rand of that shape (another function) {rand_ms:.4f} ms")
    check(fill_stats[1] == 0, f"{fill} disagrees with its plain version")
    phase_s[3] = time.perf_counter() - t0

    # bounds at the full plane: bytes of each input read once and each
    # output written once; the k-sweep kernels' useful half-sweeps only
    bounds = {}
    for family, (fn, fh) in full_plane.items():
        elements = fn * fh
        if family == "tensorcore":
            # a and b read once, the two targets read and written
            bounds[tc_update] = bound(family, 6 * elements, elements,
                                      sm_clocks_per_s)
            continue
        size = 1 if family == "stencil" else 4
        bounds[f"{family}_update"] = bound(family, 3 * size * elements,
                                           elements, sm_clocks_per_s)
        bounds[f"{family}_sweeps_resident"] = bound(
            family, 4 * size * elements, 2 * plans[family].k * elements,
            sm_clocks_per_s)
        # a shard kernel updates its whole extended plane 2k times and
        # reads its index planes once
        en, ew = shard_shape[family]
        bounds[f"{family}_shard_sweeps"] = bound(
            family, (4 * size + SHARD_INDEX_BYTES[family]) * en * ew,
            2 * shard_plans[family].k * en * ew, sm_clocks_per_s)
        # the member axis at the ensemble shape: B members' bytes and
        # updates (the single bound of one member's planes times B)
        members, mn, mh = ensemble_shape[family]
        elements = members * mn * mh
        batched[f"{family}_update"]["bound"] = bound(
            family, 3 * size * elements, elements, sm_clocks_per_s)
        batched[f"{family}_sweeps_resident"]["bound"] = bound(
            family, 4 * size * elements,
            2 * batched[f"{family}_sweeps_resident"]["n_sweeps"] * elements,
            sm_clocks_per_s)

    # philox_fill writes its float32 lane-0 plane and reads nothing
    elements = FILL_SHAPE[0] * FILL_SHAPE[1]
    bounds[fill] = bound("draws", 4 * elements, elements, sm_clocks_per_s)
    full_plane["draws"] = FILL_SHAPE

    # -- 4. Session at 512^2, both tiers and the CPU -----------------------
    t0 = time.perf_counter()
    launches_by_path = {}

    def drive(path, family, tier, fn):
        """Run one Session path with every launch count set to 0 just
        before it and read just after it; the path must launch the
        kernel of its tier and no other (``family=None``: no kernel), a
        bitplane kernel with the three-threshold accept only (a Session's
        table has a ferromagnet's layout)."""
        for wrapper in wrappers.values():
            wrapper.launches = 0
            if hasattr(wrapper, "general_launches"):
                wrapper.general_launches = 0
        out = fn()
        torch.cuda.synchronize()
        counts = {name: wrapper.launches
                  for name, wrapper in wrappers.items()}
        launches_by_path[path] = counts
        general = {name: wrapper.general_launches
                   for name, wrapper in wrappers.items()
                   if hasattr(wrapper, "general_launches")}
        print(f"launches on path {path!r}: {counts}; of them with the "
              f"general accept {general}")
        for name, count in counts.items():
            check((count > 0) == (KERNELS[name][:2] == (family, tier)),
                  f"path {path!r} launched {name} {count} times")
        check(not any(general.values()),
              f"path {path!r} launched the general bitplane accept")
        return out

    def budget(tier):
        return 0 if tier == "half-sweep" else None

    from repro_torch.analysis import measure as measuring
    #: measure() through the graph and through the loop, by path
    graph_rows = {}

    def graph_measure(session, plan=None):
        """Host copies of the planes, then ``session.measure()``, its
        observables one captured graph, timed on the host clock to the
        samples on the host; its replays (``DISPATCHES``), the graph's
        capture and instantiation seconds, and the device memory it took
        above what was allocated when it started."""
        before = [p.cpu() for p in session.state]
        step = session.step_count
        torch.cuda.synchronize()
        path_peak = torch.cuda.max_memory_allocated()
        start = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        replays = measuring.DISPATCHES
        t1 = time.perf_counter()
        traj = session.measure(plan)
        seconds = time.perf_counter() - t1
        peak = torch.cuda.max_memory_allocated()
        return {"before": before, "step": step, "plan": plan, "traj": traj,
                "seconds": seconds,
                "replays": measuring.DISPATCHES - replays,
                "stats": dict(measuring.GRAPH_STATS),
                "extra_bytes": peak - start,
                "path_peak": max(path_peak, peak)}

    def loop_against_graph(phase, path, family, tier, session, graph):
        """The plan of ``graph`` (a :func:`graph_measure` of ``session``)
        as the loop of launches on the card, from the planes it started
        from, driven as its own path: its samples and final planes must be
        the graph's, and the graph replayed once a sample after the
        first."""
        runner = session._runner
        plan = graph["plan"] or session.spec.sweep.plan()
        states = tuple(p.to("cuda") for p in graph["before"])
        del graph["before"]
        torch.cuda.synchronize()
        start = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()

        def loop():
            t1 = time.perf_counter()
            if session.mode == "ensemble":
                out = measuring.measure_scan_batched(
                    runner.engine, states, runner.inv_temps, runner.seeds,
                    plan, graph["step"], loop=True)
            else:
                out = measuring.measure_scan(runner.engine, states, plan,
                                             graph["step"], loop=True)
            return out[0], out[1], time.perf_counter() - t1

        final, want, loop_s = drive(f"{path} as the loop", family, tier,
                                    loop)
        extra = torch.cuda.max_memory_allocated() - start
        traj = graph["traj"]
        same = all(np.array_equal(traj[k], want[k]) for k in traj) and all(
            torch.equal(a, b) for a, b in zip(session.state, final))
        stats = graph["stats"]
        row = {"samples": plan.n_measure, "sweeps": plan.total_sweeps,
               "graph_s": graph["seconds"], "loop_s": loop_s,
               "replays": graph["replays"], "equal": same,
               "graph_extra_bytes": graph["extra_bytes"],
               "loop_extra_bytes": extra, **stats}
        graph_rows[path] = row
        print(f"phase {phase}: {path} of {plan.n_measure} "
              f"samples ({plan.total_sweeps} sweeps): graph "
              f"{graph['seconds']:.4f} s (capture {stats['capture_s']:.4f}, "
              f"instantiate {stats['instantiate_s']}; {graph['replays']} "
              f"replays; {graph['extra_bytes']} B above the planes) against "
              f"the loop {loop_s:.4f} s ({extra} B): "
              f"{loop_s / graph['seconds']:.2f}x; samples and final planes "
              f"equal: {same}")
        check(graph["replays"] == plan.n_measure - 1,
              f"{path}: {graph['replays']} graph replays in one measure() "
              f"of {plan.n_measure} samples")
        check(same, f"{path}: the graph's samples or planes are not the "
              f"loop's")
        del final, states

    def restore_continue(spec):
        """20 sweeps, save and restore, then 30 sweeps and a measure plan
        on both: the uninterrupted and the restored session."""
        s = Session.open(spec)
        s.run(20)
        with tempfile.TemporaryDirectory() as tmp:
            ckpt = str(Path(tmp) / "ckpt.npz")
            s.save(ckpt)
            r = Session.restore(ckpt)
        plan = SweepSpec(measure_every=3, n_measure=4).plan()
        s.run(30)
        r.run(30)
        return s, s.measure(plan), r, r.measure(plan)

    def check_restore_continue(engine, s, traj, r, traj_r):
        print(f"phase 4: {engine} restore-continue digest "
              f"{r.state_digest()}, uninterrupted {s.state_digest()}")
        check(r.state_digest() == s.state_digest()
              and all((traj[k] == traj_r[k]).all() for k in traj),
              f"{engine}: restore-continue differs from the uninterrupted "
              f"run")

    small_digests = {}
    for engine, family in ENGINE_FAMILY.items():
        small = RunSpec(lattice=LatticeSpec(SMALL_N, SMALL_N, init_p_up=0.5),
                        engine=EngineSpec(engine), temperature=2.2,
                        seed=SEED)
        s = Session.open(small, device="cpu")
        s.run(50)
        digests = {"cpu": s.state_digest()}
        small_digests[engine] = digests["cpu"]
        for tier in ("k-sweep", "half-sweep"):
            def small_run():
                s = Session.open(small, resident_budget_bytes=budget(tier))
                check((s.engine.resident_plan is not None)
                      == (tier == "k-sweep"),
                      f"{engine} {SMALL_N}^2 did not plan the {tier} tier")
                s.run(50)
                return s
            digests[tier] = drive(f"{engine} {SMALL_N}^2 {tier}", family,
                                  tier, small_run).state_digest()
        print(f"phase 4: {engine} {SMALL_N}^2, 50 sweeps, digests {digests}")
        check(len(set(digests.values())) == 1, f"{engine}: tiers disagree")

        check_restore_continue(engine, *drive(
            f"{engine} {SMALL_N}^2 save, restore, measure", family,
            "k-sweep", lambda: restore_continue(small)))

    # tensorcore: one tier (two launches a sweep), block 64
    small = RunSpec(lattice=LatticeSpec(SMALL_N, SMALL_N, init_p_up=0.5),
                    engine=EngineSpec("tensorcore", {"tc_block": 64}),
                    temperature=2.2, seed=SEED)
    s = Session.open(small, device="cpu")
    s.run(50)
    digests = {"cpu": s.state_digest()}

    def small_tc_run():
        s = Session.open(small)
        s.run(50)
        return s

    digests["card"] = drive(f"tensorcore {SMALL_N}^2", "tensorcore",
                            "half-sweep", small_tc_run).state_digest()
    print(f"phase 4: tensorcore {SMALL_N}^2 block 64, 50 sweeps, digests "
          f"{digests}")
    check(len(set(digests.values())) == 1,
          "tensorcore: the card and the CPU disagree")
    check_restore_continue("tensorcore", *drive(
        f"tensorcore {SMALL_N}^2 save, restore, measure", "tensorcore",
        "half-sweep", lambda: restore_continue(small)))

    # sharded sessions at 512^2: every one must give the single-mode
    # digest after 50 sweeps
    def mesh_spec(shape):
        return MeshSpec(shape, tuple(f"ax{i}" for i in range(len(shape))))

    def sharded(spec, shape, resident, sweeps=50, **kw):
        """A fresh session of ``spec`` on a ``shape`` mesh, ``sweeps``
        sweeps; ``resident``: it must plan the sharded resident tier."""
        s = Session.open(dataclasses.replace(spec, mesh=mesh_spec(shape)),
                         **kw)
        check((s.shard_plan is not None) == resident,
              f"{spec.engine.name} on {shape}: shard plan {s.shard_plan}")
        s.run(sweeps)
        return s

    def check_digest(path, got, want):
        print(f"phase 4: {path}: digest {got} (single mode {want})")
        check(got == want, f"{path}: not the single-mode digest")

    with tempfile.TemporaryDirectory() as tmp:
        for engine, family in ENGINE_FAMILY.items():
            small = RunSpec(lattice=LatticeSpec(SMALL_N, SMALL_N,
                                                init_p_up=0.5),
                            engine=EngineSpec(engine), temperature=2.2,
                            seed=SEED)
            want = small_digests[engine]
            for shape in SMALL_MESHES:
                path = f"{engine} {SMALL_N}^2 mesh {shape}"
                s = drive(path, family, "shard",
                          lambda: sharded(small, shape, True))
                check_digest(path, s.state_digest(), want)
            # save on (2, 2); restore on (4, 1) and in single mode
            ckpt = str(Path(tmp) / f"{engine}-mesh.npz")
            path = f"{engine} {SMALL_N}^2 mesh (2, 2) save, (4, 1) restore"

            def save_restore():
                sharded(small, (2, 2), True, sweeps=20).save(ckpt)
                r = Session.restore(ckpt, mesh=mesh_spec((4, 1)))
                r.run(30)
                return r
            check_digest(path, drive(path, family, "shard", save_restore)
                         .state_digest(), want)
            path = f"{engine} {SMALL_N}^2 mesh (2, 2) checkpoint, single mode"

            def restore_single():
                r = Session.restore(ckpt, mesh=None)
                r.run(30)
                return r
            check_digest(path, drive(path, family, "k-sweep", restore_single)
                         .state_digest(), want)
            # a single-mode checkpoint (the JAX package's layout) on a mesh
            single_ckpt = str(Path(tmp) / f"{engine}-single.npz")

            def single_save():
                s = Session.open(small)
                s.run(20)
                s.save(single_ckpt)
            drive(f"{engine} {SMALL_N}^2 single mode save", family,
                  "k-sweep", single_save)
            path = f"{engine} {SMALL_N}^2 single-mode checkpoint, mesh (2, 2)"

            def restore_mesh():
                r = Session.restore(single_ckpt, mesh=mesh_spec((2, 2)))
                r.run(30)
                return r
            check_digest(path, drive(path, family, "shard", restore_mesh)
                         .state_digest(), want)
    # the per-half-sweep distributed tier: plain PyTorch, no kernel but
    # the "basic" step's draws (philox_fill, once a shard a half-sweep)
    for engine, budget_bytes in (("multispin", None), ("bitplane", None),
                                 ("stencil_pallas", 0)):
        small = RunSpec(lattice=LatticeSpec(SMALL_N, SMALL_N, init_p_up=0.5),
                        engine=EngineSpec(engine), temperature=2.2, seed=SEED)
        path = (f"{engine} {SMALL_N}^2 mesh (2, 2) per-half-sweep"
                + (" (no shard plan)" if budget_bytes == 0 else ""))
        draws_family = ("draws", "fill") if budget_bytes == 0 \
            else (None, None)
        s = drive(path, *draws_family, lambda: sharded(
            small, (2, 2), False, resident_budget_bytes=budget_bytes))
        check(s.halo_exchanges == 100, f"{path}: {s.halo_exchanges} "
              f"halo exchanges in 50 sweeps, not 100")
        if budget_bytes == 0:
            check(launches_by_path[path][fill] == 4 * 100,
                  f"{path}: {launches_by_path[path][fill]} launches of "
                  f"{fill}, not one a shard a half-sweep")
        check_digest(path, s.state_digest(),
                     small_digests[engine + ("" if "pallas" in engine
                                             else "_pallas")])

    # ensembles at 512^2: 3 members of each counter-based engine, every
    # member's digest the single-mode session's of its (T, seed) on the
    # k-sweep tier, on the per-half-sweep tier and on the CPU, one launch
    # of the member axis a block of sweeps; restore-continue of an
    # ensemble checkpoint the uninterrupted run; rebind to new members a
    # fresh session of the new spec, on the same engine and plan
    small_lattice = LatticeSpec(SMALL_N, SMALL_N, init_p_up=0.5)
    for engine, family in ENSEMBLE_ENGINES.items():
        spec = RunSpec(lattice=small_lattice, engine=EngineSpec(engine),
                       batch=BatchSpec(CHECK_TEMPS, CHECK_SEEDS))

        def single_members():
            out = []
            for t, sd in spec.batch.members:
                s = Session.open(RunSpec(lattice=small_lattice,
                                         engine=EngineSpec(engine),
                                         temperature=t, seed=sd))
                s.run(ENSEMBLE_CHECK_SWEEPS)
                out.append(s.state_digest())
            return out

        want = drive(f"{engine} {SMALL_N}^2 single-mode members", family,
                     "k-sweep", single_members)
        got = {}
        for tier in ("k-sweep", "half-sweep"):
            path = f"{engine} {SMALL_N}^2 ensemble of 3 {tier}"

            def ensemble_run():
                e = Session.open(spec, resident_budget_bytes=budget(tier))
                check(e.mode == "ensemble"
                      and (e.engine.resident_plan is not None)
                      == (tier == "k-sweep"),
                      f"{path}: not an ensemble on the {tier} tier")
                e.run(ENSEMBLE_CHECK_SWEEPS)
                return e

            e = drive(path, family, tier, ensemble_run)
            if tier == "k-sweep":
                name = f"{family}_sweeps_resident"
                blocks = math.ceil(ENSEMBLE_CHECK_SWEEPS
                                   / e.engine.resident_plan.k)
            else:
                name = f"{family}_update"
                blocks = 2 * ENSEMBLE_CHECK_SWEEPS
            check(launches_by_path[path][name] == blocks,
                  f"{path}: {launches_by_path[path][name]} launches of "
                  f"{name}, not {blocks}")
            got[tier] = [e.state_digest(member=i) for i in range(3)]
        e = Session.open(spec, device="cpu")
        e.run(ENSEMBLE_CHECK_SWEEPS)
        got["cpu"] = [e.state_digest(member=i) for i in range(3)]
        print(f"phase 4: {engine} {SMALL_N}^2 ensemble {spec.batch.members},"
              f" {ENSEMBLE_CHECK_SWEEPS} sweeps: member digests {got}, "
              f"single mode {want}")
        check(all(v == want for v in got.values()),
              f"{engine}: an ensemble member is not its single-mode run")
        check_restore_continue(f"{engine} ensemble", *drive(
            f"{engine} {SMALL_N}^2 ensemble save, restore, measure", family,
            "k-sweep", lambda: restore_continue(spec)))
        rebound = dataclasses.replace(spec, batch=BatchSpec(
            (2.2, 2.7, 1.9), (9, 2 ** 32 - 2, 10)))

        def rebind():
            e = Session.open(spec)
            e.run(5)
            engine_obj, plan = e.engine, e.engine.resident_plan
            e._runner.rebind(rebound)
            check(e.engine is engine_obj and e.engine.resident_plan is plan
                  and e.step_count == 0,
                  f"{engine}: rebind made a new engine or plan")
            e._runner.run(ENSEMBLE_CHECK_SWEEPS)
            f = Session.open(rebound)
            f.run(ENSEMBLE_CHECK_SWEEPS)
            return e, f

        e, f = drive(f"{engine} {SMALL_N}^2 ensemble rebind", family,
                     "k-sweep", rebind)
        print(f"phase 4: {engine} rebind to {rebound.batch.members}: "
              f"digest {e.state_digest()}, fresh session "
              f"{f.state_digest()}")
        check(e.state_digest() == f.state_digest(),
              f"{engine}: a rebound ensemble is not a fresh session")
        del e, f
    phase_s[4] = time.perf_counter() - t0

    # -- 5. main paths at full size, on each tier ----------------------------
    t0 = time.perf_counter()
    main_paths, half_paths, peaks, single_rates = {}, {}, {}, {}
    for engine, family in ENGINE_FAMILY.items():
        bitplane = family == "bitplane"
        n = BITPLANE_N if bitplane else FULL_N
        temperature = BITPLANE_TEMPERATURE if bitplane else TEMPERATURE
        # 32 replica lattices per word: replicas that start equal stay
        # equal (shared draws), so the bitplane run starts hot
        spec = RunSpec(lattice=LatticeSpec(n, n,
                                           init_p_up=0.5 if bitplane else 1.0),
                       engine=EngineSpec(engine), temperature=temperature,
                       seed=SEED,
                       sweep=SweepSpec(thermalize=0, measure_every=10,
                                       n_measure=10))
        main_path = main_paths[family] = f"{engine} {n}^2 k-sweep"
        half_path = half_paths[family] = f"{engine} {n}^2 half-sweep"
        spins = n * n * (32 if bitplane else 1)

        def main_run():
            t1 = time.perf_counter()
            session = Session.open(spec)
            torch.cuda.synchronize()
            open_s = time.perf_counter() - t1
            run_ms = timed_ms(lambda: session.run(200), reps=1,
                              warmup=False)
            return session, open_s, run_ms, graph_measure(session)

        torch.cuda.reset_peak_memory_stats()
        session, open_s, run_ms, measured = drive(
            main_path, family, "k-sweep", main_run)
        traj, measure_s = measured["traj"], measured["seconds"]
        if family == "stencil":
            # its planes after run(200) on the host: phase 9's
            # basic_philox must give them
            stencil_after_200 = measured["before"]
        flips_per_ns = single_rates[family] = 200 * spins / (run_ms * 1e6)
        plan = session.engine.resident_plan
        print(f"phase 5: {main_path}: open {open_s:.2f} s; run(200) "
              f"{run_ms:.1f} ms = {flips_per_ns:.2f} flips/ns (k = {plan.k},"
              f" tile {plan.tile_rows} x {plan.tile_cols}); measure() "
              f"{spec.sweep.total_sweeps} sweeps + {spec.sweep.n_measure} "
              f"samples {measure_s:.3f} s")
        if bitplane:
            obs = session.engine.observables(session.state,
                                             session.engine.cfg.inv_temp)
            m, e = obs["m"].cpu(), obs["e"].cpu()
            exact = observables.onsager_energy(temperature)
            diffs = replica_disagreements(torch, session.state)
            print(f"phase 5: {main_path}: per-replica e in "
                  f"[{float(e.min()):.5f}, {float(e.max()):.5f}] (exact "
                  f"{exact:.5f}), max |m| {float(m.abs().max()):.5f}, "
                  f"fewest sites where two replicas differ "
                  f"{int(diffs.min())}; last sample mean e "
                  f"{float(traj['e'][-1].mean()):.5f}")
            check(bool(((e - exact).abs() < 2e-3).all()),
                  "a replica's energy is not within 2e-3 of Onsager's")
            check(bool((m.abs() < 0.01).all()), "a replica's |m| >= 0.01")
            check(int(diffs.min()) > 0, "two replicas are equal")
            del diffs
        else:
            m = abs(session.magnetization())
            onsager = observables.onsager_magnetization(temperature)
            print(f"phase 5: {main_path}: |m| {m:.5f} (Onsager "
                  f"{onsager:.5f}), e {session.energy():.5f}, last sample "
                  f"m {float(traj['m'][-1]):.5f}")
            check(abs(m - onsager) < 2e-3,
                  f"{engine}: |m| is not within 2e-3 of Onsager")
        # read where PR 20 read it: through the checks above
        peaks[main_path] = max(measured["path_peak"],
                               torch.cuda.max_memory_allocated())
        loop_against_graph(5, f"{main_path} measure()", family, "k-sweep",
                           session, measured)
        del session

        def half_run():
            session = Session.open(spec, resident_budget_bytes=0)
            check(session.engine.resident_plan is None,
                  "budget 0 still planned k-sweeps")
            ms = timed_ms(lambda: session.run(HALF_SWEEP_CHECK),
                          reps=1, warmup=False)
            return session, ms

        half, half_ms = drive(half_path, family, "half-sweep", half_run)
        ref = Session.open(spec)
        ref.run(HALF_SWEEP_CHECK)
        torch.cuda.synchronize()
        same = all(torch.equal(a, b) for a, b in zip(half.state, ref.state))
        print(f"phase 5: {half_path}: run({HALF_SWEEP_CHECK}) {half_ms:.1f} "
              f"ms = {HALF_SWEEP_CHECK * spins / (half_ms * 1e6):.2f} "
              f"flips/ns; planes equal to the k-sweep tier's: {same}")
        check(same, f"{engine}: the tiers' planes differ at full size")
        del half, ref

    # tensorcore: the fused kernel, two launches a sweep
    spec = RunSpec(lattice=LatticeSpec(FULL_N, FULL_N, init_p_up=1.0),
                   engine=EngineSpec("tensorcore", {"tc_block": TC_BLOCK}),
                   temperature=TEMPERATURE, seed=SEED,
                   sweep=SweepSpec(thermalize=0, measure_every=10,
                                   n_measure=10))
    main_path = f"tensorcore {FULL_N}^2 block {TC_BLOCK}"
    main_paths["tensorcore"] = half_paths["tensorcore"] = main_path

    def tc_main_run():
        t1 = time.perf_counter()
        session = Session.open(spec)
        torch.cuda.synchronize()
        open_s = time.perf_counter() - t1
        run_ms = timed_ms(lambda: session.run(200), reps=1, warmup=False)
        t1 = time.perf_counter()
        traj = session.measure()
        return session, open_s, run_ms, traj, time.perf_counter() - t1

    torch.cuda.reset_peak_memory_stats()
    session, open_s, run_ms, traj, measure_s = drive(
        main_path, "tensorcore", "half-sweep", tc_main_run)
    launched = launches_by_path[main_path][tc_update]
    m = abs(session.magnetization())
    onsager = observables.onsager_magnetization(TEMPERATURE)
    print(f"phase 5: {main_path}: open {open_s:.2f} s; run(200) "
          f"{run_ms:.1f} ms = {200 * FULL_N ** 2 / (run_ms * 1e6):.2f} "
          f"flips/ns; measure() {spec.sweep.total_sweeps} sweeps + "
          f"{spec.sweep.n_measure} samples {measure_s:.3f} s; "
          f"{launched} launches; |m| {m:.5f} (Onsager {onsager:.5f}), "
          f"e {session.energy():.5f}, last sample m "
          f"{float(traj['m'][-1]):.5f}")
    check(launched == 2 * (200 + spec.sweep.total_sweeps),
          f"tensorcore: {launched} launches, not one per half-sweep")
    check(abs(m - onsager) < 2e-3,
          "tensorcore: |m| is not within 2e-3 of Onsager")
    peaks[main_path] = torch.cuda.max_memory_allocated()
    del session
    phase_s[5] = time.perf_counter() - t0

    # -- 6. the sharded tier's main paths: a 2 x 2 mesh on the one card ----
    t0 = time.perf_counter()
    shard_paths = {}
    for engine, family in ENGINE_FAMILY.items():
        bitplane = family == "bitplane"
        n = BITPLANE_N if bitplane else FULL_N
        temperature = BITPLANE_TEMPERATURE if bitplane else TEMPERATURE
        spec = RunSpec(lattice=LatticeSpec(n, n,
                                           init_p_up=0.5 if bitplane else 1.0),
                       engine=EngineSpec(engine), temperature=temperature,
                       seed=SEED, mesh=mesh_spec(MESH),
                       sweep=SweepSpec(thermalize=0, measure_every=10,
                                       n_measure=10))
        name = f"{family}_shard_sweeps"
        run_path = shard_paths[family] = \
            f"{engine} {n}^2 mesh {MESH} run(200)"
        spins = n * n * (32 if bitplane else 1)

        def open_run():
            t1 = time.perf_counter()
            session = Session.open(spec)
            torch.cuda.synchronize()
            open_s = time.perf_counter() - t1
            run_ms = timed_ms(lambda: session.run(200), reps=1,
                              warmup=False)
            return session, open_s, run_ms

        torch.cuda.reset_peak_memory_stats()
        session, open_s, run_ms = drive(run_path, family, "shard", open_run)
        plan = session.shard_plan
        check(plan is not None, f"{run_path}: no shard plan")
        blocks = math.ceil(200 / plan.k)
        launched = launches_by_path[run_path][name]
        print(f"phase 6: {run_path}: open {open_s:.2f} s (index planes "
              f"included); run(200) {run_ms:.1f} ms = "
              f"{200 * spins / (run_ms * 1e6):.2f} flips/ns (k = {plan.k}, "
              f"tile {plan.tile_rows} x {plan.tile_cols}, {plan.threads} "
              f"threads); halo_exchanges {session.halo_exchanges}; "
              f"{launched} launches of {name}")
        check(session.halo_exchanges == blocks,
              f"{run_path}: {session.halo_exchanges} halo exchanges, not "
              f"ceil(200 / k) = {blocks}")
        check(launched == MESH[0] * MESH[1] * blocks,
              f"{run_path}: {launched} launches, not one per shard and block")

        def measure():
            t1 = time.perf_counter()
            return session.measure(), time.perf_counter() - t1

        traj, measure_s = drive(f"{engine} {n}^2 mesh {MESH} measure()",
                                family, "shard", measure)
        print(f"phase 6: {engine} {n}^2 mesh {MESH}: measure() "
              f"{spec.sweep.total_sweeps} sweeps + {spec.sweep.n_measure} "
              f"samples {measure_s:.3f} s")
        if bitplane:
            m, e = traj["m"][-1], traj["e"][-1]   # after 300 sweeps
            exact = observables.onsager_energy(temperature)
            diffs = replica_disagreements(torch, session.state[0]
                                          + session.state[1])
            print(f"phase 6: {run_path}: per-replica e in [{e.min():.5f}, "
                  f"{e.max():.5f}] (exact {exact:.5f}), max |m| "
                  f"{abs(m).max():.5f}, fewest sites where two replicas "
                  f"differ {int(diffs.min())}")
            check(bool((abs(e - exact) < 2e-3).all()),
                  "sharded: a replica's energy is not within 2e-3 of "
                  "Onsager's")
            check(bool((abs(m) < 0.01).all()), "sharded: a replica's |m| "
                  ">= 0.01")
            check(int(diffs.min()) > 0, "sharded: two replicas are equal")
            del diffs
        else:
            m = abs(session.magnetization())
            onsager = observables.onsager_magnetization(temperature)
            print(f"phase 6: {run_path}: |m| {m:.5f} (Onsager "
                  f"{onsager:.5f}), e {session.energy():.5f}, last sample "
                  f"m {float(traj['m'][-1]):.5f}")
            check(abs(m - onsager) < 2e-3,
                  f"sharded {engine}: |m| is not within 2e-3 of Onsager")
        peaks[run_path] = torch.cuda.max_memory_allocated()
        del session
    phase_s[6] = time.perf_counter() - t0

    # -- 7. the ensemble main paths at full width -----------------------------
    t0 = time.perf_counter()
    ensemble_paths, ensemble_half_paths, ensemble_rates = {}, {}, {}
    for engine, family in ENGINE_FAMILY.items():
        bitplane = family == "bitplane"
        n, batch = ensemble_batch(family)
        spec = RunSpec(lattice=LatticeSpec(n, n,
                                           init_p_up=0.5 if bitplane else 1.0),
                       engine=EngineSpec(engine), batch=batch,
                       sweep=SweepSpec(thermalize=0, measure_every=10,
                                       n_measure=10))
        run_path = ensemble_paths[family] = \
            f"{engine} ensemble {batch.size} x {n}^2 run(200)"
        spins = batch.size * n * n * (32 if bitplane else 1)
        name = f"{family}_sweeps_resident"

        def open_run():
            t1 = time.perf_counter()
            session = Session.open(spec)
            torch.cuda.synchronize()
            open_s = time.perf_counter() - t1
            run_ms = timed_ms(lambda: session.run(200), reps=1,
                              warmup=False)
            # what run() spends on its (B,) magnetizations
            mag_ms = timed_ms(session.magnetization, reps=1, warmup=False)
            firsts = [tuple(p[i].clone() for p in session.state)
                      for i in (0, batch.size - 1)]
            return session, open_s, run_ms, mag_ms, firsts

        torch.cuda.reset_peak_memory_stats()
        session, open_s, run_ms, mag_ms, firsts = drive(
            run_path, family, "k-sweep", open_run)
        plan = session.engine.resident_plan
        limit = member_limit(family)
        blocks = math.ceil(200 / plan.k) * math.ceil(batch.size / limit)
        launched = launches_by_path[run_path][name]
        flips = 200 * spins / (run_ms * 1e6)
        sweep_flips = 200 * spins / ((run_ms - mag_ms) * 1e6)
        ensemble_rates[family] = {"run_ms": run_ms, "flips_per_ns": flips,
                                  "magnetizations_ms": mag_ms,
                                  "sweeps_flips_per_ns": sweep_flips,
                                  "single_flips_per_ns": single_rates[family],
                                  "open_s": open_s}
        print(f"phase 7: {run_path}: open {open_s:.2f} s; run(200) "
              f"{run_ms:.1f} ms = {flips:.2f} flips/ns, of which the (B,) "
              f"magnetizations {mag_ms:.1f} ms: the sweeps "
              f"{sweep_flips:.2f} flips/ns, "
              f"{sweep_flips / single_rates[family]:.4f} of single mode's "
              f"{single_rates[family]:.2f} in phase 5 (k = {plan.k}, tile "
              f"{plan.tile_rows} x {plan.tile_cols}); {launched} launches "
              f"of {name} ({limit} members a launch at the most)")
        check(launched == blocks,
              f"{run_path}: {launched} launches, not ceil(200 / k) "
              f"ceil(B / {limit}) = {blocks}")

        def single_members():
            out = []
            for i in (0, batch.size - 1):
                t, sd = batch.members[i]
                s = Session.open(RunSpec(lattice=spec.lattice,
                                         engine=EngineSpec(engine),
                                         temperature=t, seed=sd))
                s.run(200)
                out.append(s.state)
            return out

        singles = drive(f"{engine} {n}^2 single mode, first and last "
                        f"members, run(200)", family, "k-sweep",
                        single_members)
        same = all(torch.equal(a, b) for got, want in zip(firsts, singles)
                   for a, b in zip(got, want))
        print(f"phase 7: {run_path}: the first and last members' planes "
              f"equal their single-mode sessions': {same}")
        check(same, f"{engine}: an ensemble member is not its single-mode "
              f"run at full width")
        del firsts, singles

        measure_path = f"{engine} ensemble {batch.size} x {n}^2 measure()"
        measured = drive(measure_path, family, "k-sweep",
                         lambda: graph_measure(session))
        traj, measure_s = measured["traj"], measured["seconds"]
        print(f"phase 7: {run_path}: measure() {spec.sweep.total_sweeps} "
              f"sweeps + {spec.sweep.n_measure} samples of {batch.size} "
              f"members {measure_s:.3f} s, samples {traj['m'].shape}")
        if bitplane:
            obs = session.engine.observables_batched(
                session.state, session._runner.inv_temps)
            for i, (t, sd) in enumerate(batch.members):
                m, e = obs["m"][i].cpu(), obs["e"][i].cpu()
                exact = observables.onsager_energy(t)
                diffs = replica_disagreements(
                    torch, [p[i] for p in session.state])
                print(f"phase 7: member {i} T={t} seed={sd}: per-replica e "
                      f"in [{float(e.min()):.5f}, {float(e.max()):.5f}] "
                      f"(exact {exact:.5f}), max |m| "
                      f"{float(m.abs().max()):.5f}, fewest sites where two "
                      f"replicas differ {int(diffs.min())}")
                check(bool(((e - exact).abs() < 2e-3).all()),
                      f"member {i}: a replica's energy is not within 2e-3 "
                      f"of Onsager's")
                check(bool((m.abs() < 0.01).all()),
                      f"member {i}: a replica's |m| >= 0.01")
                check(int(diffs.min()) > 0, f"member {i}: two replicas are "
                      f"equal")
                del diffs
        else:
            mags = [abs(float(v)) for v in session.magnetization()]
            for i, (t, sd) in enumerate(batch.members):
                onsager = observables.onsager_magnetization(t)
                print(f"phase 7: member {i} T={t} seed={sd}: |m| "
                      f"{mags[i]:.5f} (Onsager {onsager:.5f})")
                if t <= 2.0:
                    check(abs(mags[i] - onsager) < 2e-3,
                          f"member {i}: |m| is not within 2e-3 of Onsager")
                if t >= 2.5:
                    check(mags[i] < 0.01, f"member {i}: |m| >= 0.01 at "
                          f"T = {t}")
        # read where PR 20 read it: through the checks above
        peaks[run_path] = max(measured["path_peak"],
                              torch.cuda.max_memory_allocated())
        loop_against_graph(7, measure_path, family, "k-sweep", session,
                           measured)
        del session

        half_path = ensemble_half_paths[family] = \
            f"{engine} ensemble {batch.size} x {n}^2 half-sweep"

        def half_run():
            session = Session.open(spec, resident_budget_bytes=0)
            check(session.engine.resident_plan is None,
                  "budget 0 still planned k-sweeps")
            ms = timed_ms(lambda: session.run(HALF_SWEEP_CHECK),
                          reps=1, warmup=False)
            return session, ms

        half, half_ms = drive(half_path, family, "half-sweep", half_run)
        launched = launches_by_path[half_path][f"{family}_update"]
        blocks = 2 * HALF_SWEEP_CHECK * math.ceil(batch.size / limit)
        ref = Session.open(spec)
        ref.run(HALF_SWEEP_CHECK)
        torch.cuda.synchronize()
        same = all(torch.equal(a, b) for a, b in zip(half.state, ref.state))
        print(f"phase 7: {half_path}: run({HALF_SWEEP_CHECK}) {half_ms:.1f} "
              f"ms = {HALF_SWEEP_CHECK * spins / (half_ms * 1e6):.2f} "
              f"flips/ns (with the magnetizations), {launched} launches of "
              f"{family}_update; planes equal to the k-sweep tier's: {same}")
        check(launched == blocks, f"{half_path}: {launched} launches, not "
              f"{blocks}")
        check(same, f"{engine}: the ensemble's tiers' planes differ")
        del half, ref

    # many small members: one ensemble of 64 seeds at T_c on 512^2 against
    # 64 single-mode sessions run one after another, each run(200)
    small = RunSpec(lattice=LatticeSpec(SMALL_N, SMALL_N, init_p_up=0.5),
                    engine=EngineSpec("multispin_pallas"),
                    batch=BatchSpec((SMALL_ENSEMBLE_T,),
                                    tuple(range(SMALL_ENSEMBLE_MEMBERS)),
                                    grid=True))
    path = (f"multispin_pallas ensemble {SMALL_ENSEMBLE_MEMBERS} x "
            f"{SMALL_N}^2 run(200)")

    def small_ensemble():
        e = Session.open(small)
        torch.cuda.synchronize()
        return e, timed_ms(lambda: e.run(200), reps=1, warmup=False)

    e, ensemble_ms = drive(path, "multispin", "k-sweep", small_ensemble)
    ensemble_launches = launches_by_path[path]["multispin_sweeps_resident"]
    singles_path = (f"multispin_pallas {SMALL_ENSEMBLE_MEMBERS} single-mode "
                    f"sessions {SMALL_N}^2 run(200)")

    def small_singles():
        sessions = [Session.open(RunSpec(lattice=small.lattice,
                                         engine=small.engine,
                                         temperature=t, seed=sd))
                    for t, sd in small.batch.members]
        torch.cuda.synchronize()
        ms = timed_ms(lambda: [s.run(200) for s in sessions], reps=1,
                      warmup=False)
        return sessions, ms

    sessions, singles_ms = drive(singles_path, "multispin", "k-sweep",
                                 small_singles)
    same = all(e.state_digest(member=i) == s.state_digest()
               for i, s in enumerate(sessions))
    ensemble_rates["small"] = {"ensemble_ms": ensemble_ms,
                               "singles_ms": singles_ms,
                               "ensemble_launches": ensemble_launches,
                               "singles_launches": launches_by_path[
                                   singles_path]["multispin_sweeps_resident"]}
    print(f"phase 7: {path}: {ensemble_ms:.1f} ms ({ensemble_launches} "
          f"launches) against {singles_ms:.1f} ms for the "
          f"{SMALL_ENSEMBLE_MEMBERS} single-mode sessions one after another "
          f"({ensemble_rates['small']['singles_launches']} launches): "
          f"{singles_ms / ensemble_ms:.2f}x; member digests equal theirs: "
          f"{same}")
    check(same, "the small ensemble's members are not their single-mode "
          "runs")
    check(ensemble_ms < singles_ms, "the 64-member ensemble took longer than "
          "its 64 single-mode sessions")
    del e, sessions
    phase_s[7] = time.perf_counter() - t0

    # -- 8. the analysis front door: the Fig. 5/6 scan at full width ------
    t0 = time.perf_counter()
    from repro_torch import __main__ as cli
    from repro_torch.analysis import figures
    from repro_torch.api import describe
    from repro_torch.perf.schema import validate_record
    figure_path = (f"figures: multispin, sizes {figures.FULL_SIZES}, "
                   f"{len(figures.TEMPS)} temperatures")
    with tempfile.TemporaryDirectory() as tmp:
        replays = measuring.DISPATCHES
        figure = drive(figure_path, "multispin", "k-sweep",
                       lambda: figures.main(["--out", tmp]))
        replays = measuring.DISPATCHES - replays
    tc, rel = figure["tc"], figure["rel_err"]
    print(f"phase 8: {figure_path}: T_c {tc} (exact "
          f"{observables.T_CRITICAL}, rel err {rel:.5f}); measure() "
          + ", ".join(f"L={L} {s:.3f} s" for L, s in
                      figure["measure_s"].items())
          + f"; {replays} graph replays")
    check(tc is not None and rel < figures.TC_TOLERANCE,
          f"the figure's Binder-crossing T_c {tc} is not within 2% of "
          f"{observables.T_CRITICAL}")
    want = len(figures.FULL_SIZES) * (figures.FULL_SWEEP.n_measure - 1)
    check(replays == want, f"the figure took {replays} graph replays, not "
          f"{want}: one a sample after the first")
    figure_rows = {}
    for L, spec in figures.figure_specs(figures.FULL_SIZES,
                                        figures.FULL_SWEEP,
                                        "multispin").items():
        path = f"figure multispin ensemble 13 x {L}^2 measure()"
        session = Session.open(spec)
        measured = drive(path, "multispin", "k-sweep",
                         lambda: graph_measure(session))
        same = all(np.array_equal(measured["traj"][k], figure["traj"][L][k])
                   for k in measured["traj"])
        check(same, f"{path}: not the figure's samples")
        loop_against_graph(8, path, "multispin", "k-sweep", session,
                           measured)
        figure_rows[L] = graph_rows[path]
        del session
    # every counter-based engine on both tiers, single mode and an
    # ensemble of 3: the graph's samples and digest are the loop's
    # (basic_philox: its one tier, the draws of philox_fill)
    parity_plan = SweepSpec(thermalize=7, measure_every=5, n_measure=20)
    parity_tiers = [(engine, family, tier)
                    for engine, family in ENSEMBLE_ENGINES.items()
                    for tier in ("k-sweep", "half-sweep")]
    for engine, family, tier in parity_tiers + [("basic_philox", "draws",
                                                 "fill")]:
        for batch in (None, BatchSpec(CHECK_TEMPS, CHECK_SEEDS)):
            spec = RunSpec(lattice=LatticeSpec(SMALL_N, SMALL_N,
                                               init_p_up=0.5),
                           engine=EngineSpec(engine), temperature=2.2,
                           seed=SEED, batch=batch, sweep=parity_plan)
            session = Session.open(spec,
                                   resident_budget_bytes=budget(tier))
            session.run(3)
            path = (f"{engine} {SMALL_N}^2 {tier} "
                    f"{'single' if batch is None else 'ensemble of 3'}"
                    f" measure()")
            measured = drive(path, family, tier,
                             lambda: graph_measure(session))
            loop_against_graph(8, path, family, tier, session, measured)
            if tier == "fill":
                half_sweeps = 2 * parity_plan.plan().total_sweeps
                for run_path in (path, f"{path} as the loop"):
                    got = launches_by_path[run_path][fill]
                    check(got == half_sweeps,
                          f"{run_path}: {got} launches of {fill}, not one "
                          f"a half-sweep for all members")
            print(f"phase 8: {path}: digest {session.state_digest()}, "
                  f"the loop's planes equal")
            del session
    # the CLI on the card: a spec file with --record (validated), and
    # --dry-run, which needs no card
    with tempfile.TemporaryDirectory() as tmp:
        spec = figures.figure_specs(figures.FULL_SIZES[:1],
                                    figures.FULL_SWEEP, "multispin")[
            figures.FULL_SIZES[0]]
        spec_file, record = Path(tmp) / "spec.json", Path(tmp) / "rec.json"
        spec_file.write_text(spec.to_json(indent=1))
        rc = drive("python -m repro_torch run spec.json --record",
                   "multispin", "k-sweep", lambda: cli.main(
                       ["run", str(spec_file), "--record", str(record)]))
        rec = json.loads(record.read_text())
        validate_record(rec)
        meta = rec["meta"]
        print(f"phase 8: run spec.json --record: exit {rc}, record rows "
              f"{[r['name'] for r in rec['rows']]}, meta backend "
              f"{meta['backend']}, {meta['device_count']} device(s), "
              f"{meta['device_name']}, {meta['power_limit']}")
        check(rc == 0 and meta["backend"] == "cuda"
              and meta["device_name"] == torch.cuda.get_device_name(0)
              and meta["spec"] == json.loads(spec.to_json()),
              "the --record run or its record is wrong")
        allocated = torch.cuda.memory_allocated()
        rc = drive("python -m repro_torch run spec.json --dry-run", None,
                   None, lambda: cli.main(["run", str(spec_file),
                                           "--dry-run"]))
        check(rc == 0 and torch.cuda.memory_allocated() == allocated,
              "the dry run failed or took device memory")
        hidden = subprocess.run(
            [sys.executable, "-m", "repro_torch", "run", str(spec_file),
             "--dry-run"], capture_output=True, text=True, timeout=300,
            env={**os.environ, "PYTHONPATH": str(SRC),
                 "CUDA_VISIBLE_DEVICES": ""})
        check(hidden.returncode == 0 and json.loads(hidden.stdout)
              == json.loads(json.dumps(describe(spec))),
              f"the dry run with the card hidden failed: {hidden.stderr}")
        print("phase 8: run spec.json --dry-run: the plan, no launch, no "
              "device memory; with the card hidden too")
    phase_s[8] = time.perf_counter() - t0

    # -- 9. the engines of plain updates, their draws from philox_fill -----
    t0 = time.perf_counter()
    from repro_torch.core import ising3d
    from repro_torch.resilience import integrity
    fill_paths, plain_rows = {}, {}

    def plain_run(path, spec, sweeps, before=None, spins=None):
        """``Session.open(spec)`` and ``run(sweeps)`` as one path, which
        must launch ``philox_fill`` and no other kernel; its time, rate
        (``spins``: the spins flipped, default sweeps x sites), peak device
        memory and launches printed beside the card.  ``before(session)``
        runs after the open; returns ``(session, its value)``."""
        def go():
            torch.cuda.reset_peak_memory_stats()
            t1 = time.perf_counter()
            session = Session.open(spec)
            torch.cuda.synchronize()
            open_s = time.perf_counter() - t1
            seen = None if before is None else before(session)
            ms = timed_ms(lambda: session.run(sweeps), reps=1, warmup=False)
            return session, seen, open_s, ms
        session, seen, open_s, ms = drive(path, "draws", "fill", go)
        peak = torch.cuda.max_memory_allocated()
        flipped = sweeps * spec.lattice.n * spec.lattice.m \
            if spins is None else spins(session)
        row = plain_rows[path] = {
            "open_s": open_s, "ms": ms, "sweeps": sweeps,
            "flips_per_ns": flipped / (ms * 1e6), "peak_bytes": peak,
            "launches": launches_by_path[path][fill], "card": card_line}
        print(f"phase 9: {path}: open {open_s:.2f} s; run({sweeps}) "
              f"{ms:.1f} ms = {row['flips_per_ns']:.6g} flips/ns; peak "
              f"device memory {peak} B; {row['launches']} launches of "
              f"{fill}; {card_line}")
        return session, seen

    def spec_of(engine, n, temperature, p_up, **params):
        return RunSpec(lattice=LatticeSpec(n, n, init_p_up=p_up),
                       engine=EngineSpec(engine, params),
                       temperature=temperature, seed=SEED)

    def host_planes(session):
        return [p.cpu() for p in session.state]

    # basic_philox at the stencil main path's spec: its planes after
    # run(200) are stencil_pallas's (phase 5, held on the host; a CRC32C
    # digest of 2^30 spins on the host would take about a minute)
    path = fill_paths["draws"] = f"basic_philox {FULL_N}^2"
    spec = spec_of("basic_philox", FULL_N, TEMPERATURE, 1.0)
    session, _ = plain_run(path, spec, 200)
    check(plain_rows[path]["launches"] == 400,
          f"{path}: {plain_rows[path]['launches']} launches of {fill}, "
          f"not 2 a sweep")
    basic_planes = host_planes(session)
    same = all(torch.equal(a, b) for a, b in zip(basic_planes,
                                                  stencil_after_200))
    m = abs(session.magnetization())
    print(f"phase 9: {path}: planes after run(200) equal to "
          f"stencil_pallas's (phase 5) bit for bit: {same}; |m| {m:.5f} "
          f"(Onsager {observables.onsager_magnetization(TEMPERATURE):.5f})")
    check(same, f"{path}: not stencil_pallas's planes")
    del session
    path = f"basic {FULL_N}^2"
    session, _ = plain_run(path, spec_of("basic", FULL_N, TEMPERATURE, 1.0),
                           200)
    same = all(torch.equal(a, b) for a, b in zip(host_planes(session),
                                                  basic_planes))
    print(f"phase 9: {path}: planes equal to basic_philox's: {same}")
    check(same and plain_rows[path]["launches"] == 400,
          f"{path}: not basic_philox's planes, or not 2 launches a sweep")
    del session, basic_planes, stencil_after_200

    # the spin glass: a quench at inverse temperature 2 from a hot start
    path = f"spinglass {SPINGLASS_N}^2 p_ferro 0.5"
    session, e0 = plain_run(
        path, spec_of("spinglass", SPINGLASS_N, 0.5, 0.5, p_ferro=0.5), 200,
        before=lambda s: s.energy())
    e1, m = session.energy(), session.magnetization()
    print(f"phase 9: {path}: e {e0:.5f} -> {e1:.5f} after run(200) at "
          f"beta 2, m {m:.6f}")
    check(e1 < e0 - 0.3 and abs(m) < 0.01,
          f"{path}: the quench did not lower e by 0.3, or |m| >= 0.01")
    check(plain_rows[path]["launches"] == 401,
          f"{path}: not one launch for the couplings and 2 a sweep")
    del session
    # p_ferro = 1 is the ferromagnet: basic_philox's lattice
    path = f"basic_philox {SPINGLASS_FERRO_N}^2"
    session, _ = plain_run(path, spec_of("basic_philox", SPINGLASS_FERRO_N,
                                         TEMPERATURE, 1.0), 200)
    ferro = session.full_lattice().cpu()
    del session
    path = f"spinglass {SPINGLASS_FERRO_N}^2 p_ferro 1"
    session, _ = plain_run(path, spec_of("spinglass", SPINGLASS_FERRO_N,
                                         TEMPERATURE, 1.0, p_ferro=1.0), 200)
    same = torch.equal(session.full_lattice().cpu(), ferro)
    print(f"phase 9: {path}: lattice equal to basic_philox's: {same}")
    check(same, f"{path}: not basic_philox's lattice")
    del session, ferro

    # Wolff: a "sweep" is one cluster flip
    def cluster_spins(session):
        return float(session.engine.mean_cluster_size) * session.step_count

    for n, t, flips, p_up in ((WOLFF_N, WOLFF_T, WOLFF_FLIPS, 1.0),
                              (WOLFF_TC_N, WOLFF_TC_T, WOLFF_TC_FLIPS, 0.5)):
        path = f"wolff {n}^2 T={t}"
        session, _ = plain_run(path, spec_of("wolff", n, t, p_up), flips,
                               spins=cluster_spins)
        size = float(session.engine.mean_cluster_size)
        m = abs(session.magnetization())
        plain_rows[path]["mean_cluster_size"] = size
        print(f"phase 9: {path}: {flips} cluster flips, "
              f"{plain_rows[path]['ms'] / flips:.3f} ms a flip, mean "
              f"cluster size {size:.1f}, |m| {m:.5f} (Onsager "
              f"{observables.onsager_magnetization(t):.5f})")
        if t == WOLFF_T:
            check(m > 0.80, f"{path}: |m| {m} <= 0.80")
        del session

    # the 3D model at 512^3: ordered at T = 3.5, disordered at T = 8;
    # four slabs of a (4, 1) mesh on the one card give the single run
    def cube_run(path, fn, sweeps):
        torch.cuda.reset_peak_memory_stats()
        out, ms = drive(path, "draws", "fill", lambda: plain_timed(fn))
        peak = torch.cuda.max_memory_allocated()
        m = float(ising3d.magnetization_3d(out))
        row = plain_rows[path] = {
            "ms": ms, "sweeps": sweeps, "ms_a_sweep": ms / sweeps,
            "flips_per_ns": sweeps * CUBE_N ** 3 / (ms * 1e6),
            "peak_bytes": peak, "launches": launches_by_path[path][fill],
            "m": m, "card": card_line}
        print(f"phase 9: {path}: {sweeps} sweeps {ms:.1f} ms = "
              f"{row['ms_a_sweep']:.3f} ms a sweep, "
              f"{row['flips_per_ns']:.4f} flips/ns; m {m:.5f}; peak device "
              f"memory {peak} B; {row['launches']} launches of {fill}; "
              f"{card_line}")
        return out

    ones = torch.ones((CUBE_N,) * 3, dtype=torch.int8, device="cuda")
    cold = cube_run(f"ising3d {CUBE_N}^3 T=3.5", lambda: ising3d.run_sweeps_3d(
        ones, ising3d.acceptance_table_3d(1 / 3.5), CUBE_SWEEPS, SEED),
        CUBE_SWEEPS)
    hot = cube_run(f"ising3d {CUBE_N}^3 T=8", lambda: ising3d.run_sweeps_3d(
        ones, ising3d.acceptance_table_3d(1 / 8.0), CUBE_SWEEPS, SEED),
        CUBE_SWEEPS)
    check(abs(float(ising3d.magnetization_3d(cold))) > 0.85
          and abs(float(ising3d.magnetization_3d(hot))) < 0.2,
          "ising3d: not ordered at T = 3.5 or not disordered at T = 8")
    del hot
    slab_step, split, gather = ising3d.make_ising3d_step(
        make_mesh((4, 1), ("data", "model")), n=CUBE_N, seed=SEED,
        n_sweeps=CUBE_SWEEPS)
    slabs = cube_run(f"ising3d {CUBE_N}^3 T=3.5 on 4 slabs",
                     lambda: gather(slab_step(split(ones), 1 / 3.5, 0)),
                     CUBE_SWEEPS)
    same = torch.equal(slabs, cold)
    print(f"phase 9: ising3d {CUBE_N}^3: the 4-slab mesh's lattice equals "
          f"the single device's: {same}")
    check(same, "ising3d: the slab run is not the single-device run")
    del ones, cold, slabs, slab_step, split, gather

    # at 512^2 (32^3): the card against the CPU, digest for digest
    small_cases = {"basic_philox": (2.2, 0.5, {}), "basic": (2.2, 0.5, {}),
             "spinglass": (2.2, 0.5, {"p_ferro": 0.5}),
             "wolff": (SMALL_WOLFF_T, 0.5, {})}
    single_digest = {}
    for engine, (t, p_up, params) in small_cases.items():
        sweeps = SMALL_WOLFF_FLIPS if engine == "wolff" else SMALL_SWEEPS
        spec = spec_of(engine, SMALL_N, t, p_up, **params)
        path = f"{engine} {SMALL_N}^2 card"

        def card_run():
            s = Session.open(spec)
            s.run(sweeps)
            return s.state_digest()
        got = drive(path, "draws", "fill", card_run)
        cpu = Session.open(spec, device="cpu")
        cpu.run(sweeps)
        want = single_digest[engine] = cpu.state_digest()
        print(f"phase 9: {path}: digest {got}, the CPU's {want}")
        check(got == want, f"{path}: the card's digest is not the CPU's")
    # basic_philox as an ensemble of 3 (one launch a half-sweep for all
    # members) and on a 2 x 2 mesh (the per-half-sweep distributed step,
    # one launch a shard a half-sweep): single mode's digests
    batch = BatchSpec(CHECK_TEMPS, CHECK_SEEDS)
    spec = RunSpec(lattice=LatticeSpec(SMALL_N, SMALL_N),
                   engine=EngineSpec("basic_philox"), batch=batch)
    path = f"basic_philox {SMALL_N}^2 ensemble of 3"

    def ensemble_run():
        s = Session.open(spec)
        s.run(SMALL_SWEEPS)
        return [s.state_digest(member=i) for i in range(batch.size)]
    members = drive(path, "draws", "fill", ensemble_run)
    check(launches_by_path[path][fill] == 2 * SMALL_SWEEPS,
          f"{path}: not one launch a half-sweep for all members")
    want = []
    for t, sd in batch.members:
        s = Session.open(RunSpec(lattice=LatticeSpec(SMALL_N, SMALL_N),
                                 engine=EngineSpec("basic_philox"),
                                 temperature=t, seed=sd))
        s.run(SMALL_SWEEPS)
        want.append(s.state_digest())
    print(f"phase 9: {path}: member digests {members}, single mode's "
          f"{want}")
    check(members == want, f"{path}: a member is not its single-mode run")
    spec = spec_of("basic_philox", SMALL_N, 2.2, 0.5)
    path = f"basic_philox {SMALL_N}^2 mesh {MESH}"

    def mesh_run():
        s = Session.open(dataclasses.replace(
            spec, mesh=MeshSpec(MESH, ("data", "model"))))
        s.run(SMALL_SWEEPS)
        return s.state_digest()
    got = drive(path, "draws", "fill", mesh_run)
    shards = MESH[0] * MESH[1]
    print(f"phase 9: {path}: digest {got}, single mode's "
          f"{single_digest['basic_philox']}; "
          f"{launches_by_path[path][fill]} launches of {fill}")
    check(got == single_digest["basic_philox"],
          f"{path}: not the single-mode digest")
    check(launches_by_path[path][fill] == 2 * shards * SMALL_SWEEPS,
          f"{path}: not one launch a shard a half-sweep")
    # a checkpoint written by the JAX package continues on the card
    record = json.loads(JAX_CHECKPOINT.with_suffix(".json").read_text())
    path = f"basic_philox {SMALL_N}^2 JAX checkpoint"

    def jax_run():
        s = Session.restore(str(JAX_CHECKPOINT.with_suffix(".npz")))
        saved = s.state_digest()
        s.run(record["sweeps"])
        return saved, s.state_digest()
    saved, got = drive(path, "draws", "fill", jax_run)
    print(f"phase 9: {path}: restored {saved}, after {record['sweeps']} "
          f"sweeps {got}; the JAX package's {record['saved_digest']}, "
          f"{record['digest']}")
    check((saved, got) == (record["saved_digest"], record["digest"]),
          f"{path}: not the JAX package's digests")
    # the 3D model at 32^3: the card's lattice against the CPU's, and
    # the slabs of a 2 x 2 mesh against the single device
    cube = (torch.arange(SMALL_CUBE_N ** 3) % 3 == 0).to(torch.int8) * 2 - 1
    cube = cube.reshape((SMALL_CUBE_N,) * 3)
    table = ising3d.acceptance_table_3d(1 / 4.0)
    path = f"ising3d {SMALL_CUBE_N}^3 card"
    got = drive(path, "draws", "fill", lambda: ising3d.run_sweeps_3d(
        cube.cuda(), table, SMALL_SWEEPS, SEED, 2 ** 32 - 5).cpu())
    want = ising3d.run_sweeps_3d(cube, table, SMALL_SWEEPS, SEED,
                                 2 ** 32 - 5)
    slab_step, split, gather = ising3d.make_ising3d_step(
        make_mesh(MESH, ("data", "model")), n=SMALL_CUBE_N, seed=SEED,
        n_sweeps=SMALL_SWEEPS)
    slabs = drive(f"{path} on {MESH} slabs", "draws", "fill",
                  lambda: gather(slab_step(split(cube.cuda()), 1 / 4.0,
                                           2 ** 32 - 5)).cpu())
    digests = [f"{integrity.crc32c(x.numpy().tobytes()):08x}"
               for x in (got, want, slabs)]
    print(f"phase 9: {path}: digest {digests[0]}, the CPU's {digests[1]}, "
          f"the {MESH} slabs' {digests[2]}")
    check(len(set(digests)) == 1 and torch.equal(got, want)
          and torch.equal(slabs, want),
          f"{path}: the card, the CPU and the slabs disagree")
    print("phase 9 rows: " + json.dumps(plain_rows))
    phase_s[9] = time.perf_counter() - t0

    # -- 10. telemetry, resilience and the checkpointer ---------------------
    t0 = time.perf_counter()
    phase_10(drive, timed_ms)
    phase_s[10] = time.perf_counter() - t0

    def by_path(name):
        return {path: c[name] for path, c in launches_by_path.items()}

    kernels = []
    for name, (family, tier, replaces) in KERNELS.items():
        path = {"k-sweep": main_paths, "half-sweep": half_paths,
                "shard": shard_paths, "fill": fill_paths}[tier][family]
        entry = {"name": name, "route": "cuda",
                 "source": f"src/repro_torch/csrc/{family}.cu",
                 "replaces": replaces,
                 "launches": launches_by_path[path][name],
                 "launches_path": path,
                 "launches_by_path": by_path(name),
                 "mismatches": stats[name][1],
                 "max_abs_err": float(stats[name][2]),
                 "shape": list(shard_shape[family] if tier == "shard"
                               else full_plane[family]),
                 "ms": kernel_ms[name], "plain_ms": stats[name][3],
                 "bound_ms": bounds[name][0], "bound_by": bounds[name][1],
                 "library_ms": None}
        if tier == "k-sweep":
            entry["n_sweeps"] = plans[family].k
        if tier == "shard":
            entry["n_sweeps"] = shard_plans[family].k
        if tier == "fill":
            # no PyTorch call draws these uniforms: torch.rand draws
            # another function, timed as a note only
            entry["lanes"] = 1
            entry["note_torch_rand_ms"] = rand_ms
        if name in accept_stats:
            entry["accept_comparisons"] = accept_stats[name]
        if name in batched:
            # the member axis at the ensemble main path's shape; launches
            # from that path's run(200) (k-sweep) or 10 sweeps
            # (half-sweep)
            b = batched[name]
            ens = (ensemble_paths if tier == "k-sweep"
                   else ensemble_half_paths)[family]
            entry["batched"] = {
                "shape": list(ensemble_shape[family]),
                "launches": launches_by_path[ens][name],
                "launches_path": ens,
                "comparisons": b["comparisons"],
                "mismatches": b["mismatches"],
                "max_abs_err": float(b["max_abs_err"]),
                "by_accept": b["by_accept"], "ms": b["ms"],
                "plain_ms": b["plain_ms"], "bound_ms": b["bound"][0],
                "bound_by": b["bound"][1]}
        kernels.append(entry)
    print("phase seconds: " + ", ".join(
        f"{p} {s:.1f}" for p, s in sorted(phase_s.items()))
        + f"; total {time.perf_counter() - t_start:.1f}")
    print("ensemble rates: " + json.dumps(ensemble_rates))
    print("measure() graph against loop: " + json.dumps(graph_rows))
    print(json.dumps({"kernels": kernels}))
    print("peak device memory by main path: " + ", ".join(
        f"{p} {b} B" for p, b in peaks.items()))
    print(card_line)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
