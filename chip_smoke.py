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
model).  Nor does the twelfth, ``bitplane_counts``: the per-replica
counts behind the bitplane engines' observables (m and e), which the JAX
package computes in ``jnp``.  Phases, each of which raises (and so exits non-zero) when it
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
   ``tensorcore_update`` at blocks 8 to 128 (8 and 24: the element-wise
   form) on small ragged planes (also at T = 0.05 from all-up planes, where no spin may flip), at
   planes of 512^2 with blocks 16 and 64 (int8 and bf16) and at the main
   path's 16384^2 planes with block 128, both colours; on planes of one
   tile more than a multiple of its persistent grid; at block 128 on a
   512^2 lattice, both colours and types, with a hot table (every entry
   1) and the cold one from all-up planes; at every tile it takes; a
   block that does not tile the planes must raise, and sessions at the
   JAX engine's blocks (64^2 at 8, 48^2 at 24 and 8) must give the CPU's
   digest after 10 sweeps; each shard kernel on whole extended planes,
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
   ``torch.rand``; ``bitplane_counts`` at the ensemble main path's
   (16, 4096, 2048) planes and at the main path's two (16384, 8192)
   ones, timed there beside its plain version (every path below that
   reads a bitplane session's observables must launch it, and no other
   path may);
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
   supervised ``multispin_pallas`` 16384^2 run (T = 2.0, ordered, 200
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
   their plans' exchanges and bytes;
11. the sweep farm and the legacy entry point (:func:`phase_11`): the
   farm's jobs (a bitplane_pallas 2048^2 x 32 job first, then 8
   coalescible multispin_pallas 4096^2 jobs at T = 1.5 + 0.125 i, a
   basic_philox 4096^2 job and a stencil_pallas 4096^2 job on a 2 x 2
   mesh; 200 sweeps) run as direct ``Session`` references; the crash
   drill through ``python -m repro_torch serve`` (chunks of 50, a
   checkpoint every 100): SIGKILL once the coalesced batch has committed
   its checkpoint, at least one acked job without a done record, the
   restart resuming that batch (``resilience.resume``), every job
   completed exactly once with its reference digest, no retry or
   demotion; the same jobs through a ``SweepFarm`` in process (chunk =
   sweeps), a batch a path: the coalesced batch ceil(200 / k) launches
   of the multispin k-sweep kernel for all 8 members, the mesh job 4
   ceil(200 / k) of the stencil shard kernel, one dispatch a batch, then
   a second wave of the 8 jobs as one batch from the runner pool
   (``serve.cache_hit``), batch, CRC32C and checkpoint seconds;
   ``repro_torch.launch.simulate`` at 32768^2 (multispin, T = 2.0, 300
   sweeps, m every 100) uninterrupted, then to 200 with ``--ckpt`` and
   restored to 300: the same ``m=`` lines.  At the ensemble cells'
   member size (8192^2) the host CRC32C of the farm's checkpoints and
   digests takes phase 11 past its budget (PERF.md), so its lattice
   side is halved;
12. the performance contract (:func:`phase_12`): ``python -m
   repro_torch.dist.weakscale --devices 1,2,4 --base-n 8192 --cols 32768
   --sweeps 20 --trials 5 --json`` twice, as subprocesses, every row's
   ``pct_of_roofline`` (``repro_torch.launch.roofline``'s H100 row, whose
   ``H100_*`` figures the bounds here read too) in (0, 100]; the readings
   of phase 5's four single-mode ``run(200)`` rates beside their
   predictions; ``repro_torch.perf.gate`` on the card's records: the
   first against itself under its ``--init-budgets`` floors exit 0,
   under floors at ``--safety 2.0`` exit 1 with every throughput row
   ``budget``, ``--advisory`` exit 0, then the second record against the
   first printed (the run-to-run noise, not asserted); the three raw
   sweep wrappers (``repro_torch.kernels.<family>.ops``) at 512^2, 3
   sweeps: 6 launches of the family's half-sweep kernel, the CPU's
   planes; the four ``repro_torch.examples`` in process on the card with their
   assertions: ``quickstart``'s raw kernel part 200 launches of
   ``multispin_update`` for 100 sweeps, ``phase_transition``'s |m| at T =
   1.5 within 0.02 of Onsager's, ``bitplane_replicas``' replica gates,
   ``multipod_sim`` bit-exact on a 2 x 2 mesh of shards on the card;
13. the LM stack's inference path (:func:`phase_13`), driven as one path
   that launches none of the eleven kernels: every architecture of
   ``repro_torch.configs.ARCH_IDS`` at its ``smoke_config()`` width on the
   card and on the CPU from one initialisation copied across: ``forward``
   logits (max absolute and relative-RMS error within ``LM_REL_RMS``),
   8 greedy ``make_serve_step`` tokens teacher-forced with the CPU's
   (equal wherever the CPU's top-2 logit margin exceeds ``LM_MARGIN``),
   prefill against decode on the card; the ring cache against the full
   cache, ``moe_block``'s two layouts against each other; then
   ``internlm2-1.8b`` at its full width (24 layers, about 1.7 G
   parameters from the port's own init): ``make_prefill_step`` on
   ``make_batch`` at 8 x 512, 32 greedy ``make_serve_step`` tokens from a
   cache of ``max_len`` 1024, one prefill at 1 x 8192 (``sdpa_chunked``
   at its threshold), their CUDA-event times, tokens/s and peak device
   memory, and the full width against the CPU at 2 layers, 1 x 16 tokens;
14. the LM stack's training path (:func:`phase_14`), driven as one path
   that launches none of the eleven kernels: ``layers.mm``'s backward on
   the card (its cotangent rounded to bf16 for the tensor cores) against
   the CPU's plain f32 product at a 2-D, a batched and a broadcast layout
   (within ``LM_MM_TOL``); every architecture's ``make_train_step`` at
   smoke width on the card and on the CPU from one initialisation and
   batch: loss, ``grad_norm`` and every gradient (taken by its
   ``grad_sync``) within ``LM_TRAIN_LOSS``, ``LM_TRAIN_GNORM``,
   ``LM_GRAD_TREE`` and ``LM_GRAD_LEAF`` (MoE archs dropless, on the
   positions routed alike); ``internlm2-1.8b`` at full width with remat:
   5 steps on one 8 x 512 batch (the loss must fall), each on CUDA
   events and the host's time to return, the median of steps 2-5,
   tokens/s, peak device memory, the AdamW update timed alone, a step in
   4 microbatches against the full batch from one state (loss 1e-4,
   ``grad_norm`` 1e-3 relative), one step at 2 x 4096 in 2 microbatches
   (time, peak; no full-width checkpoint: the host CRC32C of 27 GB would
   not fit); ``python -m repro_torch.launch.train --smoke
   --deterministic`` (``CUBLAS_WORKSPACE_CONFIG`` set) as subprocesses:
   ``--die-at`` exits 42, the rerun restores and exits 0, and its final
   checkpoint equals a straight run's bit for bit;
15. the dry-run (:func:`phase_15`): ``repro_torch.launch.dryrun``'s cells
   on the host, on the meta device, each "ok" (status, FLOPs and bytes a
   device, dominant roofline term, argument bytes a device printed):
   ``internlm2-1.8b`` ``train_4k`` and ``xlstm-125m`` ``decode_32k`` at
   full width and the three Ising engines on both lattices, each on the
   (16, 16) and (2, 16, 16) production meshes; ``internlm2-1.8b`` at 8 x
   512 on a one-device mesh: the parameter and AdamW bytes counted from
   the specs within 1 % of what ``opt_init`` leaves allocated on the
   card, and one train step's FLOPs counted on meta equal to those the
   same counter reads around the step on the card; then one launch of
   each family's shard kernel at the plan and extended shard the
   dry-run reports for ``lat_256k`` on (2, 16, 16), each its own path,
   0 mismatches against its plain version.

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
#: the blocks checked on (2B, 3B) planes: any block that tiles the planes
#: (the JAX engine's rule); sides that are multiples of 16 take the tiled
#: kernel, 8 and 24 the element-wise one
TC_BLOCKS = (8, 16, 24, 32, 48, 64, 80, 96, 112, 128)
#: lattices whose tensorcore trajectory on the card must equal the CPU's
#: (side, tc_block): JAX's quickstart's 64^2 at 8, and 48^2, whose 24 x 24
#: planes take the element-wise kernel, at 24 and 8
TC_JAX_BLOCKS = ((64, 8), (48, 24), (48, 8))
TC_JAX_SWEEPS = 10
#: tensorcore planes of 5 x 53 tiles of the kernel's 64 x 128: one more
#: than a grid of 2 x 132 blocks (or 132), so a block takes one tile more
TC_RAGGED = (320, 6784)
#: tensorcore planes whose largest dividing tile (64, 32, 16 rows; 128,
#: 64, 32, 16 columns) is each tile the kernel takes: (tile, planes)
TC_TILE_PLANES = tuple(((r, c), (h, w))
                       for r, h in ((64, 128), (32, 96), (16, 80))
                       for c, w in ((128, 256), (64, 192), (32, 160),
                                    (16, 144)))
#: the card's figures (SMs, clocks, per-clock pipe rates, HBM bandwidth)
#: are ``repro_torch.launch.roofline``'s ``H100_*`` constants, which the
#: roofline's "cuda" row is derived from too; the bounds below read them
#: there.
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
#: the twelve kernels: family, tier, TPU kernel replaced
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
    # not a TPU kernel: the bitplane observables' counts, in jnp there
    "bitplane_counts": ("bitplane", "counts",
                        "none: src/repro/core/bitplane.py:228 "
                        "replica_observables, in jnp"),
}
#: the kernel a path launches where it reads a bitplane session's
#: observables on the card, besides the kernel of its tier
COUNT_KERNEL = "bitplane_counts"
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
#: phase 10: the supervised main path (multispin_pallas at SUPERVISE_N^2,
#: the main path's FULL_N halved: at FULL_N the host CRC32C of its 512 MiB
#: checkpoints and digests took most of the script's margin, PERF.md):
#: sweeps, chunk, checkpoint cadence, and the step whose chunk stops it
SUPERVISE_N = FULL_N // 2
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
#: phase 11, the sweep farm: FARM_K coalescible multispin_pallas jobs of
#: FARM_N^2 (T = 1.5 + 0.125 i, seeds 20 + i; ordered start), a
#: bitplane_pallas job of FARM_BITPLANE_N^2 x 32 (T = 3.0, hot), a
#: basic_philox job of FARM_N^2 and a stencil_pallas job of FARM_N^2 on
#: a FARM_MESH mesh (T = 2.0, ordered); FARM_SWEEPS sweeps a job in
#: chunks of FARM_CHUNK, a checkpoint every FARM_EVERY sweeps.  The
#: ensemble cells' member size (8192^2, bitplane 4096^2) halved: at it
#: the host CRC32C of the farm's checkpoints and digests took the phase
#: past its budget (PERF.md)
FARM_N, FARM_BITPLANE_N = 4096, 2048
FARM_K = 8
FARM_MESH = (2, 2)
FARM_SWEEPS, FARM_CHUNK, FARM_EVERY = 200, 50, 100
#: the legacy driver: multispin at SIM_N^2, T = 2.0, SIM_SWEEPS sweeps,
#: m every SIM_EVERY; the checkpointed run stops at SIM_CKPT
SIM_N, SIM_SWEEPS, SIM_EVERY, SIM_CKPT = 32768, 300, 100, 200
#: phase 12, the performance contract: two weakscale records of (D, 1)
#: meshes, D in WEAKSCALE_SHARDS, PERF_BASE_N rows a shard, PERF_COLS
#: columns, PERF_SWEEPS sweeps a call, PERF_TRIALS calls
PERF_BASE_N, PERF_COLS = 8192, 32768
PERF_SWEEPS, PERF_TRIALS = 20, 5
#: the roofline readings (%) predicted from PERF.md's single-mode rates
#: before the phase first ran (k = 2, tensorcore k = 1)
ROOFLINE_PREDICTED = {"stencil": 13.95, "multispin": 19.43,
                      "bitplane": 57.0, "tensorcore": 62.6}
#: the engine of each main path's family
FAMILY_ENGINE = {"stencil": "stencil_pallas",
                 "multispin": "multispin_pallas",
                 "bitplane": "bitplane_pallas", "tensorcore": "tensorcore"}
#: sweeps of each raw sweep wrapper (``kernels.<family>.ops``) at SMALL_N^2
RAW_SWEEPS = 3
#: phase_transition's |m| at T = 1.5 from its ordered start: within this
#: of Onsager's 0.9865
EXAMPLE_M_TOLERANCE = 0.02
#: phase 13, the LM stack's inference path: the smoke configs' batch, their
#: greedy tokens, the card against the CPU as the logits' relative RMS
#: error (bf16 activations summed in another order: about 1 % against the
#: JAX package on the CPU, tests/test_torch_lm.py; MoE routing can take
#: another expert at a near-tie, so the MoE archs run dropless and get
#: LM_MOE_REL_RMS), the top-2 margin above which the greedy tokens must
#: agree, prefill against decode (tests/test_models.py's 0.05)
LM_SMOKE_BATCH, LM_SMOKE_TOKENS = 2, 16
LM_SERVE_STEPS = 8
LM_REL_RMS, LM_MOE_REL_RMS = 0.03, 0.15
LM_MARGIN = 0.05
LM_CONSISTENCY_TOL = 0.05
LM_RING_WINDOW, LM_RING_STEPS = 4, 10
#: the full width: internlm2-1.8b, prefill at LM_PREFILL (batch, tokens)
#: from make_batch, LM_DECODE greedy tokens from a cache of LM_MAX_LEN,
#: one prefill at LM_LONG (sdpa_chunked's threshold); against the CPU at
#: LM_CPU_LAYERS layers and LM_CPU_TOKENS
LM_ARCH = "internlm2-1.8b"
LM_PREFILL, LM_LONG = (8, 512), (1, 8192)
LM_DECODE, LM_MAX_LEN = 32, 1024
LM_CPU_LAYERS, LM_CPU_TOKENS = 2, (1, 16)
LM_PREFILL_TRIALS = 3
#: phase 14, the LM stack's training path.  The product's backward on the
#: card against its CPU plain version at LM_MM_LAYOUTS ((a, b) shapes:
#: 2-D, batched, b broadcast over a's leading axis): each gradient's
#: largest error within LM_MM_TOL of its largest value (the card rounds
#: the cotangent to bf16, 2^-9 relative, and sums in another order).  The
#: smoke archs' train step (LM_SMOKE_OPT) on the card against the CPU:
#: the gradient tree's relative RMS error within LM_GRAD_TREE, a leaf's
#: within LM_GRAD_LEAF (a key bias's, whose gradient is 0 in exact
#: arithmetic, against the tree's RMS), the loss within LM_TRAIN_LOSS
#: relative, grad_norm within LM_TRAIN_GNORM; MoE archs dropless, their
#: loss over the positions whose routing the card and the CPU share
LM_MM_LAYOUTS = (((512, 2048), (2048, 1024)),
                 ((16, 256, 128), (16, 128, 256)),
                 ((4, 16, 256, 128), (16, 128, 256)))
LM_MM_TOL = 2 ** -6
LM_SMOKE_OPT = {"lr": 1e-2, "warmup": 0, "total_steps": 10}
LM_GRAD_TREE, LM_GRAD_LEAF = 0.03, 0.05
LM_TRAIN_LOSS, LM_TRAIN_GNORM = 1e-3, 1e-2
#: the full width, remat on: LM_TRAIN_STEPS steps at LM_TRAIN (batch,
#: tokens, phase 13's prefill batch) on one batch (the loss must fall),
#: the median of steps 2 on; LM_ADAM_TRIALS updates timed alone; one step
#: in LM_MICRO microbatches against the full batch from one state (loss
#: within 1e-4 relative, grad_norm 1e-3); one step at LM_TRAIN_LONG
#: (train_4k's sequence) in LM_LONG_MICRO microbatches
LM_TRAIN_OPT = {"lr": 1e-3, "warmup": 0, "total_steps": 100}
LM_TRAIN, LM_TRAIN_STEPS, LM_ADAM_TRIALS = (8, 512), 5, 3
LM_MICRO, LM_MICRO_LOSS, LM_MICRO_GNORM = 4, 1e-4, 1e-3
LM_TRAIN_LONG, LM_LONG_MICRO = (2, 4096), 2
#: launch.train's restart at smoke width: LM_RESTART_STEPS steps, a
#: checkpoint every LM_RESTART_EVERY, the failure after LM_DIE_AT; under
#: --deterministic the restarted run's final checkpoint must equal a
#: straight run's bit for bit
LM_RESTART_STEPS, LM_RESTART_EVERY, LM_DIE_AT = 6, 2, 3
#: phase 15, the dry-run (``repro_torch.launch.dryrun``) on the host, on
#: meta: DRYRUN_LM_CELLS at full width and the Ising engines
#: DRYRUN_ISING on each shape, each on both production meshes.  Then
#: LM_ARCH at LM_TRAIN on a one-device mesh: the parameter and AdamW
#: bytes counted from the specs within DRYRUN_STATE_TOL of what
#: opt_init leaves allocated on the card, the FLOPs of one train step
#: counted on meta equal to those counted around the same step on the
#: card.  Then the 512-chip Ising cell DRYRUN_SHARD_CELL: one launch of
#: each family's shard kernel at the plan and extended shard that the
#: dry-run reports there (shard DRYRUN_SHARD_INDEX's index planes), 0
#: mismatches against its plain version
DRYRUN_LM_CELLS = (("internlm2-1.8b", "train_4k"),
                   ("xlstm-125m", "decode_32k"))
DRYRUN_ISING = ("multispin", "bitplane", "basic")
DRYRUN_STATE_TOL = 0.01
DRYRUN_SHARD_CELL = ("lat_256k", "multi")
DRYRUN_SHARD_INDEX = 511

#: phase 16, the LM train step on a mesh of several shards
#: (``repro_torch.train.sharding.place``: each shard holds its
#: ``NamedSharding.index`` pieces; each layer gathered whole on a shard,
#: its gradient cut back onto the pieces).  LM_MESH's four shards share
#: the card.  The smoke archs' one step (LM_SMOKE_OPT, make_batch's
#: LM_MESH_SMOKE rows x tokens) on the mesh against the card's one-shard
#: step from the same weights and batch: loss within LM_TRAIN_LOSS
#: relative, grad_norm LM_TRAIN_GNORM, each parameter within 2.1 lr and
#: LM_MESH_NEAR of them within 1e-4 (Adam's first update is about lr x
#: sign(g): a near-zero gradient rounded to the other sign moves its
#: parameter by 2 lr).  Then LM_ARCH at full width from phase 14's
#: weights and batch, LM_TRAIN_STEPS steps on LM_MESH: each step's loss
#: within LM_MESH_FOLLOW relative of phase 14's one-shard loss, the
#: median of steps 2 on, peak memory, each shard's state against
#: memory_per_device's count.  Before those steps, the first step's
#: gradients at full width from the same weights and batch: the mesh's
#: against one shard's, the global norm within LM_MESH_GNORM relative,
#: with the tree's relative RMS difference and the share of elements
#: whose sign differs (Adam's first update, about lr x sign(g), moves
#: each of those by 2 lr: where the losses part).  Then a planted fault,
#: shard LM_MESH_FAULT's gradient dropped (its logits detached, its loss
#: kept): its global norm must fail LM_MESH_GNORM, and the loss after
#: one step of it is set beside LM_MESH_FOLLOW.  Measured on an H100
#: (NVIDIA H100 80GB HBM3, 700.00 W): grad_norm 2.2e-4 relative, the
#: gradient tree 1.25 % relative RMS apart (the size of the card's bf16
#: rounding: phase 14's card against the CPU, 0.8-1.1 %), the sign
#: differing on 0.24 % of the elements; the losses 9.5e-4 apart at
#: most; the fault 13.7 % on grad_norm and 1.6e-2 on the next loss
LM_MESH = (2, 2)
LM_MESH_SMOKE = (4, 32)
LM_MESH_NEAR = 0.98
LM_MESH_FOLLOW = 2e-3
LM_MESH_GNORM = 1e-3
LM_MESH_FAULT = 3

def check(ok: bool, what: str) -> None:
    if not ok:
        raise RuntimeError(f"chip_smoke: {what}")


def profiled_spans(fn):
    """``fn()`` with tracing on, under ``torch.profiler`` (CPU and CUDA),
    the card synchronized before the profile closes: the trace's
    complete events, and its ``repro_torch/`` ranges by span name."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    import repro_torch.telemetry as tel
    from repro_torch.telemetry.trace import RANGE_PREFIX
    tel.enable()
    try:
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
    finally:
        tel.disable()
        tel.TRACER.clear()
    with tempfile.TemporaryDirectory() as d:
        path = os.path.join(d, "profile.json")
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = [e for e in json.load(f)["traceEvents"]
                      if e.get("ph") == "X"]
    ranges = {}
    for e in events:
        if e.get("cat") == "user_annotation" \
                and e["name"].startswith(RANGE_PREFIX):
            ranges.setdefault(e["name"][len(RANGE_PREFIX):], []).append(e)
    return events, ranges


def span_cost_us(n: int = 20000) -> dict:
    """Host microseconds of one empty span: off, traced, and traced
    under ``torch.profiler`` (a ``repro_torch/`` range besides)."""
    from torch.profiler import ProfilerActivity, profile

    import repro_torch.telemetry as tel

    def per_span():
        t = time.perf_counter()
        for _ in range(n):
            with tel.span("cost"):
                pass
        return (time.perf_counter() - t) / n * 1e6

    out = {"off": per_span()}
    tel.enable()
    try:
        out["traced"] = per_span()
        with profile(activities=[ProfilerActivity.CPU]):
            out["profiled"] = per_span()
    finally:
        tel.disable()
        tel.TRACER.clear()
    return out


def traced_run_checks(session, drive, timed_ms) -> None:
    """A ``run(TRACE_SWEEPS)`` of ``session`` (multispin_pallas at
    ``FULL_N``^2) untraced and traced: no host synchronization under
    sync debug mode 'error' either way; under ``torch.profiler`` its
    sweep kernels' launches inside the ``repro_torch/dispatch`` range,
    that inside ``repro_torch/session.run``'s; and a span's cost.
    ``drive`` and ``timed_ms`` are :func:`phase_10`'s."""
    import torch

    import repro_torch.telemetry as tel
    path = f"multispin_pallas {FULL_N}^2 run({TRACE_SWEEPS})"
    untraced_ms = drive(f"{path} untraced", "multispin", "k-sweep",
                        lambda: timed_ms(lambda: session.run(TRACE_SWEEPS),
                                         reps=1, warmup=False))

    def sync_checked(traced):
        def run():
            torch.cuda.synchronize()
            if traced:
                tel.enable()
            torch.cuda.set_sync_debug_mode("error")
            try:
                session.run(TRACE_SWEEPS)
            finally:
                torch.cuda.set_sync_debug_mode(0)
                tel.disable()
                tel.TRACER.clear()
        return run

    drive(f"{path} sync debug mode error", "multispin", "k-sweep",
          sync_checked(False))
    drive(f"{path} traced, sync debug mode error", "multispin", "k-sweep",
          sync_checked(True))
    tel.enable()
    try:
        traced_ms = drive(f"{path} traced", "multispin", "k-sweep",
                          lambda: timed_ms(lambda: session.run(TRACE_SWEEPS),
                                           reps=1, warmup=False))
    finally:
        tel.disable()
        tel.TRACER.clear()
    # under torch.profiler: the dispatch's kernel launches lie inside its
    # repro_torch/dispatch range, which lies inside repro_torch/session.run
    events, ranges = drive(f"{path} profiled", "multispin", "k-sweep",
                           lambda: profiled_spans(
                               lambda: session.run(TRACE_SWEEPS)))
    check(len(ranges.get("dispatch", ())) == 1
          and len(ranges.get("session.run", ())) == 1,
          f"{path} profiled: ranges {sorted(ranges)}")
    (dsp,), (run,) = ranges["dispatch"], ranges["session.run"]
    kernels = {e["args"].get("correlation") for e in events
               if e.get("cat") == "kernel"
               and "multispin_sweeps" in e["name"]}
    launches = [e for e in events if e.get("cat") == "cuda_runtime"
                and e["args"].get("correlation") in kernels]
    cost = span_cost_us()
    print(f"phase 10: {path}: untraced {untraced_ms:.3f} ms, traced "
          f"{traced_ms:.3f} ms; no host synchronization under sync debug "
          f"mode 'error', untraced and traced; {len(launches)} sweep "
          f"kernel launches in the profiled run, the dispatch range "
          f"{dsp['dur']:.1f} us inside session.run's {run['dur']:.1f} us; "
          f"a span costs {cost['off']:.3f} us off, {cost['traced']:.3f} us "
          f"traced, {cost['profiled']:.3f} us under torch.profiler")
    check(launches and len(launches) == len(kernels)
          and all(dsp["ts"] <= e["ts"]
                  and e["ts"] + e["dur"] <= dsp["ts"] + dsp["dur"]
                  for e in launches)
          and run["ts"] <= dsp["ts"]
          and dsp["ts"] + dsp["dur"] <= run["ts"] + run["dur"],
          f"{path} profiled: the sweep launches are not inside the "
          f"dispatch range, or it is not inside session.run's")


def phase_10(drive, timed_ms) -> None:
    """Telemetry, resilience and the checkpointer on the card: the
    supervised main path at half its side (preempted, its newest step
    corrupted, resumed under an injected transient fault and an injected
    demotion, to the uninterrupted digest), the chaos drill through the
    CLI (an ensemble; a 2 x 2 mesh resumed on 1 x 2), a real
    ``OutOfMemoryError`` and a shared-memory overflow demoting with the
    trajectory unchanged, the traced CLI run's counters, a traced run's
    spans (no host synchronization; its launches inside the
    ``repro_torch/dispatch`` range of a ``torch.profiler`` trace; a
    span's cost), and the weakscale rows' halo counters.
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

    # -- 10.1 the supervised main path ---------------------------------------
    sup_spec = dataclasses.replace(
        spec, lattice=LatticeSpec(SUPERVISE_N, SUPERVISE_N, init_p_up=1.0))
    t1 = time.perf_counter()
    ref = Session.open(sup_spec)
    ref.run(SUPERVISE_SWEEPS)
    t2 = time.perf_counter()
    want = ref.state_digest()
    digest_s = time.perf_counter() - t2
    print(f"phase 10: uninterrupted run({SUPERVISE_SWEEPS}) of "
          f"multispin_pallas {SUPERVISE_N}^2 digest {want}: the digest of "
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
    path = f"multispin_pallas {SUPERVISE_N}^2 supervised"
    try:
        with tempfile.TemporaryDirectory() as d:
            def stop(sup):
                if sup.session.step_count >= SUPERVISE_STOP:
                    sup.request_stop()

            def first():
                return Supervisor(sup_spec, d, every_sweeps=SUPERVISE_EVERY,
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
                    sup = Supervisor(sup_spec, d,
                                     every_sweeps=SUPERVISE_EVERY,
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
    traced_run_checks(session, drive, timed_ms)
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


def farm_specs():
    """Phase 11's jobs, each with the family and tier of the kernel its
    batch launches, in the farm's batch order: the bitplane job first, so
    that the coalescible jobs queue while it runs and form one batch
    however fast they are submitted."""
    from repro_torch.api import EngineSpec, LatticeSpec, MeshSpec, RunSpec
    out = [(RunSpec(lattice=LatticeSpec(FARM_BITPLANE_N, FARM_BITPLANE_N),
                    engine=EngineSpec("bitplane_pallas"),
                    temperature=BITPLANE_TEMPERATURE, seed=91),
            "bitplane", "k-sweep")]
    out += [(RunSpec(lattice=LatticeSpec(FARM_N, FARM_N, init_p_up=1.0),
                     engine=EngineSpec("multispin_pallas"),
                     temperature=1.5 + 0.125 * i, seed=20 + i),
             "multispin", "k-sweep") for i in range(FARM_K)]
    out.append((RunSpec(lattice=LatticeSpec(FARM_N, FARM_N, init_p_up=1.0),
                        engine=EngineSpec("basic_philox"),
                        temperature=TEMPERATURE, seed=92), "draws", "fill"))
    out.append((RunSpec(lattice=LatticeSpec(FARM_N, FARM_N, init_p_up=1.0),
                        engine=EngineSpec("stencil_pallas"),
                        temperature=TEMPERATURE, seed=93,
                        mesh=MeshSpec(FARM_MESH, ("data", "model"))),
                "stencil", "shard"))
    return out


def phase_11(drive, launches_by_path) -> None:
    """The sweep farm and the legacy entry point on the card: direct
    ``Session`` references of the farm's jobs; the crash drill through
    ``python -m repro_torch serve`` (SIGKILL mid-batch, restart, every
    job exactly once with its direct digest); the farm in process, a
    batch a path (the coalesced batch one launch a block of sweeps for
    all members, one dispatch a batch, a second wave from the runner
    pool); ``repro_torch.launch.simulate`` restored to its uninterrupted
    ``m=`` lines.  ``drive`` is :func:`main`'s, and ``launches_by_path``
    the counts it reads.  Raises on any failed gate."""
    import contextlib
    import io

    import torch

    import repro_torch.telemetry as tel
    from repro_torch.api import Session
    from repro_torch.ckpt import Checkpointer
    from repro_torch.launch import simulate
    from repro_torch.resilience import degrade, integrity
    from repro_torch.serve import SweepFarm, smoke
    from repro_torch.telemetry import diff_counters

    def counters():
        return tel.REGISTRY.snapshot()

    recovery_names = ("resilience.retry", "resident.demote")
    degrade.reset_demotions()
    jobs = farm_specs()
    specs = [spec for spec, _, _ in jobs]
    sizes = sorted({(s.engine.name, s.lattice.n) for s in specs})
    print(f"phase 11: the farm's jobs: {FARM_K} coalescible of "
          f"{FARM_N}^2 and {len(specs) - FARM_K} solo ({sizes}); "
          f"{FARM_SWEEPS} sweeps, chunk {FARM_CHUNK}, a checkpoint every "
          f"{FARM_EVERY}")

    # -- 11.1 direct references ----------------------------------------------
    t1 = time.perf_counter()
    refs = []
    for i, (spec, family, tier) in enumerate(jobs):
        def direct(spec=spec):
            s = Session.open(spec)
            s.run(FARM_SWEEPS)
            return s
        s = drive(f"farm reference {i} {spec.engine.name} "
                  f"{spec.lattice.n}^2", family, tier, direct)
        refs.append(s.state_digest())
        del s
    ref_s = time.perf_counter() - t1
    print(f"phase 11: direct references in {ref_s:.2f} s: {refs}")

    # -- 11.2 the crash drill through the CLI ---------------------------------
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory() as d:
        t1 = time.perf_counter()
        drill = smoke.crash_drill(os.path.join(d, "crash"), specs, refs,
                                  FARM_SWEEPS, chunk=FARM_CHUNK,
                                  every=FARM_EVERY, max_batch=FARM_K,
                                  min_jobs=FARM_K, timeout=600)
        drill_s = time.perf_counter() - t1
    records = drill["records"]
    submitted = {r["job"]: r["t"] for r in records if r["kind"] == "submit"}
    done = {r["job"]: r["t"] for r in records if r["kind"] == "done"}
    latency = {j: round(done[j] - t, 3) for j, t in submitted.items()}
    batches = []
    for r in records:
        if r["kind"] == "start":
            batches.append((r["batch"], len(r["jobs"]),
                            round(max(done[j] for j in r["jobs"]) - r["t"],
                                  3)))
    got = drill["counters"]
    unplanned = {k: got.get(k, 0) for k in recovery_names}
    print(f"phase 11: crash drill in {drill_s:.2f} s: start-up "
          f"{[round(x, 2) for x in drill['startup_s']]} s, jobs without a "
          f"done record at the kill {drill['outstanding']}; submit to done "
          f"(s) {latency}; batches (id, jobs, s from the start record to "
          f"its jobs' last done: a batch killed and resumed has two) "
          f"{batches}; the restarted server's "
          f"resilience.resume {got.get('resilience.resume', 0)}, "
          f"serve.completed {got.get('serve.completed', 0)}, {unplanned}")
    check(got.get("resilience.resume", 0) >= 1,
          "crash drill: the restart resumed no batch from its checkpoint")
    check(not any(unplanned.values()),
          f"crash drill: unplanned recovery {unplanned}")

    # -- 11.3 the farm in process: a batch a path, the runner pool -----------
    timings, crc_s = [], [0.0]
    real = (integrity.crc32c, Checkpointer._write)

    def timed_crc(data, value=0):
        t = time.perf_counter()
        try:
            return real[0](data, value)
        finally:
            crc_s[0] += time.perf_counter() - t

    def timed_write(*args, **kwargs):
        t = time.perf_counter()
        try:
            return real[1](*args, **kwargs)
        finally:
            timings.append(time.perf_counter() - t)

    integrity.crc32c = timed_crc
    Checkpointer._write = timed_write
    rows = []

    def run_batches(farm, wave, ids, want, groups):
        """Drive each batch of ``groups`` (job index ranges, the farm's
        batch order) as its own path; every job must complete with its
        direct digest."""
        for lo, hi in groups:
            _, family, tier = jobs[lo]
            crc0, ckpt0, c0 = crc_s[0], len(timings), counters()
            t1 = time.perf_counter()
            path = (f"farm wave {wave} batch of {hi - lo} "
                    f"{specs[lo].engine.name} {specs[lo].lattice.n}^2")
            check(drive(path, family, tier, farm.step, observes=True),
                  f"{path}: no batch ran")
            batch_s = time.perf_counter() - t1
            rows.append({"path": path, "batch_s": round(batch_s, 3),
                         "crc_s": round(crc_s[0] - crc0, 3),
                         "checkpoint_s": round(sum(timings[ckpt0:]), 3),
                         "dispatches": diff_counters(c0, counters()).get(
                             "dispatches", 0),
                         "launches": sum(
                             v for name, v in launches_by_path[path].items()
                             if name != COUNT_KERNEL)})
            for jid, digest in zip(ids[lo:hi], want[lo:hi]):
                job = farm.job(jid)
                check(job["status"] == "completed"
                      and job["digest"] == digest,
                      f"{path}: {jid} {job['status']} {job['digest']} "
                      f"{job['error']}, want {digest}")

    base = counters()
    try:
        with tempfile.TemporaryDirectory() as d:
            farm = SweepFarm(d, max_batch=FARM_K, chunk=FARM_SWEEPS,
                             ckpt_every_sweeps=FARM_EVERY)
            ids = [farm.submit({"spec": s.to_dict(), "sweeps": FARM_SWEEPS})
                   for s in specs]
            coalesced = (1, 1 + FARM_K)
            run_batches(farm, 0, ids, refs, [(0, 1), coalesced] + [
                (i, i + 1) for i in range(1 + FARM_K, len(jobs))])
            # the second wave: the coalesced jobs again, one batch on the
            # pooled runner
            ids = [None] + [farm.submit({"spec": s.to_dict(),
                                         "sweeps": FARM_SWEEPS})
                            for s in specs[1:1 + FARM_K]]
            run_batches(farm, 1, ids, refs, [coalesced])
            farm.close()
            starts = [r for r in farm.journal.records
                      if r["kind"] == "start"]
    finally:
        integrity.crc32c, Checkpointer._write = real
    got = diff_counters(base, counters())
    pool = {k: got.get(k, 0) for k in ("serve.cache_hit", "serve.cache_miss",
                                       "serve.coalesced", "serve.batches")}
    unplanned = {k: got.get(k, 0) for k in recovery_names}
    print(f"phase 11: the farm in process: {json.dumps(rows)}; start "
          f"records {[len(r['jobs']) for r in starts]}; dispatches "
          f"{got.get('dispatches', 0)}; {pool}; {unplanned}")
    check([len(r["jobs"]) for r in starts] == [1, FARM_K, 1, 1, FARM_K],
          f"farm: batches of {[len(r['jobs']) for r in starts]}")
    check(got.get("dispatches", 0) == len(starts)
          and all(r["dispatches"] == 1 for r in rows),
          f"farm: {got.get('dispatches', 0)} dispatches for {len(starts)} "
          f"batches at chunk >= sweeps")
    # every batch of coalescible jobs asks the pool (a lone job too, as
    # an ensemble of one): the first wave's miss, the second wave's hit
    asked = sum(1 for r in starts if r["key"] is not None)
    check(pool["serve.cache_hit"] == 1
          and pool["serve.cache_miss"] == asked - 1,
          f"farm: runner pool {pool} for {asked} coalescible batches")
    check(not any(unplanned.values()), f"farm: unplanned recovery "
          f"{unplanned}")
    blocks = math.ceil(FARM_SWEEPS / 2)
    want_launches = [blocks, blocks, 2 * FARM_SWEEPS,
                     math.prod(FARM_MESH) * blocks, blocks]   # k = 2
    check([r["launches"] for r in rows] == want_launches,
          f"farm: launches {[r['launches'] for r in rows]}, want "
          f"{want_launches} (k = 2)")

    # -- 11.4 the legacy driver ------------------------------------------------
    torch.cuda.empty_cache()
    sim_rows = []
    with tempfile.TemporaryDirectory() as d:
        ck = os.path.join(d, "ck.npz")
        argv = ["--size", str(SIM_N), "--temp", str(TEMPERATURE),
                "--measure-every", str(SIM_EVERY), "--engine", "multispin"]
        for label, extra in (
                ("uninterrupted", ["--sweeps", str(SIM_SWEEPS)]),
                ("checkpointed", ["--sweeps", str(SIM_CKPT), "--ckpt", ck]),
                ("restored", ["--sweeps", str(SIM_SWEEPS), "--ckpt", ck,
                              "--restore"])):
            out = io.StringIO()
            t1 = time.perf_counter()
            with contextlib.redirect_stdout(out):
                rc = drive(f"simulate {SIM_N}^2 {label}", "multispin",
                           "k-sweep", lambda: simulate.main(argv + extra))
            lines = out.getvalue().splitlines()
            sim_rows.append((label, rc, time.perf_counter() - t1, lines))
    for label, rc, seconds, lines in sim_rows:
        print(f"phase 11: simulate {SIM_N}^2 {label} ({seconds:.2f} s, exit "
              f"{rc}): " + " | ".join(lines))
    m_lines = [[l for l in lines if l.startswith("sweep")]
               for _, _, _, lines in sim_rows]
    check(all(rc == 0 for _, rc, _, _ in sim_rows),
          "simulate: a run failed")
    check(len(m_lines[0]) == SIM_SWEEPS // SIM_EVERY
          and m_lines[1] + m_lines[2] == m_lines[0],
          f"simulate: restored m lines {m_lines[1:]} against "
          f"{m_lines[0]}")


def phase_12(wrappers, launches_by_path, rates) -> None:
    """The performance contract: weakscale records with their roofline
    readings, the main paths' readings, the gate on the card's records
    and the four Ising examples on the card.  ``rates`` maps each main
    path's family to its single-mode ``run(200)`` flips/ns and k."""
    import contextlib
    import io

    import torch

    import numpy as np

    from repro_torch.core import multispin, observables
    from repro_torch.examples import (bitplane_replicas, multipod_sim,
                                      phase_transition, quickstart)
    from repro_torch.kernels.bitplane import run_sweeps_bitplane_kernel
    from repro_torch.kernels.multispin import run_sweeps_multispin
    from repro_torch.kernels.stencil import run_sweeps_stencil
    from repro_torch.launch import roofline
    from repro_torch.perf import gate as perf_gate

    def quiet(argv):
        out = io.StringIO()
        with contextlib.redirect_stdout(out):
            code = perf_gate.main(argv)
        return code, out.getvalue().strip().splitlines()[-1]

    # -- 12.1 weakscale records: every row's reading in (0, 100] -----------
    env = dict(os.environ, PYTHONPATH=str(SRC))
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory() as d:
        paths = []
        for i in range(2):
            path = os.path.join(d, f"weakscale_{i}.json")
            t1 = time.perf_counter()
            proc = subprocess.run(
                [sys.executable, "-m", "repro_torch.dist.weakscale",
                 "--devices", ",".join(map(str, WEAKSCALE_SHARDS)),
                 "--base-n", str(PERF_BASE_N), "--cols", str(PERF_COLS),
                 "--sweeps", str(PERF_SWEEPS), "--trials", str(PERF_TRIALS),
                 "--json", path], env=env, capture_output=True, text=True,
                timeout=600)
            seconds = time.perf_counter() - t1
            if proc.returncode != 0:
                print(proc.stdout[-4000:] + proc.stderr[-4000:],
                      file=sys.stderr)
            check(proc.returncode == 0,
                  f"weakscale record {i}: exit {proc.returncode}")
            with open(path) as f:
                record = json.load(f)
            check(record["meta"]["backend"] == "cuda",
                  f"weakscale record {i}: backend {record['meta']}")
            for row in record["rows"]:
                dv = row["derived"]
                pct = dv.get("pct_of_roofline")
                peak = roofline.roofline_flips_per_ns(dv["engine"], "cuda",
                                                      k=dv["halo_k"])
                print(f"phase 12: weakscale record {i} ({seconds:.2f} s): "
                      f"{row['name']} k = {dv['halo_k']}: "
                      f"{dv['flips_per_ns']:.2f} flips/ns, {pct} % of "
                      f"{peak:.1f}")
                check(pct is not None and 0.0 < pct <= 100.0,
                      f"weakscale {row['name']}: pct_of_roofline {pct}")
            paths.append(path)

        # -- 12.2 the main paths' readings -----------------------------------
        for family, (rate, k) in rates.items():
            engine = FAMILY_ENGINE[family]
            pct = roofline.pct_of_roofline(rate, engine, "cuda", k=k)
            print(f"phase 12: roofline {engine} run(200) {rate:.2f} "
                  f"flips/ns at k = {k}: {pct:.2f} % of "
                  f"{roofline.roofline_flips_per_ns(engine, 'cuda', k=k):.1f}"
                  f" (predicted {ROOFLINE_PREDICTED[family]} %)")
            check(0.0 < pct <= 100.0, f"{engine}: reading {pct} %")

        # -- 12.3 the gate on the card's records -----------------------------
        first, second = paths
        low, high = (os.path.join(d, f"budgets_{x}.json")
                     for x in ("low", "high"))
        steps = [("init budgets", ["--init-budgets", low, first], 0),
                 ("first against itself, its budgets",
                  [first, first, "--budgets", low], 0),
                 ("init budgets at 2.0", ["--init-budgets", high, first,
                                          "--safety", "2.0"], 0),
                 ("first against itself, budgets at 2.0",
                  [first, first, "--budgets", high], 1),
                 ("the same, advisory",
                  [first, first, "--budgets", high, "--advisory"], 0)]
        for what, argv, want in steps:
            code, last = quiet(argv)
            print(f"phase 12: gate {what}: exit {code} ({last})")
            check(code == want, f"gate {what}: exit {code}, want {want}")
        with open(first) as f:
            record = json.load(f)
        verdicts = perf_gate.gate(record, record,
                                  perf_gate.load_budgets(high))
        timed = sorted(r["name"] for r in record["rows"]
                       if perf_gate.throughput(r)[1] is not None)
        check(sorted(v.name for v in verdicts.by_status("budget")) == timed,
              "gate: not every throughput row under budgets at 2.0 is "
              "'budget'")
        out = io.StringIO()
        with contextlib.redirect_stdout(out):
            code = perf_gate.main([first, second, "--advisory"])
        print("phase 12: the second record against the first (run-to-run "
              f"noise, advisory, exit {code}):")
        print(out.getvalue().rstrip())

    # -- 12.4 the raw sweeps on the card against the CPU ----------------------
    for run, update, planes in (
            (run_sweeps_stencil, "stencil_update",
             lambda g: (g.integers(0, 2, (SMALL_N, SMALL_N // 2)) * 2 - 1)
             .astype(np.int8)),
            (run_sweeps_multispin, "multispin_update",
             lambda g: multispin.pack_plane(torch.from_numpy(
                 (g.integers(0, 2, (SMALL_N, SMALL_N // 2)) * 2 - 1)
                 .astype(np.int8))).numpy()),
            (run_sweeps_bitplane_kernel, "bitplane_update",
             lambda g: g.integers(-2 ** 31, 2 ** 31,
                                  (SMALL_N, SMALL_N // 2), dtype=np.int32))):
        g = np.random.default_rng(12)
        host = [torch.from_numpy(planes(g)) for _ in range(2)]
        card = [p.cuda() for p in host]
        wrappers[update].launches = 0
        run(*card, 1 / TEMPERATURE, RAW_SWEEPS, seed=SEED, start_offset=7)
        torch.cuda.synchronize()
        launched = wrappers[update].launches
        run(*host, 1 / TEMPERATURE, RAW_SWEEPS, seed=SEED, start_offset=7)
        same = all(torch.equal(c.cpu(), h) for c, h in zip(card, host))
        print(f"phase 12: {run.__name__} {SMALL_N}^2, {RAW_SWEEPS} sweeps: "
              f"{launched} launches of {update}; the CPU's planes: {same}")
        check(same and launched == 2 * RAW_SWEEPS,
              f"{run.__name__}: card against CPU {same}, {launched} "
              f"launches")

    # -- 12.5 the four examples on the card ----------------------------------
    examples = {}
    for name, module in (("quickstart", quickstart),
                         ("phase_transition", phase_transition),
                         ("bitplane_replicas", bitplane_replicas),
                         ("multipod_sim", multipod_sim)):
        for wrapper in wrappers.values():
            wrapper.launches = 0
        out = io.StringIO()
        t1 = time.perf_counter()
        with contextlib.redirect_stdout(out):
            examples[name] = module.main([])
        torch.cuda.synchronize()
        path = f"example {name}"
        launches_by_path[path] = {n: w.launches for n, w in wrappers.items()}
        print(f"phase 12: {path} ({time.perf_counter() - t1:.2f} s): "
              + " | ".join(out.getvalue().splitlines()))
        print(f"launches on path {path!r}: {launches_by_path[path]}")
    launched = examples["quickstart"]["kernel_launches"]
    check(launched == 2 * quickstart.KERNEL_SWEEPS,
          f"quickstart: {launched} launches of multispin_update for "
          f"{quickstart.KERNEL_SWEEPS} sweeps")
    onsager = observables.onsager_magnetization(1.5)
    i = phase_transition.TEMPS.index(1.5)
    for size, (m, _) in examples["phase_transition"].items():
        check(abs(m[i] - onsager) < EXAMPLE_M_TOLERANCE,
              f"phase_transition L={size}: |m| {m[i]} at T = 1.5")
    check(examples["multipod_sim"]["same"], "multipod_sim: not bit-exact")


def lm_errors(got, want) -> tuple:
    """(max absolute error, relative RMS error) of card logits against
    the CPU's, both as f32 on the host."""
    got, want = got.float().cpu(), want.float()
    diff = got - want
    rel = float(diff.pow(2).mean().sqrt() / want.pow(2).mean().sqrt())
    return float(diff.abs().max()), rel


def lm_smoke_batch(torch, cfg, seed: int) -> dict:
    """A smoke batch from numpy (seed): tokens, and the stub frontends'
    frames or patch embeddings."""
    import numpy as np
    r = np.random.default_rng(seed)
    text = LM_SMOKE_TOKENS - (cfg.prefix_len if cfg.family == "vlm" else 0)
    batch = {"tokens": torch.tensor(r.integers(
        0, cfg.vocab, (LM_SMOKE_BATCH, text)).astype(np.int32))}
    if cfg.family == "audio":
        batch["frames"] = torch.tensor(r.standard_normal(
            (LM_SMOKE_BATCH, cfg.enc_seq, cfg.d_model)).astype(np.float32))
    if cfg.family == "vlm":
        batch["patch_emb"] = torch.tensor(r.standard_normal(
            (LM_SMOKE_BATCH, cfg.prefix_len, cfg.d_model)).astype(
                np.float32))
    return batch


def phase_13() -> dict:
    """The LM stack's inference path on the card: every architecture at
    smoke width against the CPU, then internlm2-1.8b at full width.
    Returns the full width's numbers."""
    import copy

    import torch

    from repro_torch.configs import ARCH_IDS, SHAPES, get_config, \
        get_smoke_config
    from repro_torch.data import make_batch
    from repro_torch.models import (decode_step, forward, init_cache,
                                    init_model)
    from repro_torch.models import moe as lm_moe
    from repro_torch.models.model import encode_audio, param_count
    from repro_torch.train import make_prefill_step, make_serve_step

    card = torch.device("cuda")
    cpu = torch.device("cpu")

    def on(params, device):
        return copy.deepcopy(params).to(device)

    def to(batch, device):
        return {k: v.to(device) for k, v in batch.items()}

    def new_cache(cfg, params, batch, b, max_len, device, **kw):
        enc = None
        if cfg.family == "audio":
            with torch.no_grad():
                enc = encode_audio(cfg, params, batch["frames"].to(device))
        return init_cache(cfg, b, max_len, enc_out=enc,
                          params=params if enc is not None else None,
                          device=device, **kw)

    # -- 13.1 every architecture at smoke width, the card against the CPU
    rows = {}
    for i, arch in enumerate(ARCH_IDS):
        cfg = get_smoke_config(arch)
        moe = cfg.family == "moe"
        params_cpu = init_model(cfg, 100 + i, device=cpu)
        params_card = on(params_cpu, card)
        batch = lm_smoke_batch(torch, cfg, 200 + i)
        with torch.no_grad():
            want, _ = forward(cfg, params_cpu, batch, remat=False,
                              dropless_moe=moe)
            got, _ = forward(cfg, params_card, to(batch, card), remat=False,
                             dropless_moe=moe)
        torch.cuda.synchronize()
        check(bool(torch.isfinite(got).all()), f"{arch}: card logits "
              "not finite")
        fwd_err, fwd_rel = lm_errors(got, want)
        limit = LM_MOE_REL_RMS if moe else LM_REL_RMS
        check(fwd_rel <= limit, f"{arch}: card forward logits off the "
              f"CPU's by {fwd_rel:.4g} relative RMS (limit {limit})")
        # greedy serve steps on one pair of caches, decode_step's logits
        # on another, all four fed the CPU's tokens
        step = make_serve_step(cfg)
        caches = {(where, kind): new_cache(cfg, p, batch, LM_SMOKE_BATCH,
                                           LM_SERVE_STEPS, d)
                  for where, d, p in (("cpu", cpu, params_cpu),
                                      ("card", card, params_card))
                  for kind in ("logits", "serve")}
        tok = batch["tokens"][:, :1]
        compared = agreed = 0
        dec_err = dec_rel = 0.0
        for _ in range(LM_SERVE_STEPS):
            logits_cpu, _ = decode_step(cfg, params_cpu,
                                        caches["cpu", "logits"], tok)
            logits_card, _ = decode_step(cfg, params_card,
                                         caches["card", "logits"],
                                         tok.to(card))
            nxt_cpu, _ = step(params_cpu, caches["cpu", "serve"], tok)
            nxt_card, _ = step(params_card, caches["card", "serve"],
                               tok.to(card))
            e, r = lm_errors(logits_card, logits_cpu)
            dec_err, dec_rel = max(dec_err, e), max(dec_rel, r)
            top2 = logits_cpu[:, -1].float().topk(2, dim=-1).values
            sure = (top2[:, 0] - top2[:, 1]) > LM_MARGIN
            compared += int(sure.sum())
            agreed += int((nxt_card.cpu()[:, 0] == nxt_cpu[:, 0])[sure].sum())
            check(torch.equal(nxt_cpu, logits_cpu[:, -1].argmax(
                -1, keepdim=True).to(nxt_cpu.dtype)), f"{arch}: the serve "
                "step's token is not decode_step's argmax")
            tok = nxt_cpu
        check(dec_rel <= limit, f"{arch}: card decode logits off the CPU's "
              f"by {dec_rel:.4g} relative RMS (limit {limit})")
        check(agreed == compared, f"{arch}: {compared - agreed} of "
              f"{compared} sure greedy tokens differ on the card")
        # prefill against decode on the card (teacher-forced, dropless);
        # not the vlm, whose decode has no patch prefix in its cache (as
        # in JAX)
        consistency = None
        if cfg.family != "vlm":
            prefix = {k: v[:, :LM_SERVE_STEPS] if k == "tokens" else v
                      for k, v in batch.items()}
            with torch.no_grad():
                full, _ = forward(cfg, params_card, to(prefix, card),
                                  remat=False, dropless_moe=True)
            c = new_cache(cfg, params_card, batch, LM_SMOKE_BATCH,
                          LM_SERVE_STEPS, card)
            outs = []
            for t in range(LM_SERVE_STEPS):
                lg, c = decode_step(cfg, params_card, c,
                                    prefix["tokens"][:, t:t + 1].to(card))
                outs.append(lg[:, 0])
            dec = torch.stack(outs, dim=1)
            consistency = float((dec - full).abs().max())
            check(torch.allclose(dec, full, rtol=LM_CONSISTENCY_TOL,
                                 atol=LM_CONSISTENCY_TOL),
                  f"{arch}: prefill and decode disagree on the card")
        rows[arch] = {"forward_max_abs": fwd_err, "forward_rel_rms": fwd_rel,
                      "decode_max_abs": dec_err, "decode_rel_rms": dec_rel,
                      "greedy_sure": compared,
                      "prefill_decode_max_abs": consistency}
        del params_card, caches
    print("phase 13: smoke archs, card against CPU: " + json.dumps(rows))

    # -- 13.2 the ring cache and the two MoE layouts on the card ------------
    cfg = get_smoke_config(LM_ARCH)
    params = init_model(cfg, 7, device=card)
    toks = torch.randint(0, cfg.vocab, (LM_SMOKE_BATCH, LM_RING_STEPS),
                         generator=torch.Generator().manual_seed(7)).to(card)
    full = init_cache(cfg, LM_SMOKE_BATCH, LM_RING_STEPS, device=card)
    ring = init_cache(cfg, LM_SMOKE_BATCH, LM_RING_STEPS,
                      window=LM_RING_WINDOW, device=card)
    check(ring["kv"]["k"].shape[2] == LM_RING_WINDOW, "ring cache size")
    ring_err = 0.0
    for t in range(LM_RING_STEPS):
        lf, full = decode_step(cfg, params, full, toks[:, t:t + 1],
                               sliding_window=LM_RING_WINDOW)
        lr, ring = decode_step(cfg, params, ring, toks[:, t:t + 1],
                               sliding_window=LM_RING_WINDOW)
        ring_err = max(ring_err, float((lf - lr).abs().max()))
        check(torch.allclose(lr, lf, rtol=2e-2, atol=2e-2),
              f"ring cache against full cache at step {t}")
    mcfg = get_smoke_config("deepseek-moe-16b")
    mparams = init_model(mcfg, 8, device=card)["moe_blocks"][0]["moe"]
    x = torch.randn((LM_SMOKE_BATCH, LM_SMOKE_TOKENS, mcfg.d_model),
                    generator=torch.Generator().manual_seed(8)).to(
                        card, torch.bfloat16)
    dropless = float(mcfg.n_routed)
    with torch.no_grad():
        y_global, a_global = lm_moe.moe_block(mparams, x, top_k=mcfg.top_k,
                                              capacity_factor=dropless)
        y_seq, a_seq = lm_moe._moe_per_sequence(mparams, x,
                                                top_k=mcfg.top_k,
                                                capacity_factor=dropless)
    moe_err = float((y_global.float() - y_seq.float()).abs().max())
    check(moe_err <= 1e-2 * float(y_seq.float().abs().max())
          and abs(float(a_global) - float(a_seq)) < 1e-6,
          f"moe_block's layouts disagree dropless: {moe_err}")
    print(f"phase 13: ring cache (window {LM_RING_WINDOW}, "
          f"{LM_RING_STEPS} steps) against full: max abs {ring_err:.4g}; "
          f"moe_block global against per-sequence (dropless): max abs "
          f"{moe_err:.4g}")
    del params, mparams

    # -- 13.3 internlm2-1.8b at full width ---------------------------------
    cfg = get_config(LM_ARCH)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = init_model(cfg, 11, device=card)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    n_params = param_count(params)
    weights_bytes = torch.cuda.memory_allocated()

    prefill = make_prefill_step(cfg)
    b, s = LM_PREFILL
    batch = make_batch(cfg, SHAPES["prefill_32k"], batch_override=b,
                       seq_override=s, device=card)
    cuda_events(torch, lambda: prefill(params, batch))      # warm-up
    torch.cuda.reset_peak_memory_stats()
    prefill_ms, logits = cuda_events(torch,
                                     lambda: prefill(params, batch),
                                     LM_PREFILL_TRIALS)
    prefill_peak = torch.cuda.max_memory_allocated()
    check(tuple(logits.shape) == (b, s, cfg.vocab)
          and bool(torch.isfinite(logits).all()),
          f"full-width prefill logits {tuple(logits.shape)} not finite")
    del logits

    serve = make_serve_step(cfg)
    tok = batch["tokens"][:, :1]
    cache = init_cache(cfg, b, LM_MAX_LEN, device=card)
    cuda_events(torch, lambda: serve(params, cache, tok))   # warm-up
    cache = init_cache(cfg, b, LM_MAX_LEN, device=card)
    torch.cuda.reset_peak_memory_stats()
    generated = []

    def decode_all():
        nonlocal tok
        for _ in range(LM_DECODE):
            tok, _ = serve(params, cache, tok)
            generated.append(tok)
        return tok

    decode_ms, _ = cuda_events(torch, decode_all)
    decode_peak = torch.cuda.max_memory_allocated()
    check(cache["length"] == LM_DECODE, "decode cache length")
    gen = torch.cat(generated, dim=1)
    check(tuple(gen.shape) == (b, LM_DECODE) and bool(
        ((gen >= 0) & (gen < cfg.vocab)).all()), "decoded tokens")
    del cache

    b2, s2 = LM_LONG
    long_batch = make_batch(cfg, SHAPES["prefill_32k"], batch_override=b2,
                            seq_override=s2, device=card)
    cuda_events(torch, lambda: prefill(params, long_batch))  # warm-up
    torch.cuda.reset_peak_memory_stats()
    long_ms, logits = cuda_events(torch,
                                  lambda: prefill(params, long_batch))
    long_peak = torch.cuda.max_memory_allocated()
    check(tuple(logits.shape) == (b2, s2, cfg.vocab)
          and bool(torch.isfinite(logits).all()),
          "full-width 8192-token prefill logits not finite")
    del logits, params

    # the full width against the CPU at LM_CPU_LAYERS layers
    shallow = cfg.with_overrides(n_layers=LM_CPU_LAYERS)
    params_cpu = init_model(shallow, 12, device=cpu)
    params_card = on(params_cpu, card)
    b3, s3 = LM_CPU_TOKENS
    small = make_batch(shallow, SHAPES["prefill_32k"], batch_override=b3,
                       seq_override=s3, device=cpu)
    want = make_prefill_step(shallow)(params_cpu, small)
    got = make_prefill_step(shallow)(params_card, to(small, card))
    width_err, width_rel = lm_errors(got, want)
    check(width_rel <= LM_REL_RMS, f"full width at {LM_CPU_LAYERS} layers: "
          f"card logits off the CPU's by {width_rel:.4g} relative RMS")
    del params_card, params_cpu

    out = {"arch": LM_ARCH, "params": n_params,
           "weights_bytes": weights_bytes, "init_s": init_s,
           "prefill": {"batch": b, "tokens": s, "ms": prefill_ms,
                       "tokens_per_s": b * s / prefill_ms * 1e3,
                       "peak_bytes": prefill_peak},
           "decode": {"batch": b, "max_len": LM_MAX_LEN,
                      "tokens": LM_DECODE,
                      "ms_per_token": decode_ms / LM_DECODE,
                      "tokens_per_s": b * LM_DECODE / decode_ms * 1e3,
                      "peak_bytes": decode_peak},
           "long_prefill": {"batch": b2, "tokens": s2, "ms": long_ms,
                            "tokens_per_s": b2 * s2 / long_ms * 1e3,
                            "peak_bytes": long_peak},
           "cpu_check": {"layers": LM_CPU_LAYERS, "tokens": list(
               LM_CPU_TOKENS), "max_abs": width_err, "rel_rms": width_rel}}
    print(f"phase 13: {LM_ARCH} full width ({n_params} parameters, "
          f"{weights_bytes} B, init {init_s:.2f} s): prefill {b} x {s} "
          f"{prefill_ms:.3f} ms ({out['prefill']['tokens_per_s']:.1f} "
          f"tokens/s, peak {prefill_peak} B); decode {LM_DECODE} tokens "
          f"at batch {b} from a cache of {LM_MAX_LEN}: "
          f"{out['decode']['ms_per_token']:.3f} ms a token "
          f"({out['decode']['tokens_per_s']:.1f} tokens/s, peak "
          f"{decode_peak} B); prefill {b2} x {s2} {long_ms:.3f} ms (peak "
          f"{long_peak} B); {LM_CPU_LAYERS} layers against the CPU: max "
          f"abs {width_err:.4g}, relative RMS {width_rel:.4g}")
    return out


def cuda_events(torch, fn, trials=1):
    """fn() run trials times between two CUDA events: (ms a run, last
    result).  ``cuda_events.host_ms`` holds the host's ms a run to the
    last return, before the wait for the card: near the events' time
    where the host, not the card, sets the pace."""
    start, end = (torch.cuda.Event(enable_timing=True) for _ in "ab")
    t0 = time.perf_counter()
    start.record()
    for _ in range(trials):
        out = fn()
    end.record()
    cuda_events.host_ms = (time.perf_counter() - t0) * 1e3 / trials
    torch.cuda.synchronize()
    return start.elapsed_time(end) / trials, out


def grad_errors(names, got, want) -> tuple:
    """(the gradient tree's relative RMS error, the worst leaf's, that
    leaf's name) of two lists of gradients on the host; a key bias
    (``bk``: 0 in exact arithmetic) against the tree's RMS."""
    sq = sum(float((g - w).pow(2).sum()) for g, w in zip(got, want))
    norm = sum(float(w.pow(2).sum()) for w in want)
    tree_rms = math.sqrt(norm / sum(w.numel() for w in want))
    worst, worst_name = 0.0, None
    for name, g, w in zip(names, got, want):
        scale = tree_rms if name.endswith(".bk") else float(
            w.pow(2).mean().sqrt())
        err = float((g - w).pow(2).mean().sqrt()) / max(scale, 1e-30)
        if err > worst:
            worst, worst_name = err, name
    return math.sqrt(sq / norm), worst, worst_name


def phase_14() -> dict:
    """The LM stack's training path on the card: the product's backward
    against its CPU plain version, every architecture's train step at
    smoke width against the CPU, internlm2-1.8b training at full width,
    and ``launch.train``'s restart.  Returns the full width's numbers."""
    import copy
    import statistics

    import numpy as np
    import torch

    from repro_torch.configs import ARCH_IDS, SHAPES, get_config, \
        get_smoke_config
    from repro_torch.data import make_batch
    from repro_torch.models import forward, init_model
    from repro_torch.models import layers as lm_layers
    from repro_torch.models import moe as lm_moe
    from repro_torch.train import (OptConfig, cross_entropy, make_loss_fn,
                                   make_train_step, opt_init)
    from repro_torch.train import optim as lm_optim

    card = torch.device("cuda")
    cpu = torch.device("cpu")
    out = {}

    # -- 14.1 the product's backward, card against the CPU plain version
    gen = torch.Generator().manual_seed(14)
    mm_rows = []
    for a_shape, b_shape in LM_MM_LAYOUTS:
        a0 = torch.randn(a_shape, generator=gen).to(torch.bfloat16)
        w0 = torch.randn(b_shape, generator=gen)       # an f32 parameter
        grads = []                                     # cpu, card
        for where in (cpu, card):
            a = a0.to(where, copy=True).requires_grad_(True)
            w = w0.to(where, copy=True).requires_grad_(True)
            y = lm_layers.mm(a, w)
            g = torch.randn(y.shape, generator=torch.Generator().manual_seed(
                15)).to(where)
            y.backward(g)
            grads.append((a.grad.float().cpu(), w.grad.cpu()))
        errs = []
        for got, want in zip(grads[1], grads[0]):
            errs.append(float((got - want).abs().max()
                              / want.abs().max()))
        check(max(errs) <= LM_MM_TOL, f"mm backward at {a_shape} x "
              f"{b_shape}: card off the CPU by {errs} (limit {LM_MM_TOL})")
        mm_rows.append({"a": list(a_shape), "b": list(b_shape),
                        "rel_max_err_a": errs[0], "rel_max_err_b": errs[1]})
    print("phase 14: mm backward, card against CPU: " + json.dumps(mm_rows))
    out["mm_backward"] = mm_rows

    # -- 14.2 every architecture's train step at smoke width ---------------
    def routes(fn):
        calls, route = [], lm_moe._route

        def recording(params, x, top_k):
            probs, gates, experts = route(params, x, top_k)
            calls.append(experts.cpu())
            return probs, gates, experts
        lm_moe._route = recording
        try:
            fn()
        finally:
            lm_moe._route = route
        return calls

    def masked_loss(cfg, where, aux_weight):
        def loss_fn(params, batch):
            logits, aux = forward(cfg, params, batch, dropless_moe=True)
            mask = where.to(logits.device)
            loss = cross_entropy(logits[mask][None],
                                 batch["labels"][mask][None])
            return loss + aux_weight * aux, (loss, aux)
        return loss_fn

    rows = {}
    for i, arch in enumerate(ARCH_IDS):
        cfg = get_smoke_config(arch)
        params_cpu = init_model(cfg, 300 + i, device=cpu)
        params_card = copy.deepcopy(params_cpu).to(card)
        batch = lm_smoke_batch(torch, cfg, 400 + i)
        batch["labels"] = torch.tensor(np.random.default_rng(500 + i).integers(
            0, cfg.vocab, (LM_SMOKE_BATCH, LM_SMOKE_TOKENS)).astype(np.int32))
        loss_fn, compared = None, LM_SMOKE_BATCH * LM_SMOKE_TOKENS
        if cfg.family == "moe":
            with torch.no_grad():
                on_cpu = routes(lambda: forward(cfg, params_cpu, batch,
                                                dropless_moe=True))
                on_card = routes(lambda: forward(
                    cfg, params_card, {k: v.to(card) for k, v in
                                       batch.items()}, dropless_moe=True))
            same = torch.ones((LM_SMOKE_BATCH, LM_SMOKE_TOKENS),
                              dtype=torch.bool)
            for a, b in zip(on_cpu, on_card):
                same &= (a.sort(-1).values == b.sort(-1).values).all(
                    -1).reshape(same.shape)
            where = torch.cummin(same.int(), dim=1).values.bool()
            compared = int(where.sum())
            check(compared >= LM_SMOKE_TOKENS, f"{arch}: the card routes "
                  f"{compared} positions as the CPU does")
            loss_fn = masked_loss(cfg, where, 0.01 if bool(where.all())
                                  else 0.0)
        got = {}
        for name, params in (("cpu", params_cpu), ("card", params_card)):
            saved = []

            def keep(grads):
                saved.append([g.detach().float().cpu().clone()
                              for g in grads])
                return grads
            step = make_train_step(cfg, OptConfig(**LM_SMOKE_OPT),
                                   grad_sync=keep, loss_fn=loss_fn)
            b = {k: v.to(params["embed"]["table"].device)
                 for k, v in batch.items()}
            _, _, m = step(params, opt_init(params), b)
            got[name] = ({k: float(v) for k, v in m.items()}, saved[0])
        names = [n for n, _ in params_cpu.named_parameters()]
        tree_err, leaf_err, leaf = grad_errors(names, got["card"][1],
                                               got["cpu"][1])
        (mc, _), (mg, _) = got["cpu"], got["card"]
        loss_rel = abs(mg["loss"] - mc["loss"]) / abs(mc["loss"])
        gnorm_rel = abs(mg["grad_norm"] - mc["grad_norm"]) / mc["grad_norm"]
        check(math.isfinite(mg["loss"]) and loss_rel <= LM_TRAIN_LOSS,
              f"{arch}: card loss {mg['loss']} against the CPU's "
              f"{mc['loss']}")
        check(gnorm_rel <= LM_TRAIN_GNORM, f"{arch}: card grad_norm "
              f"{mg['grad_norm']} against the CPU's {mc['grad_norm']}")
        check(tree_err <= LM_GRAD_TREE and leaf_err <= LM_GRAD_LEAF,
              f"{arch}: card gradients off the CPU's: tree {tree_err:.4g}, "
              f"leaf {leaf} {leaf_err:.4g}")
        rows[arch] = {"loss": mg["loss"], "loss_rel": loss_rel,
                      "aux": mg["aux"], "grad_norm_rel": gnorm_rel,
                      "grad_rel_rms": tree_err, "worst_leaf": leaf,
                      "worst_leaf_rel_rms": leaf_err,
                      "positions": compared}
        del params_card
    print("phase 14: smoke archs' train step, card against CPU: "
          + json.dumps(rows))
    out["smoke"] = rows

    # -- 14.3 internlm2-1.8b at full width, remat on ----------------------
    cfg = get_config(LM_ARCH)
    ocfg = OptConfig(**LM_TRAIN_OPT)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    params = init_model(cfg, 13, device=card)
    opt = opt_init(params)
    state_bytes = torch.cuda.memory_allocated()
    b, s = LM_TRAIN
    batch = make_batch(cfg, SHAPES["train_4k"], batch_override=b,
                       seq_override=s, device=card)
    step = make_train_step(cfg, ocfg, remat=True)
    losses, step_ms, host_ms = [], [], []
    for _ in range(LM_TRAIN_STEPS):
        ms, (params, opt, m) = cuda_events(torch, lambda: step(params, opt,
                                                                batch))
        step_ms.append(ms)
        host_ms.append(cuda_events.host_ms)
        losses.append(float(m["loss"]))
    train_peak = torch.cuda.max_memory_allocated()
    check(all(math.isfinite(x) for x in losses) and losses[-1] < losses[0],
          f"full-width training: the loss did not fall: {losses}")
    median_ms = statistics.median(step_ms[1:])

    # the optimizer update alone, on this batch's gradients
    plist = list(params.parameters())
    total, _ = make_loss_fn(cfg)(params, batch)
    total.backward()
    grads = [p.grad for p in plist]
    adam_ms = statistics.median(
        cuda_events(torch, lambda: lm_optim.update(ocfg, grads, params,
                                                   opt))[0]
        for _ in range(LM_ADAM_TRIALS))
    for p in plist:
        p.grad = None
    del grads, total

    # microbatches against the full batch, from one state
    twin, twin_opt = copy.deepcopy(params), copy.deepcopy(opt)
    full_ms, (_, _, mf) = cuda_events(torch, lambda: step(params, opt,
                                                          batch))
    micro_step = make_train_step(cfg, ocfg, remat=True,
                                 microbatches=LM_MICRO)
    micro_ms, (_, _, mm_) = cuda_events(torch, lambda: micro_step(
        twin, twin_opt, batch))
    micro_host_ms = cuda_events.host_ms
    mf = {k: float(v) for k, v in mf.items()}
    mm_ = {k: float(v) for k, v in mm_.items()}
    micro_loss = abs(mf["loss"] - mm_["loss"]) / abs(mf["loss"])
    micro_gnorm = abs(mf["grad_norm"] - mm_["grad_norm"]) / mf["grad_norm"]
    check(micro_loss <= LM_MICRO_LOSS and micro_gnorm <= LM_MICRO_GNORM,
          f"microbatches {LM_MICRO} against the full batch: loss "
          f"{mm_['loss']} / {mf['loss']}, grad_norm {mm_['grad_norm']} / "
          f"{mf['grad_norm']}")
    del twin, twin_opt

    # one step at train_4k's sequence in microbatches (JAX's H9 lever)
    b2, s2 = LM_TRAIN_LONG
    long_batch = make_batch(cfg, SHAPES["train_4k"], batch_override=b2,
                            seq_override=s2, device=card)
    long_step = make_train_step(cfg, ocfg, remat=True,
                                microbatches=LM_LONG_MICRO)
    torch.cuda.reset_peak_memory_stats()
    long_ms, (_, _, ml) = cuda_events(torch, lambda: long_step(
        params, opt, long_batch))
    long_host_ms = cuda_events.host_ms
    long_peak = torch.cuda.max_memory_allocated()
    check(math.isfinite(float(ml["loss"])), "the 2 x 4096 step's loss")
    del params, opt, batch, long_batch
    torch.cuda.empty_cache()

    tokens = b * s
    full = {"arch": LM_ARCH, "batch": b, "tokens": s,
            "state_bytes": state_bytes, "losses": losses,
            "step_ms": step_ms, "host_ms": host_ms, "median_ms": median_ms,
            "tokens_per_s": tokens / median_ms * 1e3,
            "peak_bytes": train_peak, "adamw_ms": adam_ms,
            "micro": {"microbatches": LM_MICRO, "ms": micro_ms,
                      "host_ms": micro_host_ms,
                      "full_ms": full_ms, "loss_rel": micro_loss,
                      "grad_norm_rel": micro_gnorm},
            "long": {"batch": b2, "tokens": s2,
                     "microbatches": LM_LONG_MICRO, "ms": long_ms,
                     "host_ms": long_host_ms,
                     "tokens_per_s": b2 * s2 / long_ms * 1e3,
                     "peak_bytes": long_peak, "loss": float(ml["loss"])}}
    print(f"phase 14: {LM_ARCH} full width training, remat, {b} x {s}: "
          f"losses {[round(x, 4) for x in losses]}; step ms "
          f"{[round(x, 3) for x in step_ms]} (host to return "
          f"{[round(x, 3) for x in host_ms]}), median of 2-{LM_TRAIN_STEPS} "
          f"{median_ms:.3f} ({full['tokens_per_s']:.1f} tokens/s); AdamW "
          f"alone {adam_ms:.3f} ms; peak {train_peak} B (state {state_bytes}"
          f" B); {LM_MICRO} microbatches {micro_ms:.3f} ms (host "
          f"{micro_host_ms:.3f}) against "
          f"{full_ms:.3f} (loss rel {micro_loss:.3g}, grad_norm rel "
          f"{micro_gnorm:.3g}); {b2} x {s2} in {LM_LONG_MICRO} "
          f"microbatches {long_ms:.3f} ms (host {long_host_ms:.3f}), peak "
          f"{long_peak} B")
    out["full"] = full

    # -- 14.4 launch.train's restart, as subprocesses --------------------
    env = dict(os.environ, CUBLAS_WORKSPACE_CONFIG=":4096:8",
               PYTHONPATH=str(SRC) + os.pathsep + os.environ.get(
                   "PYTHONPATH", ""))
    with tempfile.TemporaryDirectory() as tmp:
        def train(ckpt_dir, *extra):
            return subprocess.Popen(
                [sys.executable, "-m", "repro_torch.launch.train", "--smoke",
                 "--steps", str(LM_RESTART_STEPS), "--batch", "2", "--seq",
                 "16", "--ckpt-dir", os.path.join(tmp, ckpt_dir),
                 "--ckpt-every", str(LM_RESTART_EVERY), "--log-every", "1",
                 "--deterministic", *extra], env=env, stdout=subprocess.PIPE,
                stderr=subprocess.STDOUT, text=True)

        t0 = time.perf_counter()
        straight = train("straight")
        died = train("restarted", "--die-at", str(LM_DIE_AT))
        codes = [died.wait(), straight.wait()]
        logs = [died.stdout.read(), straight.stdout.read()]
        rerun = train("restarted")
        codes.append(rerun.wait())
        logs.append(rerun.stdout.read())
        restart_s = time.perf_counter() - t0
        check(codes == [42, 0, 0], f"launch.train exits {codes}: "
              + "\n".join(logs))
        check(f"restored checkpoint at step "
              f"{LM_DIE_AT - LM_DIE_AT % LM_RESTART_EVERY}" in logs[2],
              "the rerun did not restore: " + logs[2])
        from repro_torch.ckpt import Checkpointer
        arrays = [Checkpointer(os.path.join(tmp, d)).load_arrays(
            LM_RESTART_STEPS)[1] for d in ("straight", "restarted")]
        check(sorted(arrays[0]) == sorted(arrays[1]), "checkpoint keys")
        differ = [k for k in arrays[0]
                  if not np.array_equal(arrays[0][k], arrays[1][k])]
        check(not differ, f"the restarted run's parameters differ from the "
              f"straight run's at {differ}")
    print(f"phase 14: launch.train --smoke --deterministic: --die-at "
          f"{LM_DIE_AT} exit {codes[0]}, rerun exit {codes[2]}, straight "
          f"exit {codes[1]}; {len(arrays[0])} arrays of the final "
          f"checkpoint equal bit for bit ({restart_s:.2f} s)")
    out["restart"] = {"codes": codes, "arrays": len(arrays[0]),
                      "seconds": restart_s}
    return out


def phase_15(drive, wrappers, plains, tables) -> dict:
    """The dry-run: its cells on meta, its counts against the card, and
    the 512-chip Ising cell's shard kernels at its plan.  ``drive`` is
    :func:`main`'s (a shard-kernel dispatch is its own path); returns
    the phase's numbers."""
    import torch

    from repro_torch.analysis.tune_resident import random_planes
    from repro_torch.configs import SHAPES, get_config
    from repro_torch.core import distributed
    from repro_torch.data import make_batch
    from repro_torch.dist import driver as shard_driver
    from repro_torch.dist import planner as shard_planner
    from repro_torch.kernels import resident
    from repro_torch.launch import dryrun, roofline
    from repro_torch.launch.mesh import make_debug_mesh, \
        make_production_mesh
    from repro_torch.models import init_model
    from repro_torch.train import OptConfig, make_train_step, opt_init
    from repro_torch.train.sharding import param_shardings, place

    out = {}

    # -- 15.1 the dry-run's cells on meta ------------------------------------
    t0 = time.perf_counter()
    cells = [(arch, shape) for arch, shape in DRYRUN_LM_CELLS] + [
        (f"ising-{e}", s) for e in DRYRUN_ISING for s in dryrun.ISING_SHAPES]
    records = {}
    for arch, shape in cells:
        for mesh_kind in ("single", "multi"):
            rec = dryrun.run_cell(arch, shape, mesh_kind, verbose=False)
            records[arch, shape, mesh_kind] = rec
            error = f" {rec['error']}" if "error" in rec else ""
            print(f"phase 15: dry-run {arch} x {shape} x {mesh_kind}: "
                  f"{rec['status']}{error}, "
                  f"chips {rec['chips']}, flops {rec.get('flops', 0):.4e}, "
                  f"bytes {rec.get('bytes', 0):.4e} a device (counts, not "
                  f"times), dominant {rec.get('dominant')}, argument bytes "
                  f"{rec.get('memory', {}).get('argument_size_in_bytes')}"
                  f" a device, collectives {rec.get('collectives')}, "
                  f"{rec.get('compile_s')} s"
                  + (f"; shard {rec['shard']}, plan {rec['plan']}"
                     if arch.startswith("ising") else ""))
            check(rec["status"] == "ok",
                  f"dry-run {arch} x {shape} x {mesh_kind}: {rec['status']} "
                  f"{rec.get('error', rec.get('skip_reason'))}")
    out["cells_s"] = time.perf_counter() - t0
    out["cells"] = {" ".join(k): {x: r.get(x) for x in (
        "status", "flops", "bytes", "dominant", "memory")}
        for k, r in records.items()}

    # -- 15.2 the counts against the card ------------------------------------
    t0 = time.perf_counter()
    cfg = get_config(LM_ARCH)
    meta_mesh = make_debug_mesh(n_devices=1, device="meta")
    card_mesh = make_debug_mesh(n_devices=1, device="cuda")
    step_of = {}
    for where, mesh in (("meta", meta_mesh), ("cuda", card_mesh)):
        step_of[where] = make_train_step(cfg, OptConfig(**LM_TRAIN_OPT),
                                         remat=True, mesh=mesh)
    params = init_model(cfg, device="meta")
    opt = opt_init(params)
    shardings = param_shardings(cfg, params, meta_mesh)
    leaves = dict(params.named_parameters())
    counted = sum(sh.shard_bytes(leaves[p.replace("/", ".")])
                  for p, sh in shardings.items()) * 3 \
        + opt["count"].element_size()
    batch = make_batch(cfg, SHAPES["train_4k"], abstract=True,
                       batch_override=LM_TRAIN[0], seq_override=LM_TRAIN[1])
    meta_count = roofline.OpCounter()
    with meta_count:
        step_of["meta"](params, opt, batch)
    del params, opt, batch
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    before = torch.cuda.memory_allocated()
    params = init_model(cfg, 0, device="cuda")
    params = place(params, param_shardings(cfg, params, card_mesh))
    opt = opt_init(params)
    torch.cuda.synchronize()
    allocated = torch.cuda.memory_allocated() - before
    state_err = abs(counted - allocated) / allocated
    batch = make_batch(cfg, SHAPES["train_4k"], batch_override=LM_TRAIN[0],
                       seq_override=LM_TRAIN[1], device="cuda")
    card_count = roofline.OpCounter()
    with card_count:
        step_of["cuda"](params, opt, batch)
    torch.cuda.synchronize()
    del params, opt, batch
    torch.cuda.empty_cache()
    print(f"phase 15: {LM_ARCH} at {LM_TRAIN[0]} x {LM_TRAIN[1]} on a "
          f"one-device mesh: parameter and AdamW state counted from the "
          f"specs {counted} B, allocated on the card by opt_init "
          f"{allocated} B ({100 * state_err:.4f} %); one train step's "
          f"count on meta {meta_count.flops} FLOP, {meta_count.bytes} B, "
          f"{meta_count.ops} ops; on the card {card_count.flops} FLOP, "
          f"{card_count.bytes} B, {card_count.ops} ops")
    if meta_count.by_op != card_count.by_op:
        print("phase 15: ops that differ (meta, card): " + json.dumps({
            op: (meta_count.by_op.get(op), card_count.by_op.get(op))
            for op in set(meta_count.by_op) | set(card_count.by_op)
            if meta_count.by_op.get(op) != card_count.by_op.get(op)}))
    check(state_err <= DRYRUN_STATE_TOL,
          f"the counted state {counted} B is not within "
          f"{100 * DRYRUN_STATE_TOL} % of the allocated {allocated} B")
    check(meta_count.flops == card_count.flops,
          f"one step's FLOPs on meta {meta_count.flops} are not the card's "
          f"{card_count.flops}")
    out["state"] = {"counted_bytes": counted, "allocated_bytes": allocated,
                    "relative_error": state_err}
    out["step"] = {"meta_flops": meta_count.flops,
                   "card_flops": card_count.flops,
                   "meta_bytes": meta_count.bytes,
                   "card_bytes": card_count.bytes,
                   "meta_ops": meta_count.ops, "card_ops": card_count.ops}
    out["counts_s"] = time.perf_counter() - t0

    # -- 15.3 the 512-chip cell's shard kernels at its plan ------------------
    t0 = time.perf_counter()
    shape, mesh_kind = DRYRUN_SHARD_CELL
    n, m = dryrun.ISING_SHAPES[shape]
    mesh = make_production_mesh(multi_pod=mesh_kind == "multi",
                                device="cuda")
    out["shards"] = {}
    for engine in DRYRUN_ISING:
        rec = records[f"ising-{engine}", shape, mesh_kind]
        family = dryrun.ISING_ENGINES[engine][3]
        name = f"{family}_shard_sweeps"
        grid = distributed.ShardGrid.of(
            mesh, n, m // resident.GEOMETRY[family].col_divisor)
        plan = shard_planner.plan_shard_resident(family, n, m,
                                                 grid.rows_devs,
                                                 grid.cols_devs)
        ext = [plan.n_loc + 2 * plan.halo, plan.w_loc + 2 * plan.halo]
        tile = (plan.tile_rows, plan.tile_cols, plan.threads)
        check(rec["plan"] is not None and ext == rec["plan"]["extended"]
              and plan.k == rec["plan"]["k"]
              and list(tile) == rec["plan"]["tile"]
              and [plan.n_loc, plan.w_loc] == rec["shard"],
              f"{name}: the plan {plan} is not the dry-run's {rec['plan']}")
        index = shard_driver.index_planes(plan, grid, DRYRUN_SHARD_INDEX)
        b, w = random_planes(family, *ext, 15)
        path = (f"dry-run {family} shard {DRYRUN_SHARD_INDEX} of "
                f"{shape} on {mesh_kind}")
        got = drive(path, family, "shard", lambda: wrappers[name](
            b, w, tables[family], *index, n_sweeps=plan.k, seed=SEED,
            start_offset=2 ** 32 - 3, tile=tile))
        want = plains[name](b, w, tables[family], *index, n_sweeps=plan.k,
                            seed=SEED, start_offset=2 ** 32 - 3)
        bad = sum(int((x != y).sum()) for x, y in zip(got, want))
        print(f"phase 15: {name} at the dry-run's plan of {shape} on "
              f"{mesh.shape} (k {plan.k}, extended {ext[0]} x {ext[1]}, "
              f"tile {tile}): shard {DRYRUN_SHARD_INDEX}, "
              f"{wrappers[name].launches} launch, {bad} mismatches "
              f"against the plain version")
        check(bad == 0, f"{name} at the dry-run's plan disagrees with its "
              f"plain version")
        out["shards"][name] = {"path": path, "extended": ext, "k": plan.k,
                               "mismatches": bad}
        del b, w, got, want, index
    torch.cuda.empty_cache()
    out["shards_s"] = time.perf_counter() - t0
    return out


def phase_16(full_losses) -> dict:
    """The LM train step on a mesh of LM_MESH shards on the card: each
    smoke architecture against the card's one-shard step, then
    LM_ARCH at full width against phase 14's losses (``full_losses``).
    A mesh run must not quietly run one shard: every shard computes
    rows.  Returns the full width's numbers."""
    import copy
    import statistics

    import torch

    from repro_torch.configs import ARCH_IDS, SHAPES, get_config, \
        get_smoke_config
    from repro_torch.data import make_batch
    from repro_torch.launch import roofline
    from repro_torch.launch.mesh import make_debug_mesh
    from repro_torch.models import init_model
    from repro_torch.train import (OptConfig, make_loss_fn,
                                   make_train_step, opt_init)
    from repro_torch.train import optim as lm_optim
    from repro_torch.train import step as train_step
    from repro_torch.train.sharding import param_shardings, place

    card = torch.device("cuda")
    mesh = make_debug_mesh(n_devices=LM_MESH[0] * LM_MESH[1],
                           model=LM_MESH[1], device=card)
    check(mesh.shape == LM_MESH and mesh.size > 1, f"mesh {mesh.shape}")
    computed = []
    split_rows = train_step.split_rows

    def recording(params, batch):
        parts = split_rows(params, batch)
        computed.append([(i, len(p["labels"])) for i, p in parts])
        return parts
    train_step.split_rows = recording
    out = {"mesh": list(LM_MESH)}
    try:
        # -- 16.1 every architecture's step at smoke width -----------------
        rows = {}
        ocfg = OptConfig(**LM_SMOKE_OPT)
        for i, arch in enumerate(ARCH_IDS):
            cfg = get_smoke_config(arch)
            one = init_model(cfg, 600 + i, device=card)
            placed = place(copy.deepcopy(one), param_shardings(cfg, one,
                                                               mesh))
            b, s = LM_MESH_SMOKE
            batch = make_batch(cfg, SHAPES["train_4k"], step=i, seed=16,
                               batch_override=b, seq_override=s,
                               device=card)
            _, _, m1 = make_train_step(cfg, ocfg)(one, opt_init(one), batch)
            computed.clear()
            _, _, mm = make_train_step(cfg, ocfg, mesh=mesh)(
                placed, opt_init(placed), batch)
            shards = sorted(i for step in computed for i, _ in step)
            check(shards == list(range(mesh.size)), f"{arch}: on the mesh "
                  f"the shards {shards} computed rows")
            m1 = {k: float(v) for k, v in m1.items()}
            mm = {k: float(v) for k, v in mm.items()}
            loss_rel = abs(mm["loss"] - m1["loss"]) / abs(m1["loss"])
            gnorm_rel = abs(mm["grad_norm"] - m1["grad_norm"]) \
                / m1["grad_norm"]
            whole = placed.tree(card)
            worst, near, n = 0.0, 0, 0
            with torch.no_grad():
                for a, w in zip(whole.parameters(), one.parameters()):
                    d = (a - w).abs()
                    worst = max(worst, float(d.max()))
                    near += int((d < 1e-4).sum())
                    n += d.numel()
            check(math.isfinite(mm["loss"]) and loss_rel <= LM_TRAIN_LOSS,
                  f"{arch}: mesh loss {mm['loss']} against one shard's "
                  f"{m1['loss']}")
            check(gnorm_rel <= LM_TRAIN_GNORM, f"{arch}: mesh grad_norm "
                  f"{mm['grad_norm']} against one shard's "
                  f"{m1['grad_norm']}")
            check(worst <= 2.1 * m1["lr"] and near / n >= LM_MESH_NEAR,
                  f"{arch}: mesh parameters off one shard's: largest "
                  f"{worst} (lr {m1['lr']}), {near / n:.4f} within 1e-4")
            rows[arch] = {"loss": mm["loss"], "loss_rel": loss_rel,
                          "grad_norm_rel": gnorm_rel, "aux": mm["aux"],
                          "aux_one_shard": m1["aux"],
                          "max_param_diff_over_lr": worst / m1["lr"],
                          "within_1e-4": near / n}
            del one, placed, whole
        print("phase 16: smoke archs' step on a " f"{LM_MESH} mesh against "
              "one shard, card: " + json.dumps(rows))
        out["smoke"] = rows

        # -- 16.2 internlm2-1.8b at full width, remat on -------------------
        cfg = get_config(LM_ARCH)
        b, s = LM_TRAIN
        batch = make_batch(cfg, SHAPES["train_4k"], batch_override=b,
                           seq_override=s, device=card)
        out["first_step"] = first_step_gradients(cfg, mesh, batch,
                                                 full_losses)
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        before = torch.cuda.memory_allocated()
        whole = init_model(cfg, 13, device=card)
        sh = param_shardings(cfg, whole, mesh)
        params = place(whole, sh)
        leaves = {p.replace("/", "."): whole.get_parameter(
            p.replace("/", ".")) for p in sh}
        counted = roofline.memory_per_device(
            [(sh[p.replace(".", "/")], leaf) for p, leaf in leaves.items()]
            * 3)["argument_size_in_bytes"]
        del whole, leaves
        opt = opt_init(params)
        torch.cuda.synchronize()
        state_bytes = torch.cuda.memory_allocated() - before
        shard_bytes = [sum(x.numel() * x.element_size() for t in (
            params.pieces[i], opt["mu"].pieces[i], opt["nu"].pieces[i])
            for x in t.parameters()) for i in range(mesh.size)]
        check(all(x == counted for x in shard_bytes),
              f"each shard's state {shard_bytes} B, counted {counted} B")
        step = make_train_step(cfg, OptConfig(**LM_TRAIN_OPT), remat=True,
                               mesh=mesh)
        losses, step_ms, host_ms = [], [], []
        for _ in range(LM_TRAIN_STEPS):
            computed.clear()
            ms, (params, opt, m) = cuda_events(torch, lambda: step(
                params, opt, batch))
            step_ms.append(ms)
            host_ms.append(cuda_events.host_ms)
            losses.append(float(m["loss"]))
            check([i for i, _ in computed[0]] == list(range(mesh.size)),
                  f"full width: the shards that computed rows: {computed}")
        peak = torch.cuda.max_memory_allocated()
        # AdamW alone on the pieces, on this batch's gradients
        plist = lm_optim.leaves(params)
        total, _ = make_loss_fn(cfg, mesh=mesh)(params, batch)
        total.backward()
        grads = [p.grad for p in plist]
        adam_ms = statistics.median(
            cuda_events(torch, lambda: lm_optim.update(
                OptConfig(**LM_TRAIN_OPT), grads, params, opt))[0]
            for _ in range(LM_ADAM_TRIALS))
        for p in plist:
            p.grad = None
        del grads, total, plist
        follow = [abs(a - w) / abs(w) for a, w in zip(losses, full_losses)]
        check(all(math.isfinite(x) for x in losses)
              and max(follow) <= LM_MESH_FOLLOW,
              f"full width on {LM_MESH}: losses {losses} against one "
              f"shard's {full_losses}")
        median_ms = statistics.median(step_ms[1:])
        del params, opt, batch
        torch.cuda.empty_cache()
    finally:
        train_step.split_rows = split_rows
    card_line = nvidia_smi("name,power.limit")
    full = {"arch": LM_ARCH, "batch": b, "tokens": s, "losses": losses,
            "one_shard_losses": list(full_losses), "loss_rel": follow,
            "step_ms": step_ms, "host_ms": host_ms, "median_ms": median_ms,
            "tokens_per_s": b * s / median_ms * 1e3, "peak_bytes": peak,
            "adamw_ms": adam_ms,
            "state_bytes": state_bytes, "shard_state_bytes": shard_bytes,
            "memory_per_device_bytes": counted,
            "rows_per_shard": [n for _, n in computed[0]],
            "card": card_line}
    print(f"phase 16: {LM_ARCH} full width training, remat, {b} x {s} on "
          f"a {LM_MESH} mesh of one card: losses "
          f"{[round(x, 4) for x in losses]} (one shard, phase 14: "
          f"{[round(x, 4) for x in full_losses]}; largest relative "
          f"difference {max(follow):.3g}); step ms "
          f"{[round(x, 3) for x in step_ms]} (host to return "
          f"{[round(x, 3) for x in host_ms]}), median of 2-{LM_TRAIN_STEPS} "
          f"{median_ms:.3f} ({full['tokens_per_s']:.1f} tokens/s); AdamW "
          f"alone {adam_ms:.3f} ms; peak "
          f"{peak} B; state allocated {state_bytes} B, each shard's "
          f"{shard_bytes[0]} B = memory_per_device's {counted} B; rows a "
          f"shard {full['rows_per_shard']}; {card_line}")
    out["full"] = full
    return out


def first_step_gradients(cfg, mesh, batch, full_losses) -> dict:
    """Phase 16's first step at full width from phase 14's weights: the
    mesh's gradients against one shard's, then the planted fault (the
    module's notes at LM_MESH_GNORM).  Leaves nothing on the card."""
    import torch

    from repro_torch.models import init_model
    from repro_torch.models.shards import paths
    from repro_torch.train import OptConfig, make_loss_fn, opt_init
    from repro_torch.train import optim as lm_optim
    from repro_torch.train import step as train_step
    from repro_torch.train.sharding import param_shardings, place

    def grads(loss_fn, params, plist):
        for p in plist:
            p.requires_grad_(True)
        loss_fn(params, batch)[0].backward()
        out = [p.grad for p in plist]
        for p in plist:
            p.grad = None
            p.requires_grad_(False)
        return out

    whole = init_model(cfg, 13, device=mesh.device_of(0))
    sh = param_shardings(cfg, whole, mesh)
    one = dict(zip(paths(whole), grads(make_loss_fn(cfg), whole,
                                       list(whole.parameters()))))
    one_norm = float(lm_optim.global_norm(list(one.values())))
    params = place(whole, sh)
    del whole
    plist = lm_optim.leaves(params)
    firsts = lm_optim.counted(params)
    loss_fn = make_loss_fn(cfg, mesh=mesh)
    got = grads(loss_fn, params, plist)
    mesh_norm = float(lm_optim.global_norm(got, firsts))
    keys = [(i, path) for i, t in enumerate(params.pieces)
            for path in paths(t)]
    diff2 = ref2 = flips = 0
    n = 0
    for (i, path), g, first in zip(keys, got, firsts):
        if first:
            r = one[path][sh[path].index(i, one[path].shape)]
            diff2 = diff2 + (g - r).double().pow(2).sum()
            ref2 = ref2 + r.double().pow(2).sum()
            flips = flips + (torch.sign(g) != torch.sign(r)).sum()
            n += r.numel()
    rel = abs(mesh_norm - one_norm) / one_norm
    tree_rel = math.sqrt(float(diff2) / float(ref2))
    flipped = int(flips) / n
    del got, one

    # the planted fault: shard LM_MESH_FAULT's rows give no gradient
    forward_parts = train_step.forward_parts

    def dropping(*args, **kw):
        outs = forward_parts(*args, **kw)
        logits, aux = outs[LM_MESH_FAULT]
        outs[LM_MESH_FAULT] = (logits.detach(), aux.detach())
        return outs
    opt = opt_init(params)
    train_step.forward_parts = dropping
    try:
        bad = grads(loss_fn, params, plist)
    finally:
        train_step.forward_parts = forward_parts
    fault_norm = float(lm_optim.global_norm(bad, firsts))
    lm_optim.update(OptConfig(**LM_TRAIN_OPT), bad, params, opt)
    del bad
    with torch.no_grad():
        fault_loss = float(loss_fn(params, batch)[1][0])
    del params, opt, plist
    torch.cuda.empty_cache()
    fault_rel = abs(fault_norm - one_norm) / one_norm
    fault_follow = abs(fault_loss - full_losses[1]) / full_losses[1]
    check(rel <= LM_MESH_GNORM, f"full width on {LM_MESH}: the first "
          f"step's grad_norm {mesh_norm} against one shard's {one_norm}")
    check(fault_rel > LM_MESH_GNORM, f"the planted fault (shard "
          f"{LM_MESH_FAULT}'s gradient dropped) passes the grad_norm "
          f"bound: {fault_norm} against {one_norm}")
    res = {"grad_norm_one_shard": one_norm, "grad_norm_mesh": mesh_norm,
           "grad_norm_rel": rel, "grad_tree_rel_rms": tree_rel,
           "sign_differs": flipped, "elements": n,
           "fault_shard": LM_MESH_FAULT, "fault_grad_norm": fault_norm,
           "fault_grad_norm_rel": fault_rel, "fault_loss_2": fault_loss,
           "fault_loss_2_rel": fault_follow}
    print(f"phase 16: {LM_ARCH} full width, first step's gradients on "
          f"{LM_MESH} against one shard: grad_norm {mesh_norm} / {one_norm}"
          f" (rel {rel:.3g}, bound {LM_MESH_GNORM}); tree relative RMS "
          f"{tree_rel:.3g}; sign differs on {flipped:.4g} of {n} elements;"
          f" planted fault (shard {LM_MESH_FAULT}'s gradient dropped): "
          f"grad_norm {fault_norm} (rel {fault_rel:.3g}), the loss after "
          f"its step {fault_loss} against one shard's {full_losses[1]} "
          f"(rel {fault_follow:.3g}, LM_MESH_FOLLOW {LM_MESH_FOLLOW})")
    return res


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
    from repro_torch.launch import roofline
    ops = dict(PIPE_OPS[family])
    wide = ops.pop("wide")
    ops["fma"] += FMA_WIDE_SLOTS * wide
    ops["alu"] += WIDE_ALU_SLOTS * wide
    pipes = max(ops[p] / roofline.H100_PIPE_PER_CLOCK_PER_SM[p]
                for p in ops)
    issued = wide + sum(v for p, v in PIPE_OPS[family].items()
                        if p not in ("tensor", "wide"))
    return max(pipes, issued / roofline.H100_DISPATCH_PER_CLOCK_PER_SM)


def bound(family: str, bytes_moved: float, updates: float,
          sm_clocks_per_s: float):
    from repro_torch.launch import roofline
    t_bytes = bytes_moved / roofline.H100_HBM_BYTES_PER_S
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
    from repro_torch.kernels.tensorcore.tensorcore import kernel_geometry
    from repro_torch.launch import roofline
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
          f"{props.multi_processor_count} SMs at max {max_sm_mhz:.0f} MHz "
          f"(the roofline's figures: {roofline.H100_SMS} SMs, boost "
          f"{roofline.H100_BOOST_MHZ} MHz, HBM "
          f"{roofline.H100_HBM_BYTES_PER_S:.4g} B/s); "
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
    # blocks of TC_BLOCKS on (2B, 3B) planes, both types and colours: at
    # TEMPERATURE from random planes, and at TC_COLD_T from all-up planes,
    # where the table's -8 beta entries underflow to 0
    for block in TC_BLOCKS:
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
    # a block that does not tile the planes raises and launches nothing
    planes = tc_random_planes(torch, 12, torch.int8, 1)
    before = wrappers[tc_update].launches
    try:
        wrappers[tc_update](planes, "black", tc_beta, block=8)
        raised = False
    except ValueError:
        raised = True
    check(raised and wrappers[tc_update].launches == before,
          "tensorcore_update took a block of 8 on 12 x 12 planes")
    # the JAX engine's blocks in a session: the CPU's trajectory
    for side, block in TC_JAX_BLOCKS:
        spec = RunSpec(lattice=LatticeSpec(side, side),
                       engine=EngineSpec("tensorcore", {"tc_block": block}),
                       temperature=2.2, seed=SEED)
        digests = []
        for device in ("cpu", "cuda"):
            session = Session.open(spec, device)
            session.run(TC_JAX_SWEEPS)
            digests.append(session.state_digest())
        check(digests[0] == digests[1], f"tensorcore {side}^2 at block "
              f"{block}: card digest {digests[1]}, CPU {digests[0]}")
        print(f"phase 3: tensorcore session {side}^2 at tc_block {block}: "
              f"{TC_JAX_SWEEPS} sweeps, card digest {digests[1]} = CPU's")
    cases, bad, err, _ = stats[tc_update]
    print(f"phase 3: {tc_update}: {cases} plane comparisons with the plain "
          f"version, {bad} mismatches, max abs err {err}; a block that "
          f"does not tile the planes raises")
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

    # bitplane_counts, the counts of the bitplane observables: (B, 2, 32)
    # int64 counts against the plain version's, 0 mismatches, at the
    # ensemble main path's (16, 4096, 2048) planes and at the main path's
    # two (16384, 8192) ones, which it is timed at (the zeroed buffer
    # included, as a sample's graph replays it)
    shapes = (ensemble_shape["bitplane"], full_plane["bitplane"])
    for shape in shapes:
        b, w = (random_batch("bitplane", *shape, 13) if len(shape) == 3
                else random_planes("bitplane", *shape, 13))
        want, plain_ms = plain_timed(lambda: plains[COUNT_KERNEL](b, w))
        got = wrappers[COUNT_KERNEL](b, w)
        torch.cuda.synchronize()
        compare(COUNT_KERNEL, [got], [want],
                plain_ms if len(shape) == 2 else None)
        del want, got
    kernel_ms[COUNT_KERNEL] = timed_ms(lambda: wrappers[COUNT_KERNEL](b, w),
                                       reps=20)
    del b, w
    count_stats = stats[COUNT_KERNEL]
    print(f"phase 3: {COUNT_KERNEL}: {count_stats[0]} comparisons of the "
          f"(B, 2, 32) counts with the plain version at {shapes[0]} and "
          f"{shapes[1]}, {count_stats[1]} mismatches; "
          f"{kernel_ms[COUNT_KERNEL]:.4f} ms a launch at {shapes[1]}, plain "
          f"version {count_stats[3]:.1f} ms")
    check(count_stats[1] == 0,
          f"{COUNT_KERNEL} disagrees with its plain version")
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
    # bitplane_counts reads both planes once; the bound is bytes alone
    elements = full_plane["bitplane"][0] * full_plane["bitplane"][1]
    bounds[COUNT_KERNEL] = bound("bitplane", 2 * 4 * elements, 0,
                                 sm_clocks_per_s)

    # -- 4. Session at 512^2, both tiers and the CPU -----------------------
    t0 = time.perf_counter()
    launches_by_path = {}

    def drive(path, family, tier, fn, observes=False):
        """Run one Session path with every launch count set to 0 just
        before it and read just after it; the path must launch the
        kernel of its tier and no other (``family=None``: no kernel), a
        bitplane kernel with the three-threshold accept only (a Session's
        table has a ferromagnet's layout).  ``observes``: the path reads
        the observables of a single-mode or ensemble session (an
        ensemble's ``run`` reads its magnetizations), so a bitplane path
        must also launch ``bitplane_counts``, and no other path may."""
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
            want = (observes and family == "bitplane"
                    if name == COUNT_KERNEL
                    else KERNELS[name][:2] == (family, tier))
            check((count > 0) == want,
                  f"path {path!r} launched {name} {count} times")
        check(not any(general.values()),
              f"path {path!r} launched the general bitplane accept")
        return out

    def budget(tier):
        return 0 if tier == "half-sweep" else None

    import repro_torch.telemetry as tel
    from repro_torch.analysis import measure as measuring
    #: measure() through the graph and through the loop, by path
    graph_rows = {}

    def graph_measure(session, plan=None):
        """Host copies of the planes, then ``session.measure()`` traced,
        its observables one captured graph, timed on the host clock to
        the samples on the host; its replays (``DISPATCHES``), the graph's
        capture and instantiation seconds (its spans; ``None`` where
        this PyTorch instantiates in the capture's end), and the device
        memory it took above what was allocated when it started."""
        before = [p.cpu() for p in session.state]
        step = session.step_count
        torch.cuda.synchronize()
        path_peak = torch.cuda.max_memory_allocated()
        start = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        replays = measuring.DISPATCHES
        check(not tel.enabled(), "graph_measure: tracing already on")
        tel.TRACER.clear()
        tel.enable()
        try:
            t1 = time.perf_counter()
            traj = session.measure(plan)
            seconds = time.perf_counter() - t1
        finally:
            tel.disable()
        spans = {}
        for e in tel.TRACER.events:
            spans.setdefault(e["name"], []).append(e["dur_us"] * 1e-6)
        tel.TRACER.clear()
        peak = torch.cuda.max_memory_allocated()
        return {"before": before, "step": step, "plan": plan, "traj": traj,
                "seconds": seconds,
                "replays": measuring.DISPATCHES - replays,
                "stats": {
                    "capture_s": sum(spans.get("measure.graph_capture",
                                               [0.0])),
                    "instantiate_s": sum(spans["measure.graph_instantiate"])
                    if "measure.graph_instantiate" in spans else None,
                    "replays": len(spans.get("measure.graph_replay", []))},
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
                                    loop, observes=True)
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
            "k-sweep", lambda: restore_continue(small), observes=True))

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

            e = drive(path, family, tier, ensemble_run, observes=True)
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
            "k-sweep", lambda: restore_continue(spec), observes=True))
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
                     "k-sweep", rebind, observes=True)
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
    single_k = {"tensorcore": 1}
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
            main_path, family, "k-sweep", main_run, observes=True)
        traj, measure_s = measured["traj"], measured["seconds"]
        if family == "stencil":
            # its planes after run(200) on the host: phase 9's
            # basic_philox must give them
            stencil_after_200 = measured["before"]
        flips_per_ns = single_rates[family] = 200 * spins / (run_ms * 1e6)
        plan = session.engine.resident_plan
        single_k[family] = plan.k
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
    single_rates["tensorcore"] = 200 * FULL_N ** 2 / (run_ms * 1e6)
    print(f"phase 5: {main_path}: open {open_s:.2f} s; run(200) "
          f"{run_ms:.1f} ms = {single_rates['tensorcore']:.2f} "
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
            run_path, family, "k-sweep", open_run, observes=True)
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
                         lambda: graph_measure(session), observes=True)
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

        half, half_ms = drive(half_path, family, "half-sweep", half_run,
                              observes=True)
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
                             lambda: graph_measure(session), observes=True)
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

    # -- 11. the sweep farm and the legacy entry point -----------------------
    t0 = time.perf_counter()
    phase_11(drive, launches_by_path)
    phase_s[11] = time.perf_counter() - t0
    print(f"phase 11: {phase_s[11]:.1f} s")

    # -- 12. the performance contract ----------------------------------------
    t0 = time.perf_counter()
    phase_12(wrappers, launches_by_path,
             {family: (single_rates[family], single_k[family])
              for family in ROOFLINE_PREDICTED})
    phase_s[12] = time.perf_counter() - t0
    print(f"phase 12: {phase_s[12]:.1f} s")

    # -- 13. the LM stack's inference path -----------------------------------
    t0 = time.perf_counter()
    lm = drive("lm inference", None, None, phase_13)
    phase_s[13] = time.perf_counter() - t0
    print(f"phase 13: {phase_s[13]:.1f} s; " + json.dumps({"lm": lm}))

    # -- 14. the LM stack's training path ------------------------------------
    t0 = time.perf_counter()
    lm_train = drive("lm training", None, None, phase_14)
    phase_s[14] = time.perf_counter() - t0
    print(f"phase 14: {phase_s[14]:.1f} s; "
          + json.dumps({"lm_training": lm_train["full"]}))

    # -- 15. the dry-run ------------------------------------------------------
    t0 = time.perf_counter()
    dry = phase_15(drive, wrappers, plains, tables)
    phase_s[15] = time.perf_counter() - t0
    print(f"phase 15: {phase_s[15]:.1f} s; " + json.dumps(
        {"dryrun": {k: v for k, v in dry.items() if k != "cells"}}))

    # -- 16. the LM train step on a mesh of several shards -------------------
    t0 = time.perf_counter()
    lm_mesh = drive("lm mesh training", None, None, lambda: phase_16(
        lm_train["full"]["losses"]))
    phase_s[16] = time.perf_counter() - t0
    print(f"phase 16: {phase_s[16]:.1f} s; "
          + json.dumps({"lm_mesh_training": lm_mesh["full"]}))

    def by_path(name):
        return {path: c[name] for path, c in launches_by_path.items()}

    kernels = []
    for name, (family, tier, replaces) in KERNELS.items():
        path = {"k-sweep": main_paths, "half-sweep": half_paths,
                "shard": shard_paths, "fill": fill_paths,
                "counts": main_paths}[tier][family]
        source = "counts" if tier == "counts" else family
        entry = {"name": name, "route": "cuda",
                 "source": f"src/repro_torch/csrc/{source}.cu",
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
