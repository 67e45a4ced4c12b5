"""Time the k-sweep kernels' tile, k and block-size candidates on the card.

    PYTHONPATH=src python -m repro_torch.analysis.tune_resident [--family F]
    PYTHONPATH=src python -m repro_torch.analysis.tune_resident --ensemble
    PYTHONPATH=src python -m repro_torch.analysis.tune_resident --shard
    PYTHONPATH=src python -m repro_torch.analysis.tune_resident --tensorcore

For each kernel family, at the plane of its full-size main path in
``chip_smoke.py`` (stencil and multispin 32768^2, bitplane 16384^2),
prints the milliseconds per full sweep of the per-half-sweep tier and of
the k-sweep kernel at each candidate (tile rows, tile columns, k,
threads) that fits one block's shared memory: CUDA events, after one
untimed call, every kernel built before the first is timed.  These are
the measurements behind ``repro_torch.kernels.resident.GEOMETRY``.
With ``--ensemble`` it times the member axis at the shape of
``chip_smoke.py``'s ensemble main paths (:data:`ENSEMBLE`: 16 members of
8192^2, bitplane of 4096^2), per full sweep of all members: both tiers
in one launch a block, the same work one member at a time through the
single-member kernels, and each candidate tile on the member axis.
With ``--shard`` it times the shard kernels of the sharded resident tier
instead (``repro_torch.dist.kernels``), on the extended plane of one
shard of the 2 x 2 main path at the planner's k with the driver's own
index planes of that shard (for bitplane at k = 2 every 4-word group is
one Philox group), times the 4 shards: the measurements behind
``repro_torch.dist.planner.SHARD_TILES``.  With ``--tensorcore`` it times
``tensorcore_update`` at the main path's four 16384^2 int8 planes and
block 128, ms per half-sweep, at the kernel's own tile
(``repro_torch.analysis.ablate`` times the other tiles).  Run as a file
with another tree's ``src`` on ``PYTHONPATH`` (``python
src/repro_torch/analysis/tune_resident.py``) it times that tree's
kernels, as a parent's beside a change.  The last two lines are the
card's name and power limit and one JSON object of every time.
"""
from __future__ import annotations

import argparse
import dataclasses
import importlib
import json
import subprocess
import sys

import torch

from repro_torch.core import metropolis, multispin
from repro_torch.kernels import _build, resident

FAMILIES = ("stencil", "multispin", "bitplane")
#: the plane of each family's full-size main path in ``chip_smoke.py``
FULL_PLANE = {"stencil": (32768, 16384), "multispin": (32768, 2048),
              "bitplane": (16384, 8192)}
#: the temperature of that path
TEMPERATURE = {"stencil": 2.0, "multispin": 2.0, "bitplane": 3.0}
#: the ensemble main paths in ``chip_smoke.py``: (members, lattice side)
ENSEMBLE = {"stencil": (16, 8192), "multispin": (16, 8192),
            "bitplane": (16, 4096)}
#: a multispin word of 0/1 nibbles
NIBBLES = 0x11111111
#: (tile rows, tile columns, k, threads).  Stencil: a lane takes a word
#: of 4 cells and a warp a row, so the columns are those that with the
#: halo make rows of 32, 64 or 128 words (k = 1, 2: a halo of 4 a side;
#: k = 3, 4: 8), and 128 x 256 (rows of 66 words) for comparison
CANDIDATES = {
    "stencil": [(tr, tc - (8 if k > 2 else 0), k, t)
                for k in (1, 2, 3, 4) for tr in (64, 128, 192)
                for tc in (120, 248, 504) for t in (256, 512)]
    + [(128, 256, 2, 256)],
    # a warp takes a row and a lane a word; the columns are those that
    # with the halo of 4 a side at k = 2 make rows of 64, 128 or 256
    # words (56, 120, 248), and 128, which divides the main path's 2048
    "multispin": [(tr, tc, 2, t) for tr in (32, 40, 48, 64, 96, 128)
                  for tc in (56, 120, 128, 248) for t in (256, 512)]
    + [(tr, tc, k, t) for tr, tc in ((40, 248), (96, 120))
       for k in (1, 3) for t in (256, 512)],
    # a warp takes a row and a lane a 4-word group; the columns are those
    # that with the halo of 4 a side at k = 1, 2 make rows of 16, 32 or
    # 64 groups (56, 120, 248), and 128, which divides the main path's
    # 8192 words
    "bitplane": [(tr, tc, 2, t) for tr in (32, 48, 64, 96, 128)
                 for tc in (56, 120, 128, 248) for t in (256, 512)]
    + [(tr, 248, 2, t) for tr in (24, 40, 44) for t in (256, 512)]
    + [(tr, tc, k, t) for tr, tc in ((96, 120), (48, 248), (64, 248))
       for k in (1, 3) for t in (256, 512)],
}

#: the tensorcore main path: four (TC_PLANE, TC_PLANE) int8 planes of a
#: 32768^2 lattice, ``tc_block`` TC_BLOCK, T = 2.0
TC_PLANE = 16384
TC_BLOCK = 128

#: (tile rows, tile columns, threads) of the shard kernels; the
#: stencil kernel's rows of whole warps of 4-cell words as above; for
#: the multispin kernel's 1032-word extended shard also 172 and 344
#: words, which divide it (a multispin block takes at most 512 threads)
SHARD_CANDIDATES = [(tr, tc, t) for tr, tc in ((128, 256), (128, 128),
                                                (96, 128), (64, 256),
                                                (64, 128), (48, 128),
                                                (32, 256), (32, 248),
                                                (64, 248), (96, 248),
                                                (128, 248), (64, 120),
                                                (96, 120), (128, 120),
                                                (192, 120), (32, 120),
                                                (48, 120), (48, 172),
                                                (64, 172), (24, 344),
                                                (32, 344), (24, 248),
                                                (40, 248), (48, 248))
                    for t in (256, 512, 1024)]


def timed_ms(fn, reps: int, warmup: bool = True) -> float:
    """Mean milliseconds of ``fn()`` over ``reps`` calls, CUDA events,
    after one untimed call unless ``warmup`` is false."""
    if warmup:
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def random_planes(family: str, n: int, h: int, seed: int):
    """Two random planes of the family's kind on the card: int8 +-1
    sites, multispin words of 0/1 nibbles, or bitplane words."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    if family == "stencil":
        return tuple((torch.randint(0, 2, (n, h), generator=g, device="cuda",
                                    dtype=torch.int8) * 2 - 1)
                     for _ in range(2))
    mask = NIBBLES if family == "multispin" else -1
    return tuple(torch.randint(-2 ** 31, 2 ** 31 - 1, (n, h), generator=g,
                               device="cuda", dtype=torch.int32) & mask
                 for _ in range(2))


def acceptance(family: str) -> torch.Tensor:
    """The family's acceptance table at its main path's temperature."""
    inv_temp = 1.0 / TEMPERATURE[family]
    if family == "stencil":
        return metropolis.acceptance_table(inv_temp)
    return multispin.acceptance_thresholds(inv_temp)


def tune(family: str, seed: int = 2 ** 33 + 5) -> dict:
    """``{configuration: ms per full sweep}`` at the family's full plane:
    the per-half-sweep tier, then each candidate that fits the budget."""
    pkg = importlib.import_module(f"repro_torch.kernels.{family}")
    update = getattr(pkg, f"{family}_update")
    sweeps = getattr(pkg, f"{family}_sweeps_resident")
    n, h = FULL_PLANE[family]
    plan = resident.plan_resident(family, n, n)
    table = acceptance(family)
    b, w = random_planes(family, n, h, 1)
    out = {"half-sweep": 2 * timed_ms(lambda: update(
        b, w, table, is_black=True, seed=seed, offset=0), reps=40)}
    for tr, tc, k, threads in CANDIDATES[family]:
        cand = dataclasses.replace(plan, k=k, tile_rows=tr, tile_cols=tc,
                                   threads=threads)
        if resident.smem_bytes(tr, tc, k, family) > cand.budget_bytes:
            continue
        ms = timed_ms(lambda: sweeps(b, w, table, n_sweeps=k, seed=seed,
                                     start_offset=0, plan=cand),
                      reps=max(2, 16 // k))
        label = f"k={k} {tr}x{tc} {threads}t"
        out[label] = ms / k
    return out


def tune_ensemble(family: str, seed: int = 7) -> dict:
    """``{configuration: ms per full sweep of all members}`` at the
    family's ensemble shape (:data:`ENSEMBLE`), the members' seeds
    ``seed``, ``seed + 1``, ...: the per-half-sweep tier and the
    planner's plan on the member axis, each also one member at a time
    (the single-member kernels on member 0's planes, times B), then
    every candidate on the member axis."""
    pkg = importlib.import_module(f"repro_torch.kernels.{family}")
    members, n = ENSEMBLE[family]
    h = n // resident.GEOMETRY[family].col_divisor
    plan = resident.plan_resident(family, n, n)
    table = acceptance(family)
    tables, seeds = [table] * members, [seed + i for i in range(members)]
    b, w = (torch.stack(p) for p in zip(
        *(random_planes(family, n, h, 1 + i) for i in range(members))))
    update = getattr(pkg, f"{family}_update")
    sweeps = getattr(pkg, f"{family}_sweeps_resident")
    out = {"half-sweep": 2 * timed_ms(lambda: getattr(
        pkg, f"{family}_update_batched")(b, w, tables, is_black=True,
                                         seeds=seeds, offset=0), reps=20),
        "half-sweep, one member at a time": 2 * members * timed_ms(
            lambda: update(b[0], w[0], table, is_black=True, seed=seed,
                           offset=0), reps=40),
        f"k={plan.k} plan, one member at a time": members * timed_ms(
            lambda: sweeps(b[0], w[0], table, n_sweeps=plan.k, seed=seed,
                           start_offset=0, plan=plan), reps=16) / plan.k}
    batched = getattr(pkg, f"{family}_sweeps_resident_batched")
    for tr, tc, k, threads in CANDIDATES[family]:
        cand = dataclasses.replace(plan, k=k, tile_rows=tr, tile_cols=tc,
                                   threads=threads)
        if resident.smem_bytes(tr, tc, k, family) > cand.budget_bytes:
            continue
        ms = timed_ms(lambda: batched(b, w, tables, n_sweeps=k, seeds=seeds,
                                      start_offset=0, plan=cand),
                      reps=max(2, 8 // k))
        label = f"k={k} {tr}x{tc} {threads}t"
        if (tr, tc, k, threads) == (plan.tile_rows, plan.tile_cols, plan.k,
                                    plan.threads):
            label += " (plan)"
        out[label] = ms / k
    return out


def tune_shard(family: str, seed: int = 2 ** 33 + 5) -> dict:
    """``{configuration: ms per full sweep of the whole lattice}`` of the
    family's shard kernel on the extended plane of one shard of the
    2 x 2 main path, at the planner's k, times the 4 shards."""
    from repro_torch.dist import kernels as dk
    from repro_torch.dist import planner
    from repro_torch.core.distributed import ShardGrid
    from repro_torch.dist import driver
    from repro_torch.launch.mesh import make_mesh
    n, _ = FULL_PLANE[family]
    plan = planner.plan_shard_resident(family, n, n, 2, 2)
    shape = (plan.n_loc + 2 * plan.halo, plan.w_loc + 2 * plan.halo)
    kernel = getattr(dk, f"{family}_shard_sweeps")
    table = acceptance(family)
    b, w = random_planes(family, *shape, 2)
    grid = ShardGrid.of(make_mesh((2, 2), ("data", "model")), n, plan.width)
    index = driver.index_planes(plan, grid, 3)
    out = {}
    for tr, tc, threads in SHARD_CANDIDATES:
        if planner.shard_smem_bytes(family, tr, tc, plan.k) \
                > plan.budget_bytes:
            continue
        try:
            ms = timed_ms(lambda: kernel(
                b, w, table, *index, n_sweeps=plan.k, seed=seed,
                start_offset=0, tile=(tr, tc, threads)), reps=4)
        except RuntimeError:
            # a block of this many threads needs more registers than an
            # SM has: the launch is refused
            continue
        out[f"{tr}x{tc} {threads}t"] = 4 * ms / plan.k
    return out


def tune_tensorcore(seed: int = 2 ** 33 + 5, lib=None) -> float:
    """ms per half-sweep of ``tensorcore_update`` at the main path's
    planes; with ``lib`` (``tensorcore.library(csrc_dir)`` of an edited
    copy of ``csrc/tensorcore.cu``) of that library's kernel, launched
    with the wrapper's arguments."""
    from repro_torch.kernels.tensorcore import tensorcore as tcm
    g = torch.Generator(device="cuda").manual_seed(2)
    planes = {k: torch.randint(0, 2, (TC_PLANE, TC_PLANE), generator=g,
                               device="cuda", dtype=torch.int8) * 2 - 1
              for k in ("00", "01", "10", "11")}
    inv_temp = 1.0 / TEMPERATURE["stencil"]
    if lib is None:
        return timed_ms(lambda: tcm.tensorcore_update(
            planes, "black", inv_temp, seed=seed, offset=0, block=TC_BLOCK),
            reps=20)
    from repro_torch.kernels.stencil.stencil import raise_on_error
    args = tcm.launch_args(planes, "black", inv_temp, seed=seed, offset=0,
                           block=TC_BLOCK)
    return timed_ms(lambda: raise_on_error(
        lib, lib.tensorcore_update_launch(*args), "tensorcore_update"),
        reps=20)


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--family", choices=FAMILIES, action="append",
                        help="a family to time (default: all three)")
    parser.add_argument("--shard", action="store_true",
                        help="time the shard kernels of the sharded "
                             "resident tier")
    parser.add_argument("--tensorcore", action="store_true",
                        help="time tensorcore_update instead")
    parser.add_argument("--ensemble", action="store_true",
                        help="time the member axis at the ensemble main "
                             "paths' shape")
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        print("tune_resident: no CUDA device", file=sys.stderr)
        return 1
    _build.build()
    results = {}
    if args.tensorcore:
        results["tensorcore"] = {"default": tune_tensorcore()}
        print(f"tensorcore_update, four {TC_PLANE}^2 int8 planes, block "
              f"{TC_BLOCK}, ms per half-sweep: " + ", ".join(
                  f"{c} {ms:.4f}" for c, ms in results["tensorcore"].items()))
    for family in [] if args.tensorcore else args.family or FAMILIES:
        n, _ = FULL_PLANE[family]
        if args.shard:
            from repro_torch.dist.planner import plan_shard_resident
            plan = plan_shard_resident(family, n, n, 2, 2)
            results[family] = tune_shard(family)
            where = f"2 x 2 shards of {n}^2 at k = {plan.k}"
        elif args.ensemble:
            members, n = ENSEMBLE[family]
            plan = resident.plan_resident(family, n, n)
            results[family] = tune_ensemble(family)
            where = f"{members} members of {n}^2"
        else:
            plan = resident.plan_resident(family, n, n)
            results[family] = tune(family)
            where = f"{n}^2"
        print(f"{family} {where}, ms per full sweep (planner: k = "
              f"{plan.k}, tile {plan.tile_rows} x {plan.tile_cols}, "
              f"threads {plan.threads}): " + ", ".join(
                  f"{c} {ms:.4f}" for c, ms in results[family].items()))
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], check=True, capture_output=True,
        text=True).stdout.strip().splitlines()[0])
    print(json.dumps(results))
    return 0


if __name__ == "__main__":
    sys.exit(main())
