"""The control of ``correct``: the reference one precision step down.

    python3 bench/control.py --workload <cell> --seed <n> [--seed <n> ...]

The configurations state the acceptance probability in float32 (the
thresholds ``floor(p 2^32)`` of a float32 ``p``); the control computes
it in bfloat16 and puts the reference so computed in the program's
place, at the cell's own size, from the benchmark's own first lattice
of each seed: the same tiles and the same whole-lattice samples as a
run's checks, each compared with the float32 reference by the same
count.  A run's ``last_sample`` judges the observables of the state
the call left, which the control computes exactly, so the control does
not read it (a planted fault does, in ``bench/tests``).  Every count it
prints has to exceed its limit (0).  The
benchmark's runs never run it; it needs no program.
"""
from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

from bench import check, harness, lattice  # noqa: E402
from bench.reference import ising  # noqa: E402


def readings(cell: harness.Cell, seed: int, device) -> dict:
    """The control's counts for one seed, named as a run's checks."""
    import torch
    g = cell.geometry
    t = cell.traffic
    sweeps = cell.sweeps_per_call
    temperature = cell.config["spec"]["temperature"]
    sound = ising.thresholds(temperature, "float32")
    lower = ising.thresholds(temperature, "bfloat16")
    devices = ([torch.device(device)] if g.shards == 1 or device == "cpu"
               else [torch.device("cuda", i)
                     for i in range(torch.cuda.device_count())])
    home = devices[0]
    fresh = lattice.fresh(g, seed, devices)
    tiles = check.tiles(g, seed, sweeps, cell.block)
    regions = tiles.read(fresh, tiles.pad, home)
    out = {}
    name = "start_tiles" if t["entry"] == "run" else "last_tiles"
    out[name] = check.differing_sites(
        check.follow(tiles, regions, 0, sweeps, seed, lower),
        check.follow(tiles, regions, 0, sweeps, seed, sound))
    if t["entry"] == "measure":
        planes = check.whole(fresh, g, home)
        del fresh
        count = int(t["n_measure"])
        args = (g.layout, planes, 0, int(t["sweeps_between"]),
                int(t.get("thermalize", 0)), count, seed)
        ours = check.reference_samples(*args, lower)
        ref = check.reference_samples(*args, sound)
        out["start_samples"] = sum(
            check.differing_values(ours[k], ref[k], t["fields"])
            for k in range(count))
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, action="append", required=True)
    args = p.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("control: needs a CUDA card", file=sys.stderr)
        return 2
    cell = harness.Cell.load(harness.load_benchmark(), args.workload)
    for seed in args.seed:
        t0 = time.perf_counter()
        r = readings(cell, seed, "cuda")
        print(json.dumps({"workload": args.workload, "seed": seed,
                          "control": r, "limits": check.LIMITS,
                          "seconds": time.perf_counter() - t0}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
