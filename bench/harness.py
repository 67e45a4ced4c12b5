"""The benchmark of the PyTorch and CUDA port, driven by data.

``BENCHMARK.json`` names the cells.  A cell's configuration is the file
its ``configs`` entry names (``bench/configs/<name>.json``: the
``RunSpec`` fields, the state's layout, the work-count family), its
traffic mix ``bench/traffic/<traffic>.json`` (which public entry a call
makes and with what), and each metric a reader of its own,
``bench/metrics/<name>.py``, whose ``read(ctx)`` returns a number or
``None`` where it finds nothing to read.  A new cell, mix or metric is
new files and new entries; no file here changes.

One run, ``python bench/run.py --workload <cell> --seed <n> --seconds
<s> --trace <0|1>``:

1. set-up (``setup_s``, from the process's start): the session of the
   cell's spec through ``Session.open``, the benchmark's own lattice
   from the seed written into its planes (``bench/lattice.py``), one
   call of the cell's traffic, which builds and warms every kernel;
2. the window: back-to-back calls until ``--seconds`` have passed, then
   every card synchronized.  The host runs one call ahead of the cards,
   no more (it waits for the end of the call before the one it has just
   queued), so the window overshoots by one call at most and the launch
   queue never fills.  With ``--trace 1`` the window runs under
   ``torch.profiler``;
3. the peak of device memory; the check call, one more call of the
   same program, untimed, with tiles of the state read before and after
   it; then the checks (``bench/check.py``) once the program's state is
   freed, and the result as the last line of standard output.

It imports the program (``repro_torch``) and nothing of the JAX
package, and fails, printing no result, where a card is missing or the
JAX package was loaded.
"""
from __future__ import annotations

import argparse
import dataclasses
import gc
import importlib.util
import json
import os
import shutil
import sys
import tempfile
import time
from pathlib import Path
from typing import List, Optional

BENCH_DIR = Path(__file__).resolve().parent
ROOT = BENCH_DIR.parent
#: top-level modules that must not be loaded in a run's process
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


# -- loading what BENCHMARK.json names ---------------------------------------

def load_benchmark() -> dict:
    with open(ROOT / "BENCHMARK.json") as f:
        return json.load(f)


def _json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def load_metric(name: str):
    """The reader module ``bench/metrics/<name>.py``."""
    path = BENCH_DIR / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        "bench_metric_" + name.replace(".", "_").replace("-", "_"), path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _applies(entry: dict, cell: str) -> bool:
    return "workloads" not in entry or cell in entry["workloads"]


@dataclasses.dataclass
class Cell:
    """One workload of ``BENCHMARK.json`` with its files read."""

    name: str
    chips: int
    config: dict
    traffic: dict
    end_to_end: List[dict]
    per_layer: List[dict]

    @classmethod
    def load(cls, benchmark: dict, name: str) -> "Cell":
        work = {w["name"]: w for w in benchmark["workloads"]}
        if name not in work:
            raise SystemExit(f"unknown workload {name!r}; BENCHMARK.json "
                             f"has {sorted(work)}")
        w = work[name]
        configs = {c["name"]: c for c in benchmark["configs"]}
        config = _json(ROOT / configs[w["config"]]["file"])
        traffic = _json(BENCH_DIR / "traffic" / f"{w['traffic']}.json")
        return cls(name, int(w["chips"]), config, traffic,
                   [m for m in benchmark["end_to_end"] if _applies(m, name)],
                   [m for m in benchmark["per_layer"] if _applies(m, name)])

    @property
    def geometry(self):
        from bench.lattice import Geometry
        return Geometry.of(self.config)

    @property
    def block(self):
        """The k-sweep kernel's ``(rows, words)`` of the family, if its
        file names one."""
        from bench import roofline
        b = roofline.family(self.config["family"]).get("block")
        return (int(b["rows"]), int(b["words"])) if b else None

    @property
    def sweeps_per_call(self) -> int:
        t = self.traffic
        if t["entry"] == "run":
            return int(t["sweeps"])
        return int(t.get("thermalize", 0)) + int(t["n_measure"]) * int(
            t["sweeps_between"])

    @property
    def flips_per_call(self) -> int:
        g = self.geometry
        return self.sweeps_per_call * g.n * g.m * int(self.config["replicas"])


# -- the program --------------------------------------------------------------

class Program:
    """The system under test: one ``repro_torch`` session of the cell's
    spec, holding the benchmark's lattice, driven through its public
    entry points."""

    def __init__(self, cell: Cell, seed: int, device=None):
        from repro_torch.api.session import Session
        from repro_torch.api.spec import RunSpec

        from bench import lattice
        spec = RunSpec.from_dict({**cell.config["spec"], "seed": int(seed)})
        self.session = Session.open(spec, device)
        state = self.session.state
        lattice.fill(state, cell.geometry, seed)
        self.session.state = state
        t = cell.traffic
        self.entry = t["entry"]
        if self.entry == "run":
            self.sweeps = int(t["sweeps"])
        elif self.entry == "measure":
            from repro_torch.analysis.measure import MeasurementPlan
            self.plan = MeasurementPlan(int(t["n_measure"]),
                                        int(t["sweeps_between"]),
                                        int(t.get("thermalize", 0)),
                                        tuple(t["fields"]))
        else:
            raise ValueError(f"unknown traffic entry {self.entry!r}")

    def call(self):
        """One call of the traffic: ``Session.run`` (returns ``None``) or
        ``Session.measure`` (returns its samples on the host)."""
        if self.entry == "run":
            self.session.run(self.sweeps)
            return None
        return self.session.measure(self.plan)

    @property
    def state(self):
        return self.session.state


# -- one run ------------------------------------------------------------------

@dataclasses.dataclass
class Context:
    """What a metric's reader reads."""

    cell: Cell
    setup_s: float
    window_s: float
    calls: int
    peak_bytes: int
    chips: int
    devices: tuple
    trace: Optional[object] = None

    @property
    def entry(self) -> str:
        return self.cell.traffic["entry"]

    @property
    def sweeps(self) -> int:
        return self.calls * self.cell.sweeps_per_call

    @property
    def flips(self) -> int:
        return self.calls * self.cell.flips_per_call

    @property
    def samples(self) -> int:
        return self.calls * int(self.cell.traffic.get("n_measure", 0))


def _sync(devices) -> None:
    import torch
    for d in devices:
        torch.cuda.synchronize(d)


def _record(devices) -> list:
    """An event at the end of the work queued so far on each card."""
    import torch
    events = []
    for d in devices:
        e = torch.cuda.Event()
        e.record(torch.cuda.current_stream(d))
        events.append(e)
    return events


def _devices_of(state) -> tuple:
    from bench import lattice
    return tuple(sorted({p.device.index for p in lattice.planes(state)[0]
                         if p.device.type == "cuda"}))


def run_cell(cell: Cell, seed: int, seconds: float, trace: bool,
             t_start: float, device=None):
    """Set up, measure and check one run; returns ``(result, checks)``."""
    import torch

    from bench import check, lattice
    from bench.reference import ising

    g = cell.geometry
    program = Program(cell, seed, device)
    home = lattice.planes(program.state)[0][0].device
    devices = _devices_of(program.state)
    if home.type == "cuda" and len(devices) < cell.chips:
        raise SystemExit(f"bench: {cell.name} asks for {cell.chips} cards "
                         f"and its state lies on {len(devices)}; no result")
    tiles = check.tiles(g, seed, cell.sweeps_per_call, cell.block)
    warm = program.call()
    warm_tiles = tiles.read(program.state, 0, home)
    _sync(devices)
    w = _window(program, devices, seconds, trace)
    peak = max((torch.cuda.max_memory_allocated(d) for d in devices),
               default=0)

    before = tiles.read(program.state, tiles.pad, home)
    last = program.call()
    final_tiles = tiles.read(program.state, 0, home)
    final_obs = None
    if program.entry == "measure":
        final_obs = ising.observables(g.layout,
                                      *check.whole(program.state, g, home))
    shard_devices = [p.device for p in lattice.planes(program.state)[0]]
    del program
    gc.collect()
    torch.cuda.empty_cache()

    checks = _checks(cell, seed, tiles, home, shard_devices, warm,
                     warm_tiles, w.calls, before, last, final_tiles,
                     final_obs)
    limits = check.LIMITS
    named = {k: {"value": v, "limit": limits[k]} for k, v in checks.items()}
    ctx = Context(cell, w.t0 - t_start, w.t1 - w.t0, w.calls, peak,
                  len(devices), devices, w.summary)
    metrics = {}
    for m in cell.per_layer if trace else cell.end_to_end:
        value = load_metric(m["name"]).read(ctx)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    dev = {"platform": "gpu" if devices else home.type,
           "kind": torch.cuda.get_device_name(devices[0]) if devices
           else home.type,
           "count": len(devices), "memory_peak_bytes": int(peak)}
    result = {"correct": all(v <= limits[k] for k, v in checks.items()),
              "attempted": w.calls, "failed": 0, "metrics": metrics,
              "device": dev}
    if w.summary is not None:
        dev["busy_s"] = w.summary.mean_busy_s()
        dev["window_s"] = w.summary.window_s
        result["breakdown"] = w.summary.breakdown()
    result["checks"] = named
    return result, named


@dataclasses.dataclass
class Window:
    """What the measured window did."""

    t0: float
    t1: float
    calls: int
    summary: object     # the trace's ``Summary``, or ``None``


def _window(program: Program, devices, seconds: float,
            trace: bool) -> Window:
    """Calls back to back until ``seconds`` have passed and the cards
    are synchronized, the host one call ahead of the cards at most."""
    from torch.profiler import record_function

    from bench.trace import WINDOW
    prof = None
    if trace:
        from torch.profiler import ProfilerActivity, profile
        prof = profile(activities=[ProfilerActivity.CPU,
                                   ProfilerActivity.CUDA])
        prof.__enter__()
    calls, queued = 0, []
    t0 = time.perf_counter()
    with record_function(WINDOW):
        while True:
            program.call()
            calls += 1
            ended = _record(devices)
            for event in queued:
                event.synchronize()
            queued = ended
            if time.perf_counter() - t0 >= seconds:
                break
        _sync(devices)
    t1 = time.perf_counter()
    summary = None
    if prof is not None:
        prof.__exit__(None, None, None)
        summary = _read_trace(prof, devices)
    return Window(t0, t1, calls, summary)


def _checks(cell: Cell, seed: int, tiles, home, shard_devices, warm,
            warm_tiles, calls: int, before, last, final_tiles,
            final_obs) -> dict:
    """Every comparison of ``bench/check.py``, once the program is
    freed: the first call from the benchmark's lattice anew, the check
    call, which follows the window's ``calls`` calls, from the tiles
    read before it."""
    from bench import check, lattice
    from bench.reference import ising

    g = cell.geometry
    t = cell.traffic
    sweeps = cell.sweeps_per_call
    thr = ising.thresholds(cell.config["spec"]["temperature"])
    out = {}
    fresh = lattice.fresh(g, seed, shard_devices)
    if t["entry"] == "run":
        start = tiles.read(fresh, tiles.pad, home)
        del fresh
        out["start_tiles"] = check.differing_sites(
            warm_tiles, check.follow(tiles, start, 0, sweeps, seed, thr))
    else:
        planes = check.whole(fresh, g, home)
        del fresh
        count = int(t["n_measure"])
        ref = check.reference_samples(
            g.layout, planes, 0, int(t["sweeps_between"]),
            int(t.get("thermalize", 0)), count, seed, thr)
        del planes
        out["start_samples"] = sum(
            check.differing_values(check.as_dict(warm, k, t["fields"]),
                                   ref[k], t["fields"])
            for k in range(count))
    out["last_tiles"] = check.differing_sites(
        final_tiles,
        check.follow(tiles, before, sweeps * (calls + 1), sweeps, seed, thr))
    if t["entry"] == "measure":
        out["last_sample"] = check.differing_values(
            check.as_dict(last, -1, t["fields"]), final_obs, t["fields"])
    return out


def _read_trace(prof, devices):
    """The profiled window's :class:`bench.trace.Summary`, read from the
    exported trace in a temporary directory, which goes again."""
    from bench import trace
    tmp = tempfile.mkdtemp(prefix="bench-trace-")
    try:
        path = os.path.join(tmp, "trace.json")
        prof.export_chrome_trace(path)
        return trace.summarize(trace.load(path), devices)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def forbidden_modules() -> List[str]:
    """Loaded top-level modules that a run may not hold, compared whole."""
    return sorted({name.split(".")[0] for name in list(sys.modules)}
                  & set(FORBIDDEN))


def main(argv, t_start: float) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)
    cell = Cell.load(load_benchmark(), args.workload)
    import torch
    if not torch.cuda.is_available() \
            or torch.cuda.device_count() < cell.chips:
        have = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"bench: {args.workload} needs {cell.chips} CUDA card(s), "
              f"this machine has {have}; no result", file=sys.stderr)
        return 2
    torch.set_num_threads(2)
    result, checks = run_cell(cell, args.seed, args.seconds,
                              bool(args.trace), t_start)
    bad = forbidden_modules()
    if bad:
        print(f"bench: the run's process holds {bad}: no module of the JAX "
              f"package may be loaded; no result", file=sys.stderr)
        return 3
    for name, c in checks.items():
        print(f"check {name}: {c['value']} (limit {c['limit']})",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0
