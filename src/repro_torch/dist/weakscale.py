"""Weak-scaling rows of the sharded resident tier (counterpart of
``repro.dist.weakscale``).

One row per (family, shard count D): a ``(D, 1)`` mesh with ``base_n *
D`` lattice rows -- per-shard work is constant along the axis.  Every
row records the sweep throughput (flips/ns) and its percentage of the
backend's roofline (``launch.roofline``, at the row's k), the shard planner's
decision (``halo_k``, ``sharded_resident``), the MEASURED halo traffic
per call (deltas of the telemetry counters ``halo_exchanges`` and
``halo_bytes`` -- the evidence that the resident tier exchanges once per
k sweeps instead of twice per sweep), and the serialized ``RunSpec``,
so each number is replayable with ``python -m repro_torch run``.  The
row schema and ``FAMILY_ENGINES`` are the JAX package's.

The shards of a mesh share the devices there are (``launch.mesh``), so
on one card the rows show the halo counters' deltas per call, not
scaling: the card runs the D shards one after another.

    python -m repro_torch.dist.weakscale --devices 1,2,4 --json DIR
"""
from __future__ import annotations

import argparse
import time
from typing import Dict, Iterable, List

#: resident family -> the registry engine that carries it
FAMILY_ENGINES = {
    "stencil": "stencil_pallas",
    "multispin": "multispin_pallas",
    "bitplane": "bitplane_pallas",
}


def measure_rows(devices: Iterable[int], *, base_n: int = 64,
                 cols: int = 128, sweeps: int = 4, trials: int = 2,
                 device=None, families=None) -> List[Dict]:
    """Time the sharded families along the weak-scaling axis: ``devices``
    are the shard counts D (each a ``(D, 1)`` mesh), ``device`` the torch
    device the shards live on (default: the CUDA card), ``families`` the
    keys of :data:`FAMILY_ENGINES` to time (default: all).

    Returns one dict per row: ``name`` (``dist_<family>_d<D>``), ``us``
    (mean us/call), ``times_s`` (per-trial walls), ``engine``, ``k``
    (planner sweeps-per-exchange, 1 on the per-half-sweep tier), ``spec``
    (serialized RunSpec), and ``derived`` (flips/ns + planner decision +
    measured per-call halo traffic).
    """
    import repro_torch.telemetry as tel
    from repro_torch.api import (EngineSpec, LatticeSpec, MeshSpec,
                                 RunSpec, Session)
    from repro_torch.core.engine import ENGINES

    rows: List[Dict] = []
    for nd in devices:
        for family, engine in FAMILY_ENGINES.items():
            if families is not None and family not in families:
                continue
            n = base_n * nd
            spec = RunSpec(
                lattice=LatticeSpec(n=n, m=cols),
                engine=EngineSpec(engine), temperature=2.27, seed=3,
                mesh=MeshSpec(shape=(nd, 1),
                              axis_names=("rows", "cols")))
            session = Session.open(spec, device)
            session.run(sweeps)            # warmup: build and load
            session.magnetization()
            hx0 = tel.HALO_EXCHANGES.value
            hb0 = tel.HALO_BYTES.value
            times = []
            for _ in range(trials):
                t0 = time.perf_counter()
                session.run(sweeps)
                session.magnetization()    # host sync
                times.append(time.perf_counter() - t0)
            hx = (tel.HALO_EXCHANGES.value - hx0) / trials
            hb = (tel.HALO_BYTES.value - hb0) / trials
            attrs = session._runner._dist_attrs
            reps = ENGINES[engine].replicas
            dt = sum(times) / len(times)
            rows.append({
                "name": f"dist_{family}_d{nd}",
                "us": dt * 1e6,
                "times_s": times,
                "engine": engine,
                "k": int(attrs.get("halo_k", 1)),
                "spec": spec.to_json(),
                "derived": {
                    "flips_per_ns": reps * n * cols * sweeps / dt / 1e9,
                    "devices": nd,
                    "sweeps": sweeps,
                    "sharded_resident":
                        int(attrs.get("sharded_resident", False)),
                    "halo_k": int(attrs.get("halo_k", 1)),
                    "halo_exchanges_per_call": hx,
                    "halo_kb_per_call": round(hb / 1024, 3),
                },
            })
    return rows


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.dist.weakscale",
        description="weak-scaling rows of the sharded resident tier")
    ap.add_argument("--devices", default="1,2,4",
                    help="comma list of shard counts D (each a (D,1) "
                         "mesh; its shards share the devices there are)")
    ap.add_argument("--base-n", type=int, default=64,
                    help="lattice rows PER SHARD (n = base_n * D)")
    ap.add_argument("--cols", type=int, default=128)
    ap.add_argument("--sweeps", type=int, default=4,
                    help="sweeps per timed call")
    ap.add_argument("--trials", type=int, default=2)
    ap.add_argument("--device", default="",
                    help="torch device, e.g. cpu (default: the CUDA card)")
    ap.add_argument("--json", nargs="?", const=".", default=None,
                    metavar="DIR_OR_PATH",
                    help="write a BENCH_<stamp>.json perf record "
                         "(marked filtered: meta.only = 'dist')")
    args = ap.parse_args(argv)
    shards = [int(d) for d in args.devices.split(",") if d]
    if not shards or any(d < 1 for d in shards):
        ap.error(f"--devices must be positive ints, got {args.devices!r}")

    import torch

    from repro_torch.analysis.recorder import RunRecorder
    from repro_torch.launch import roofline as rl
    # the record's backend is the device type the rows ran on ("cpu:0"
    # too), so a CPU run never reads the card's roofline or count
    backend = torch.device(args.device or "cuda").type
    rec = RunRecorder(echo=True, meta={
        "stamp": time.strftime("%Y%m%d_%H%M%S"),
        "backend": backend,
        "device_count": 1 if backend == "cpu" else torch.cuda.device_count(),
        "only": "dist", "trials": args.trials})
    for row in measure_rows(shards, base_n=args.base_n, cols=args.cols,
                            sweeps=args.sweeps, trials=args.trials,
                            device=args.device or None):
        derived = dict(row["derived"])
        derived["engine"] = row["engine"]
        pct = rl.pct_of_roofline(derived["flips_per_ns"], row["engine"],
                                 backend, k=row["k"])
        if pct is not None:
            derived["pct_of_roofline"] = round(pct, 4)
        rec.record(row["name"], row["us"], spec=row["spec"],
                   times_us=[t * 1e6 for t in row["times_s"]],
                   **derived)
    if args.json is not None:
        from repro_torch.perf.schema import validate_record
        validate_record({"meta": rec.meta, "rows": rec.rows})
        print(f"# wrote {rec.write_json(args.json)}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
