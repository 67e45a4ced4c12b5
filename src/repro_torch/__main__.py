"""``python -m repro_torch run`` -- single, ensemble and sharded runs.

One command drives every mode from one ``RunSpec``: pass a spec JSON
file (written by either package), or build one from flags.  The record
JSON and the checkpoint both hold the spec, so a result replays from
either alone:

    # declaratively, from a spec document; a validated JSON record
    python -m repro_torch run spec.json --record results/

    # validate and print the dispatch plan: no device work, no card
    # needed (also of a checkpoint: --restore ck.npz --dry-run)
    python -m repro_torch run spec.json --dry-run

    # 1024^2 ordered start at T=2.0: 200 sweeps, then 10 samples of the
    # magnetization only; write the equivalent spec
    python -m repro_torch run --n 1024 --init-p-up 1.0 --temperature 2.0 \\
        --sweeps 200 --n-measure 10 --measure-every 5 --fields m \\
        --out-spec spec.json --save ck.npz

    # 32 replicas of 512^2 in bitplane words, hot start at T=3.0
    python -m repro_torch run --engine bitplane_pallas --n 512 \\
        --temperature 3.0 --sweeps 200

    # the tensor-core engine (paper S3.2) on 64 x 64 blocks of its planes
    python -m repro_torch run --engine tensorcore --tc-block 64 --n 1024 \\
        --init-p-up 1.0 --temperature 2.0 --sweeps 200

    # an ensemble: 2 temperatures x 2 seeds (--grid; without it the two
    # lists zip), 4 members in one launch a block of sweeps; one line a
    # member
    python -m repro_torch run --n 1024 --init-p-up 1.0 --temps 1.8,2.2 \\
        --seeds 3,4 --grid --sweeps 200

    # sharded: a 2 x 2 mesh of shards (rows over "data", columns over
    # "model"), several shards to a card where there are fewer cards
    python -m repro_torch run --n 1024 --init-p-up 1.0 --temperature 2.0 \\
        --sweeps 200 --mesh 2x2 --mesh-axes data,model --save ck.npz

    # resume a checkpoint written by this package or by ``python -m repro``
    # (on the mesh it was saved on)
    python -m repro_torch run --restore ck.npz --sweeps 100

The paper's Fig. 5/6 temperature scan is
``python -m repro_torch.analysis.figures [--smoke]``.  Runs on the CUDA
card unless ``--device cpu`` is given.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time

import numpy as np
import torch


def _build_spec(args):
    from repro_torch.api import (BatchSpec, EngineSpec, LatticeSpec,
                                 MeshSpec, RunSpec, SweepSpec)
    if args.spec:
        with open(args.spec) as f:
            return RunSpec.from_json(f.read())
    params = {}
    if args.tc_block is not None:
        params["tc_block"] = args.tc_block
    sweep = None
    if args.n_measure:
        sweep = SweepSpec(thermalize=args.thermalize,
                          measure_every=args.measure_every,
                          n_measure=args.n_measure,
                          fields=tuple(args.fields.split(",")))
    batch = None
    if args.temps:
        temps = tuple(float(t) for t in args.temps.split(","))
        seeds = tuple(int(s) for s in args.seeds.split(",")) \
            if args.seeds else None
        batch = BatchSpec(temperatures=temps, seeds=seeds, grid=args.grid)
    mesh = None
    if args.mesh:
        shape = tuple(int(d) for d in args.mesh.split("x"))
        names = tuple(args.mesh_axes.split(",")) if args.mesh_axes \
            else tuple(f"ax{i}" for i in range(len(shape)))
        mesh = MeshSpec(shape=shape, axis_names=names)
    return RunSpec(lattice=LatticeSpec(n=args.n, m=args.m or args.n,
                                       init_p_up=args.init_p_up),
                   engine=EngineSpec(name=args.engine, params=params),
                   temperature=args.temperature, seed=args.seed,
                   sweep=sweep, batch=batch, mesh=mesh)


def _sync(session) -> None:
    if session.device.type == "cuda":
        torch.cuda.synchronize(session.device)


def _summarize(traj: dict) -> dict:
    """Scalar summary of a measured trajectory: each field's mean over
    the final half of the samples, and of its absolute value."""
    out = {}
    for k, v in traj.items():
        tail = np.asarray(v)[len(v) // 2:]
        out[f"{k}_mean"] = float(np.mean(tail))
        out[f"abs_{k}_mean"] = float(np.mean(np.abs(tail)))
    return out


def _card(device) -> dict:
    """The backend, device count and, on the card, the name and power
    limit of ``device`` (as ``nvidia-smi`` reads them)."""
    if device.type != "cuda":
        return {"backend": "cpu", "device_count": 1}
    index = device.index if device.index is not None else \
        torch.cuda.current_device()
    out = {"backend": "cuda", "device_count": torch.cuda.device_count(),
           "device_name": torch.cuda.get_device_name(index),
           "power_limit": None}
    try:
        line = subprocess.run(
            ["nvidia-smi", f"--id={index}", "--query-gpu=power.limit",
             "--format=csv,noheader"], check=True, capture_output=True,
            text=True, timeout=30).stdout.strip()
        out["power_limit"] = line or None
    except (OSError, subprocess.SubprocessError):
        pass
    return out


def _record(args, session, rows) -> None:
    """Write the ``--record`` JSON, validated by the perf-record schema
    first."""
    from repro_torch.analysis.recorder import RunRecorder
    from repro_torch.perf.schema import validate_record
    spec = session.spec
    meta = {"spec": spec.to_dict(), "mode": session.mode,
            "step_count": session.step_count,
            "stamp": time.strftime("%Y%m%d_%H%M%S")}
    meta.update(_card(session.device))
    rec = RunRecorder(meta=meta)
    for name, us, derived in rows:
        rec.record(name, us, spec=spec.to_json(), **derived)
    validate_record({"meta": rec.meta, "rows": rec.rows})
    print(f"# wrote record {rec.write_json(args.record)}")


def cmd_run(args) -> int:
    from repro_torch.api import Session, describe, load_spec
    device = args.device or None
    session = None
    if args.restore and not args.dry_run:
        session = Session.restore(args.restore, device=device)
        spec = session.spec
    elif args.restore:
        spec = load_spec(args.restore)
    else:
        spec = _build_spec(args)

    if args.out_spec:
        with open(args.out_spec, "w") as f:
            f.write(spec.to_json(indent=1) + "\n")
        print(f"# wrote spec {args.out_spec}")

    if args.dry_run:
        plan = describe(spec)
        print(json.dumps(plan, indent=1, sort_keys=True))
        print(f"# dry run OK: mode={plan['mode']} engine={plan['engine']} "
              f"lattice={plan['lattice'][0]}x{plan['lattice'][1]} "
              f"batch={plan['batch_size']}", file=sys.stderr)
        return 0

    if session is None:
        session = Session.open(spec, device=device)
    rows = []
    members = spec.batch.members if spec.batch is not None else None
    if spec.sweep is not None:
        t0 = time.perf_counter()
        traj = session.measure()
        dt = time.perf_counter() - t0
        rows.append(("measure", dt * 1e6, _summarize(traj)))
        tail = {k: np.asarray(v)[len(v) // 2:] for k, v in traj.items()}
        print(f"measured {spec.sweep.n_measure} samples "
              f"({spec.sweep.total_sweeps} sweeps) in {dt:.2f}s: " +
              " ".join(f"{k}_mean={float(np.mean(v)):.4f}"
                       for k, v in tail.items()))
        if members is not None:
            # the samples' member axis: (n_measure, B) or (n_measure, B, 32)
            for i, (t, seed) in enumerate(members):
                print(f"member {i} T={t:g} seed={seed}: " + " ".join(
                    f"{k}_mean={float(np.mean(v[:, i])):.4f}"
                    for k, v in tail.items()))
    if args.sweeps:
        _sync(session)
        t0 = time.perf_counter()
        session.run(args.sweeps)
        mag = session.magnetization()  # waits for the device
        dt = time.perf_counter() - t0
        rows.append(("run", dt * 1e6,
                     {"sweeps": args.sweeps,
                      "mean_abs_m": float(np.mean(np.abs(mag)))}))
        where = session.device if spec.mesh is None else \
            f"a {'x'.join(map(str, spec.mesh.shape))} mesh"
        if members is None:
            print(f"ran {args.sweeps} sweeps in {dt:.2f}s on {where}; "
                  f"|m| = {abs(mag):.4f}")  # bitplane: |mean over replicas|
        else:
            print(f"ran {args.sweeps} sweeps of {len(members)} members in "
                  f"{dt:.2f}s on {where}")
            for i, (t, seed) in enumerate(members):
                print(f"member {i} T={t:g} seed={seed}: "
                      f"|m| = {abs(float(mag[i])):.4f}")
    if not rows:
        print("nothing to do: no sweep plan and --sweeps is 0 (use "
              "--dry-run to just validate)", file=sys.stderr)
        return 2
    if args.save:
        session.save(args.save)
        print(f"# wrote checkpoint {args.save} (step {session.step_count})")
    if args.record is not None:
        _record(args, session, rows)
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch",
        description="RunSpec launcher of the PyTorch port")
    sub = ap.add_subparsers(dest="cmd", required=True)
    run = sub.add_parser(
        "run", help="execute a single, ensemble or sharded RunSpec",
        formatter_class=argparse.ArgumentDefaultsHelpFormatter)
    run.add_argument("spec", nargs="?", default="",
                     help="RunSpec JSON file (the flags that build a spec "
                          "are then ignored)")
    run.add_argument("--dry-run", action="store_true",
                     help="parse, validate and print the dispatch plan; "
                          "no device work")
    run.add_argument("--n", type=int, default=64)
    run.add_argument("--m", type=int, default=0,
                     help="lattice cols (default: --n)")
    run.add_argument("--init-p-up", type=float, default=0.5)
    from repro_torch.core.engine import ENGINES
    run.add_argument("--engine", default="multispin",
                     choices=sorted(ENGINES))
    run.add_argument("--tc-block", type=int, default=None,
                     help="tensorcore: block of the banded products "
                          "(default 128)")
    run.add_argument("--temperature", type=float, default=2.0)
    run.add_argument("--seed", type=int, default=1234)
    run.add_argument("--thermalize", type=int, default=0)
    run.add_argument("--measure-every", type=int, default=1)
    run.add_argument("--n-measure", type=int, default=0,
                     help="samples to record (0: plain --sweeps run)")
    run.add_argument("--fields", default="m,e",
                     help="comma list of the observables to sample")
    run.add_argument("--sweeps", type=int, default=0,
                     help="plain sweeps to run (after any sweep plan)")
    run.add_argument("--temps", default="",
                     help="comma list of temperatures: an ensemble "
                          "(BatchSpec), one member each")
    run.add_argument("--seeds", default="",
                     help="comma list of member seeds (below 2^32; "
                          "default 0, 1, ...)")
    run.add_argument("--grid", action="store_true",
                     help="members: the temps x seeds cross product")
    run.add_argument("--mesh", default="",
                     help="mesh shape of a sharded run, e.g. 2x2")
    run.add_argument("--mesh-axes", default="",
                     help="comma list of mesh axis names (default "
                          "ax0,ax1,...)")
    run.add_argument("--save", default="", help="checkpoint path to write")
    run.add_argument("--restore", default="",
                     help="checkpoint to resume (overrides the spec and "
                          "the flags); with --dry-run only its spec is "
                          "read")
    run.add_argument("--out-spec", default="",
                     help="write the canonical spec JSON here")
    run.add_argument("--record", nargs="?", const=".", default=None,
                     metavar="DIR_OR_PATH",
                     help="write a validated JSON record holding the spec "
                          "(a directory gets BENCH_<stamp>.json)")
    run.add_argument("--device", default="",
                     help="torch device, e.g. cpu (default: the CUDA card)")
    run.set_defaults(fn=cmd_run)
    args = ap.parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    raise SystemExit(main())
