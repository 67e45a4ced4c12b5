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

    # the 2D +-J spin glass, 70 % of its bonds ferromagnetic; Wolff
    # cluster flips (a "sweep" is one cluster); the basic engines
    python -m repro_torch run --engine spinglass --p-ferro 0.7 --n 1024 \\
        --temperature 1.5 --sweeps 200
    python -m repro_torch run --engine wolff --n 512 --init-p-up 1.0 \\
        --temperature 1.8 --sweeps 100
    python -m repro_torch run --engine basic_philox --n 1024 --sweeps 200

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

    # supervised: verified checkpoints into DIR every 100 sweeps, chunks
    # of 50 sweeps, SIGTERM/SIGINT-safe (exit 3 = preempted: run the same
    # command again to resume from the newest valid step); a Chrome trace
    # of spans and counters (python -m repro_torch.telemetry summarize)
    python -m repro_torch run --engine multispin_pallas --n 32768 \
        --init-p-up 1.0 --temperature 2.0 --sweeps 200 --supervise DIR \
        --ckpt-every-sweeps 100 --chunk 50 --trace trace.json

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
    if args.p_ferro is not None:
        params["p_ferro"] = args.p_ferro
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


def _finish_trace(args, spec) -> None:
    """Write the ``--trace`` file (validated first), if one was asked
    for."""
    if not args.trace:
        return
    import repro_torch.telemetry as tel
    path = tel.export(args.trace,
                      meta={"engine": spec.engine.name, "mode": spec.mode,
                            "lattice": [spec.lattice.n, spec.lattice.m],
                            "spec_json": spec.to_json()})
    print(f"# wrote trace {path} (inspect: python -m "
          f"repro_torch.telemetry summarize {path})", file=sys.stderr)


def _cmd_supervise(args, spec, device) -> int:
    """The ``--supervise DIR`` path: a preemption-safe supervised run with
    periodic verified checkpoints and resume from the newest valid step.
    Exit 0 on completion, 3 when preempted (progress checkpointed: run
    the same command again to resume), 2 without ``--sweeps``."""
    from repro_torch.resilience import Supervisor, faults
    faults.install_from_env()  # chaos drill: a REPRO_FAULTS JSON plan
    if not args.sweeps:
        print("--supervise needs --sweeps N (the run target)",
              file=sys.stderr)
        return 2
    sup = Supervisor(spec, args.supervise,
                     every_sweeps=args.ckpt_every_sweeps,
                     every_seconds=args.ckpt_every_seconds,
                     chunk=args.chunk, keep=args.keep, device=device)
    if sup.resumed_from is not None:
        print(f"# resumed from step {sup.resumed_from} "
              f"in {args.supervise}")
    res = sup.run(args.sweeps)
    print(f"supervised run {res.status} at sweep {res.step_count}/"
          f"{args.sweeps}; checkpoints written: "
          f"{res.checkpoints_written}")
    print(f"final_state_digest={res.digest}")
    _finish_trace(args, spec)
    return 0 if res.completed else 3


def cmd_run(args) -> int:
    from repro_torch.api import Session, describe, load_spec
    device = args.device or None
    if args.trace:
        import repro_torch.telemetry as tel
        tel.enable()
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

    plan = describe(spec)   # the spec.validate span, as the JAX CLI's
    if args.dry_run:
        print(json.dumps(plan, indent=1, sort_keys=True))
        print(f"# dry run OK: mode={plan['mode']} engine={plan['engine']} "
              f"lattice={plan['lattice'][0]}x{plan['lattice'][1]} "
              f"batch={plan['batch_size']}", file=sys.stderr)
        _finish_trace(args, spec)
        return 0

    if args.supervise:
        return _cmd_supervise(args, spec, device)

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
        _finish_trace(args, spec)
        return 2
    if args.save:
        session.save(args.save)
        print(f"# wrote checkpoint {args.save} (step {session.step_count})")
    if args.record is not None:
        _record(args, session, rows)
    _finish_trace(args, spec)
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
    run.add_argument("--p-ferro", type=float, default=None,
                     help="spinglass: probability that a bond is "
                          "ferromagnetic (default 0.5)")
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
    # supervised (fault-tolerant) execution
    run.add_argument("--supervise", default="", metavar="DIR",
                     help="run under the resilience supervisor: periodic "
                          "verified checkpoints into DIR, SIGTERM/SIGINT-"
                          "safe, resume from the newest valid step (exit "
                          "3 = preempted, rerun to resume)")
    run.add_argument("--ckpt-every-sweeps", type=int, default=0,
                     help="supervisor checkpoint cadence in sweeps "
                          "(0: off)")
    run.add_argument("--ckpt-every-seconds", type=float, default=0.0,
                     help="supervisor checkpoint cadence in wall-clock "
                          "seconds (0: off)")
    run.add_argument("--chunk", type=int, default=64,
                     help="supervisor sweep-chunk between control points "
                          "(a fixed grid, as in the JAX package)")
    run.add_argument("--keep", type=int, default=3,
                     help="checkpoint steps the supervisor retains")
    run.add_argument("--trace", default="", metavar="PATH",
                     help="enable span tracing; write the Chrome trace "
                          "(.json, Perfetto-loadable) or .jsonl stream and "
                          "the metrics snapshot here")
    run.set_defaults(fn=cmd_run)
    args = ap.parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    raise SystemExit(main())
