"""``python -m repro_torch.resilience`` -- checkpoint chaos & triage CLI.

Counterpart of ``python -m repro.resilience``.  Two subcommands, built
for the chaos drill and for post-mortems:

    # corrupt a step in a known, deterministic way (default: newest)
    python -m repro_torch.resilience corrupt CKPT_DIR --mode flip-byte

    # validate every committed step; JSON report of the problems
    python -m repro_torch.resilience validate CKPT_DIR

``corrupt`` applies one of the
:data:`repro_torch.resilience.faults.CORRUPTERS` crash topologies to a
real checkpoint directory; ``validate`` runs the same integrity checks
restore runs (exit 0 when at least one step is restorable, 1
otherwise).  Either works on either package's directories.
"""
from __future__ import annotations

import argparse
import json
import sys

from repro_torch.ckpt import Checkpointer

from . import faults


def cmd_corrupt(args) -> int:
    ck = Checkpointer(args.dir)
    step = args.step
    if step is None:
        # newest committed step, VALID or not: corrupting an already-
        # broken step would silently test nothing
        steps = ck.all_steps()
        if not steps:
            print(f"no committed steps in {args.dir}", file=sys.stderr)
            return 1
        step = steps[-1]
    path = faults.CORRUPTERS[args.mode](args.dir, step)
    print(f"# corrupted step {step} ({args.mode}): {path}")
    return 0


def cmd_validate(args) -> int:
    ck = Checkpointer(args.dir)
    report = {"dir": args.dir, "steps": {}}
    for s in ck.all_steps():
        problems = ck.validate_step(s)
        report["steps"][str(s)] = {"valid": not problems,
                                   "problems": problems}
    latest = ck.latest_step()
    report["latest_valid_step"] = latest
    print(json.dumps(report, indent=1, sort_keys=True))
    return 0 if latest is not None else 1


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.resilience",
        description="checkpoint fault injection and validation")
    sub = ap.add_subparsers(dest="cmd", required=True)

    cor = sub.add_parser("corrupt",
                         help="apply a crash topology to one step")
    cor.add_argument("dir", help="Checkpointer directory")
    cor.add_argument("--step", type=int, default=None,
                     help="step to corrupt (default: newest committed)")
    cor.add_argument("--mode", default="flip-byte",
                     choices=sorted(faults.CORRUPTERS))
    cor.set_defaults(fn=cmd_corrupt)

    val = sub.add_parser("validate",
                         help="integrity-check every committed step")
    val.add_argument("dir", help="Checkpointer directory")
    val.set_defaults(fn=cmd_validate)

    args = ap.parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    raise SystemExit(main())
