"""``python -m repro_torch.serve DIR`` -- run the sweep-farm server.

Also reachable as ``python -m repro_torch serve DIR`` (the unified CLI).
Runs on the CUDA card unless ``--device`` names another device (``cpu``:
the kernels' plain PyTorch versions); with no card and no ``--device``
it raises.  Exit codes follow the ``--supervise`` convention: 0 =
drained with nothing outstanding, 3 = drained-preempted (checkpointed
work remains; rerun the same command to resume it).
"""
from __future__ import annotations

import argparse
import sys


def add_serve_args(ap: argparse.ArgumentParser) -> None:
    """The serve flag set (shared with ``python -m repro serve``)."""
    ap.add_argument("dir", metavar="DIR",
                    help="farm directory: journal, results, batch "
                         "checkpoints, endpoint file")
    ap.add_argument("--port", type=int, default=0,
                    help="HTTP port (0: ephemeral; the bound port is "
                         "written to DIR/serve.json)")
    ap.add_argument("--max-queue", type=int, default=64,
                    help="bounded queue depth: outstanding (non-"
                         "terminal) jobs beyond this are rejected "
                         "with HTTP 429 backpressure")
    ap.add_argument("--max-batch", type=int, default=8,
                    help="most compatible specs fused into one "
                         "ensemble dispatch")
    ap.add_argument("--chunk", type=int, default=64,
                    help="supervisor sweep-chunk per batch: drain "
                         "latency and deadline granularity")
    ap.add_argument("--ckpt-every-sweeps", type=int, default=0,
                    help="checkpoint cadence inside a batch (0: only "
                         "the preemption/final checkpoint)")
    ap.add_argument("--keep", type=int, default=3,
                    help="checkpoint steps kept per batch")
    ap.add_argument("--poll", type=float, default=0.25,
                    help="idle loop poll interval (seconds)")
    ap.add_argument("--drain-on-idle", action="store_true",
                    help="exit 0 once every accepted job is terminal "
                         "(batch/CI mode) instead of serving forever")
    ap.add_argument("--device", default="",
                    help="torch device of every batch, e.g. cpu "
                         "(default: the CUDA card)")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.serve",
        description="fault-tolerant sweep-farm server "
                    "(exit 0 done / 3 drained-preempted)")
    add_serve_args(ap)
    args = ap.parse_args(argv)
    return run_server(args)


def run_server(args) -> int:
    from repro_torch.resilience import faults

    from .server import serve
    faults.install_from_env()  # chaos drills: REPRO_FAULTS JSON plan
    return serve(args.dir, port=args.port, poll=args.poll,
                 drain_on_idle=args.drain_on_idle,
                 max_queue=args.max_queue, max_batch=args.max_batch,
                 chunk=args.chunk,
                 ckpt_every_sweeps=args.ckpt_every_sweeps,
                 keep=args.keep, device=args.device or None)


if __name__ == "__main__":
    sys.exit(main())
