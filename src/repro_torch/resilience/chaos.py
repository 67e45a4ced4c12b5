"""Chaos drill: kill, corrupt, resume, compare digests.

Counterpart of ``repro.resilience.chaos``: the end-to-end
fault-tolerance drill, on the CUDA card by default or on the CPU with
``--device cpu``:

    python -m repro_torch.resilience.chaos --workdir /tmp/chaos

Four acts, all through the real ``python -m repro_torch run
--supervise`` CLI in subprocesses, one after another (each loads the
kernels the first one built, ``src/repro_torch/_build/``):

1. an uninterrupted **reference** run; its ``final_state_digest=``
   line is the ground truth;
2. a **chaos** run SIGTERM-killed as soon as its first checkpoint
   commits (the preemption path);
3. the newest committed checkpoint is **corrupted** with
   ``python -m repro_torch.resilience corrupt`` (flip-byte), so the
   resume must skip it and fall back;
4. the run is **resumed** under an injected transient dispatch fault
   (``REPRO_FAULTS``), exercising the retry path, and must finish with
   a digest bit-identical to the reference.

Exit 0 iff the recovered digest matches.  The kill deliberately races
a fast run: when the run completes before the signal lands (or the
signal lands before the CLI installs its handler), the drill still
corrupts + resumes -- the digest contract is the same either way.

``--temps`` (comma list) runs the same four acts in ensemble mode: the
batch's checkpoints carry batched state arrays, and the resume must
restore every member bit-exactly.

``--mesh RxC`` runs acts 2-4 SHARDED while the reference stays
single-device: the final digest equality then also proves the sharded
tier's stream invariance.  ``--resume-mesh RxC`` additionally resumes
act 4 on a DIFFERENT mesh than the one the killed run checkpointed
under -- the cross-mesh checkpoint-portability drill (the supervisor
accepts a mesh-only spec difference).  A mesh needs no more devices than
there are: its shards share them.  ``--device`` is passed to every run.
"""
from __future__ import annotations

import argparse
import glob
import json
import os
import shutil
import signal
import subprocess
import sys
import time

#: the directory that holds this package, put first on the subprocesses'
#: PYTHONPATH so that they run the package this drill belongs to
SRC = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def _cli(args, ckpt_dir: str, mesh: str = "") -> list:
    cmd = [sys.executable, "-m", "repro_torch", "run",
           "--n", str(args.n), "--engine", args.engine,
           "--temperature", str(args.temperature),
           "--seed", str(args.seed),
           "--supervise", ckpt_dir, "--sweeps", str(args.sweeps),
           "--ckpt-every-sweeps", str(args.every),
           "--chunk", str(args.chunk), "--keep", "4"]
    if mesh:
        cmd += ["--mesh", mesh]
    if args.device:
        cmd += ["--device", args.device]
    if args.temps:
        # ensemble mode: the drill then covers the batched supervised
        # path (batched checkpoint arrays, batched resume)
        cmd += ["--temps", args.temps]
        if args.seeds:
            cmd += ["--seeds", args.seeds]
    return cmd


def _digest(out: str) -> str:
    for line in out.splitlines():
        if line.startswith("final_state_digest="):
            return line.split("=", 1)[1].strip()
    raise SystemExit(f"no final_state_digest line in output:\n{out}")


def _committed_steps(ckpt_dir: str) -> list:
    return glob.glob(os.path.join(ckpt_dir, "step_*", "DONE"))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.resilience.chaos",
        description="supervised-run chaos drill (kill/corrupt/resume)")
    ap.add_argument("--workdir", default="results/chaos")
    ap.add_argument("--n", type=int, default=64)
    ap.add_argument("--engine", default="multispin")
    ap.add_argument("--temperature", type=float, default=2.27)
    ap.add_argument("--seed", type=int, default=11)
    ap.add_argument("--temps", default="",
                    help="comma list of member temperatures: run the "
                         "drill in ensemble mode (the batched "
                         "supervised path) instead of single-lattice")
    ap.add_argument("--seeds", default="",
                    help="comma list of ensemble member seeds "
                         "(with --temps; default 0..B-1)")
    ap.add_argument("--mesh", default="",
                    help="mesh shape (e.g. 2x2): run the chaos acts "
                         "SHARDED; the reference stays single-device, "
                         "so the digest match also proves sharded "
                         "stream invariance")
    ap.add_argument("--resume-mesh", default="",
                    help="mesh shape for the act-4 resume only (with "
                         "--mesh): the cross-mesh checkpoint-"
                         "portability drill")
    ap.add_argument("--sweeps", type=int, default=2048)
    ap.add_argument("--chunk", type=int, default=8)
    ap.add_argument("--every", type=int, default=64,
                    help="checkpoint cadence in sweeps")
    ap.add_argument("--timeout", type=float, default=600.0,
                    help="per-subprocess wall-clock budget (s)")
    ap.add_argument("--device", default="",
                    help="torch device of every run, e.g. cpu (default: "
                         "the CUDA card)")
    args = ap.parse_args(argv)

    env = dict(os.environ)
    env.pop("REPRO_FAULTS", None)  # the reference must run clean
    env["PYTHONPATH"] = os.pathsep.join(
        [SRC] + [p for p in env.get("PYTHONPATH", "").split(os.pathsep)
                 if p])
    ref_dir = os.path.join(args.workdir, "ref")
    chaos_dir = os.path.join(args.workdir, "chaos")
    for d in (ref_dir, chaos_dir):
        shutil.rmtree(d, ignore_errors=True)
    os.makedirs(args.workdir, exist_ok=True)

    print("# [1/4] reference run (uninterrupted)", flush=True)
    ref = subprocess.run(_cli(args, ref_dir), env=env, text=True,
                         capture_output=True, timeout=args.timeout)
    print(ref.stdout, end="", flush=True)
    if ref.returncode != 0:
        print(ref.stderr, file=sys.stderr)
        return 1
    want = _digest(ref.stdout)

    print("# [2/4] chaos run: SIGTERM after the first committed step",
          flush=True)
    proc = subprocess.Popen(_cli(args, chaos_dir, mesh=args.mesh),
                            env=env, text=True,
                            stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT)
    deadline = time.monotonic() + args.timeout
    while (proc.poll() is None and time.monotonic() < deadline
           and not _committed_steps(chaos_dir)):
        time.sleep(0.01)
    if proc.poll() is None:
        proc.send_signal(signal.SIGTERM)
    out, _ = proc.communicate(timeout=args.timeout)
    print(out, end="", flush=True)
    # 3 = preempted-and-checkpointed (the intended path); 0 = the run
    # finished before the signal landed; -SIGTERM = the signal landed
    # in the startup window before the CLI installed its handler --
    # every one of them leaves a directory the drill can continue from
    if proc.returncode not in (0, 3, -signal.SIGTERM):
        print(f"unexpected chaos-run exit {proc.returncode}",
              file=sys.stderr)
        return 1
    print(f"# chaos run exit {proc.returncode}", flush=True)

    print("# [3/4] corrupting newest committed checkpoint (flip-byte)",
          flush=True)
    if _committed_steps(chaos_dir):
        subprocess.run([sys.executable, "-m", "repro_torch.resilience",
                        "corrupt", chaos_dir], env=env, check=True,
                       timeout=args.timeout)
    else:
        print("# no committed checkpoint survived the kill -- the "
              "resume below is a fresh (still bit-exact) run")

    print("# [4/4] resume under an injected transient dispatch fault",
          flush=True)
    env["REPRO_FAULTS"] = json.dumps({"transient_dispatches": 1})
    res = subprocess.run(_cli(args, chaos_dir,
                              mesh=args.resume_mesh or args.mesh),
                         env=env, text=True,
                         capture_output=True, timeout=args.timeout)
    print(res.stdout, end="", flush=True)
    if res.returncode != 0:
        print(res.stderr, file=sys.stderr)
        return 1
    got = _digest(res.stdout)
    if got != want:
        print(f"FAIL: recovered digest {got} != reference {want}",
              file=sys.stderr)
        return 1
    print(f"chaos drill OK: digest {got} bit-identical after "
          f"kill + corruption + injected fault")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
