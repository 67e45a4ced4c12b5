"""Serve smoke drill: submit, SIGKILL, restart, verify.

Counterpart of ``repro.serve.smoke``, on the CUDA card by default or on
the CPU with ``--device cpu``:

    python -m repro_torch.serve.smoke --workdir /tmp/serve_smoke

Two phases, each against a real ``python -m repro_torch serve``
subprocess (``--device`` passed to each; every server after the first
loads the kernels the first one built, ``src/repro_torch/_build/``):

1. **crash safety** -- submit N mixed jobs (coalescible multispin
   specs + odd-shaped ones) through the HTTP client, SIGKILL the
   server once a batch has started and committed its first checkpoint
   (or a job is done, whichever comes first), restart it with
   ``--drain-on-idle``, and assert: at least one acked job had no
   ``done`` record at the kill (else the drill proved nothing and
   raises), every acked job completes, each has EXACTLY one ``done``
   record (the journal's ``job_table`` raises on duplicates), and every
   digest is bit-identical to a direct in-process ``Session`` run of
   the same spec;

2. **coalescing** -- on a fresh directory, queue k compatible specs
   behind a blocker job and assert from the journal that all k ran as
   ONE batch and from ``metrics.json`` that the whole phase cost one
   dispatch per batch (``chunk >= sweeps``).

SIGKILL -- not SIGTERM -- is the point: no handler runs, nothing
flushes, and the journal's fsync-before-ack contract is the only thing
standing between the farm and lost work.  :func:`crash_drill` and
:func:`coalesce_drill` take their specs, so that a caller may drill at
other sizes; they return what they measured.
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

from repro_torch.api import EngineSpec, LatticeSpec, RunSpec

from .journal import JOURNAL_NAME, _parse_line, job_table

#: the directory that holds this package, put first on the servers'
#: PYTHONPATH so that they run the package this drill belongs to
SRC = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def _specs(args):
    """N mixed submissions: ``args.k`` coalescible multispin jobs plus
    two odd ones (different engine / lattice), all counter-based so
    digests are chunk-grid-invariant."""
    out = []
    for i in range(args.k):
        out.append(RunSpec(
            lattice=LatticeSpec(n=args.n, m=args.n),
            engine=EngineSpec("multispin"),
            temperature=2.0 + 0.1 * i, seed=20 + i))
    out.append(RunSpec(lattice=LatticeSpec(n=2 * args.n, m=2 * args.n),
                       engine=EngineSpec("bitplane"),
                       temperature=2.3, seed=91))
    out.append(RunSpec(lattice=LatticeSpec(n=args.n, m=args.n),
                       engine=EngineSpec("basic_philox"),
                       temperature=1.8, seed=92))
    return out


def reference_digests(specs, sweeps: int, device=None) -> list:
    """The digest of a direct ``Session`` run of each spec."""
    from repro_torch.api import Session
    refs = []
    for spec in specs:
        s = Session.open(spec, device)
        s.run(sweeps)
        refs.append(s.state_digest())
    return refs


def _server_cmd(workdir, *, chunk, max_batch, every, device,
                drain_on_idle):
    cmd = [sys.executable, "-m", "repro_torch", "serve", workdir,
           "--chunk", str(chunk), "--max-batch", str(max_batch),
           "--ckpt-every-sweeps", str(every), "--poll", "0.05"]
    if device:
        cmd += ["--device", device]
    if drain_on_idle:
        cmd.append("--drain-on-idle")
    return cmd


def _env() -> dict:
    env = dict(os.environ)
    env.pop("REPRO_FAULTS", None)  # the drill injects nothing
    env["PYTHONPATH"] = os.pathsep.join(
        [SRC] + [p for p in env.get("PYTHONPATH", "").split(os.pathsep)
                 if p])
    return env


def start_server(cmd, workdir: str, timeout: float):
    """Start a server; returns ``(process, seconds until it wrote its
    endpoint file)``: its start-up, the card's context included."""
    t0 = time.perf_counter()
    proc = subprocess.Popen(cmd, env=_env(), text=True,
                            stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT)
    ep = os.path.join(workdir, "serve.json")
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if os.path.exists(ep):
            # the endpoint file must name THIS process (a restart
            # overwrites the previous server's file)
            with open(ep) as f:
                if json.load(f).get("pid") == proc.pid:
                    return proc, time.perf_counter() - t0
        if proc.poll() is not None:
            out, _ = proc.communicate()
            raise SystemExit(f"server died during startup "
                             f"(exit {proc.returncode}):\n{out}")
        time.sleep(0.05)
    proc.kill()
    proc.communicate()
    raise SystemExit("server did not write serve.json in time")


def journal_records(workdir: str) -> list:
    """The whole records of a farm's journal, read without recovery: a
    live server may be appending, and a reader must not truncate its
    tail."""
    path = os.path.join(workdir, JOURNAL_NAME)
    if not os.path.exists(path):
        return []
    with open(path, "rb") as f:
        data = f.read()
    out = []
    for line in data.splitlines(keepends=True):
        record = _parse_line(line)
        if record is None:
            break
        out.append(record)
    return out


def _committed_steps(workdir: str, batch: str = "*") -> list:
    return glob.glob(os.path.join(workdir, "batches", batch, "step_*",
                                  "DONE"))


def crash_drill(workdir: str, specs, refs, sweeps: int, *, chunk: int,
                every: int, max_batch: int = 8, device: str = "",
                min_jobs: int = 1, timeout: float = 600.0) -> dict:
    """Submit ``specs`` with ``sweeps`` each, SIGKILL the server once a
    batch of at least ``min_jobs`` jobs has started and committed a
    checkpoint (or a job of such a batch is done), restart it with
    ``--drain-on-idle`` and hold every job to its direct digest in
    ``refs``.  Raises ``SystemExit`` on any failure; returns the job
    ids, the jobs outstanding at the kill, the start-up seconds, the
    restarted server's output and ``metrics.json`` counters, and the
    journal."""
    shutil.rmtree(workdir, ignore_errors=True)
    os.makedirs(workdir, exist_ok=True)
    kw = dict(chunk=chunk, max_batch=max_batch, every=every, device=device)
    proc, start_s = start_server(
        _server_cmd(workdir, drain_on_idle=False, **kw), workdir, timeout)
    from .client import ServeClient
    client = ServeClient(workdir)
    jids = [client.submit({"spec": s.to_dict(), "sweeps": sweeps})
            for s in specs]
    print(f"# submitted {jids}", flush=True)

    # SIGKILL once such a batch has a committed checkpoint, so that the
    # restart resumes it (or once one of its jobs is done, which then
    # ends the wait): no handler, no flush
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline and proc.poll() is None:
        records = journal_records(workdir)
        done = {r["job"] for r in records if r.get("kind") == "done"}
        batches = [r for r in records if r.get("kind") == "start"
                   and len(r["jobs"]) >= min_jobs]
        if any(done & set(b["jobs"]) or not every
               or _committed_steps(workdir, b["batch"]) for b in batches):
            break
        time.sleep(0.02)
    proc.send_signal(signal.SIGKILL)
    out, _ = proc.communicate(timeout=timeout)
    if proc.returncode != -signal.SIGKILL:
        raise SystemExit(f"the server exited {proc.returncode} before "
                         f"the kill:\n{out}")
    _, dones = job_table(journal_records(workdir))
    outstanding = [j for j in jids if j not in dones]
    print(f"# SIGKILLed server pid {proc.pid}; committed checkpoints "
          f"{len(_committed_steps(workdir))}; acked jobs without a done "
          f"record: {outstanding}", flush=True)
    if not outstanding:
        raise SystemExit("every job was done before the kill landed: the "
                         "drill proved nothing (raise the sweeps)")

    print("# restarting with --drain-on-idle", flush=True)
    proc, restart_s = start_server(
        _server_cmd(workdir, drain_on_idle=True, **kw), workdir, timeout)
    out, _ = proc.communicate(timeout=timeout)
    print(out, end="", flush=True)
    if proc.returncode != 0:
        raise SystemExit(f"restarted server exited "
                         f"{proc.returncode}, want 0 (drained idle)")

    records = journal_records(workdir)
    _, dones = job_table(records)  # raises on duplicate done
    missing = [j for j in jids if j not in dones]
    if missing:
        raise SystemExit(f"jobs lost across the kill: {missing}")
    for jid, spec, want in zip(jids, specs, refs):
        done = dones[jid]
        if done["status"] != "completed":
            raise SystemExit(f"{jid} finished {done['status']}: "
                             f"{done.get('error')}")
        if done["digest"] != want:
            raise SystemExit(
                f"{jid} ({spec.engine.name}): digest "
                f"{done['digest']} != direct-Session reference "
                f"{want}")
    with open(os.path.join(workdir, "metrics.json")) as f:
        counters = json.load(f)["counters"]
    print(f"# crash drill OK: {len(jids)} jobs exactly-once, every "
          f"digest bit-identical to a direct run", flush=True)
    return {"jobs": jids, "outstanding": outstanding,
            "startup_s": [start_s, restart_s], "output": out,
            "counters": counters, "records": records}


def coalesce_drill(workdir: str, blocker, specs, sweeps: int, *,
                   max_batch: int = 8, device: str = "",
                   timeout: float = 600.0) -> dict:
    """Queue ``specs`` (coalescible) behind ``blocker`` on a server with
    ``chunk >= sweeps``; assert that they ran as one batch and that
    ``dispatches`` in ``metrics.json`` is the number of batches.  Raises
    ``SystemExit`` on failure; returns the start-up seconds, the
    counters and the start records."""
    shutil.rmtree(workdir, ignore_errors=True)
    os.makedirs(workdir, exist_ok=True)
    proc, start_s = start_server(
        _server_cmd(workdir, chunk=sweeps, max_batch=max_batch, every=0,
                    device=device, drain_on_idle=True), workdir, timeout)
    from .client import ServeClient
    client = ServeClient(workdir)
    client.submit({"spec": blocker.to_dict(), "sweeps": sweeps})
    jids = [client.submit({"spec": s.to_dict(), "sweeps": sweeps})
            for s in specs]
    out, _ = proc.communicate(timeout=timeout)
    print(out, end="", flush=True)
    if proc.returncode != 0:
        raise SystemExit(f"coalesce server exited {proc.returncode}")

    starts = [r for r in journal_records(workdir)
              if r.get("kind") == "start"]
    fused = [s for s in starts if set(jids) <= set(s["jobs"])]
    if not fused:
        grouping = [s["jobs"] for s in starts]
        raise SystemExit(
            f"jobs {jids} did not coalesce into one batch; start "
            f"records grouped them as {grouping}")
    with open(os.path.join(workdir, "metrics.json")) as f:
        counters = json.load(f)["counters"]
    dispatches = counters.get("dispatches", 0)
    want = len(starts)  # one dispatch per batch
    if dispatches != want:
        raise SystemExit(
            f"dispatches={dispatches}, want {want} (one per batch "
            f"at chunk >= sweeps); batches: "
            f"{[s['batch'] for s in starts]}")
    print(f"# coalescing OK: {len(specs)} specs + 1 blocker ran as "
          f"{len(starts)} batches / {dispatches} dispatches", flush=True)
    return {"startup_s": start_s, "counters": counters, "starts": starts}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.serve.smoke",
        description="sweep-farm crash + coalescing drill")
    ap.add_argument("--workdir", default="results/serve_smoke")
    ap.add_argument("--n", type=int, default=16,
                    help="coalescible-job lattice size")
    ap.add_argument("--k", type=int, default=4,
                    help="coalescible multispin jobs")
    ap.add_argument("--sweeps", type=int, default=192)
    ap.add_argument("--chunk", type=int, default=32)
    ap.add_argument("--max-batch", type=int, default=8)
    ap.add_argument("--timeout", type=float, default=600.0,
                    help="per-wait wall-clock budget (s)")
    ap.add_argument("--device", default="",
                    help="torch device of the servers and the reference "
                         "runs, e.g. cpu (default: the CUDA card)")
    args = ap.parse_args(argv)
    specs = _specs(args)
    print(f"# [1/2] crash drill: {len(specs)} jobs, computing "
          f"reference digests in-process", flush=True)
    refs = reference_digests(specs, args.sweeps, args.device or None)
    crash_drill(os.path.join(args.workdir, "crash"), specs, refs,
                args.sweeps, chunk=args.chunk, every=args.chunk,
                max_batch=args.max_batch, device=args.device,
                timeout=args.timeout)
    print(f"# [2/2] coalescing drill: {args.k} compatible specs "
          f"behind a blocker", flush=True)
    blocker = RunSpec(lattice=LatticeSpec(n=2 * args.n, m=2 * args.n),
                      engine=EngineSpec("multispin"),
                      temperature=2.5, seed=7)
    coalesce_drill(os.path.join(args.workdir, "coalesce"), blocker,
                   specs[:args.k], args.sweeps, max_batch=args.max_batch,
                   device=args.device, timeout=args.timeout)
    print("serve smoke OK: crash safety + coalescing verified")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
