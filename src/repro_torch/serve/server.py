"""The sweep farm: exactly-once job execution over a durable journal.

Counterpart of ``repro.serve.server``: a farm directory (journal, result
files, batch checkpoints) written by either package is resumed by the
other.  ``SweepFarm`` is the whole service in one in-process object (the
HTTP front-end below is a thin threaded shell around it; tests drive the
farm directly).  The contract:

* **exactly-once** -- a submission is journaled (fsync'd) BEFORE it is
  acked; a completion is journaled BEFORE the job is reported
  terminal.  Killing the process at any point -- SIGKILL included --
  loses nothing: construction replays the journal, re-queues every
  acked-but-unfinished job, and never re-runs a job with a ``done``
  record.  Results are bit-reproducible (counter-based engines), so
  re-running an interrupted job from its supervised checkpoint -- or
  from scratch -- yields the identical digest;

* **coalescing** -- compatible queued jobs fuse into one ensemble
  dispatch (``repro_torch.serve.scheduler``): every block of sweeps is
  one launch of the family's member-axis kernel for all the batch's
  jobs.  A runner pool keyed by dispatch shape
  (``_EnsembleRunner.rebind``) keeps a finished batch's runner for the
  next batch of that shape.  There is no compilation to save here (a
  process builds or loads each kernel library once): the pool keeps the
  engine with its k-sweep tile plan, and the member planes, which a
  rebind refills in place instead of allocating (the kernels' member
  records are built at each launch either way).  The ``dispatches``
  counter counts one dispatch a batch at ``chunk >= sweeps``;
  ``serve.cache_hit`` and ``serve.cache_miss`` count the pool;

* **robustness** -- admission is typed (never a crash), the queue is
  bounded (backpressure), per-job timeouts fail work instead of
  wedging it, dispatch faults ride the ``resilience.degrade`` retry
  path (which never retries a dispatch whose per-half-sweep launches
  have written its state), and SIGTERM drains gracefully: stop
  admitting, checkpoint the in-flight batch at the next chunk boundary,
  exit 3 (the ``--supervise`` preemption convention).

**The card.**  The farm runs on ``device`` (``None``: the CUDA card, and
construction raises where there is none; a mesh job then spreads its
shards over every card), and every session and supervisor it opens runs
there: nothing falls back to the CPU.  A batch that raises -- a launch
error included -- becomes its jobs' ``failed`` result, as in the JAX
package.  Every CUDA call runs on the thread of :meth:`serve_forever`
(or :meth:`run_until_idle`); the HTTP handler threads only parse,
journal (an fsync) and read the job table.
"""
from __future__ import annotations

import json
import os
import shutil
import threading
import time
from typing import Dict, List, Optional

import repro_torch.telemetry as tel
from repro_torch.resilience.errors import SupervisorError

from .errors import (AdmissionError, DrainingError, JournalError,
                     QueueFullError)
from .journal import JOURNAL_NAME, Journal, job_table
from .scheduler import Batch, Job, parse_envelope, plan_batches

#: module-held references survive REGISTRY.reset()
SUBMITTED = tel.REGISTRY.counter("serve.submitted")
REJECTED = tel.REGISTRY.counter("serve.rejected")
COMPLETED = tel.REGISTRY.counter("serve.completed")
FAILED = tel.REGISTRY.counter("serve.failed")
BATCHES = tel.REGISTRY.counter("serve.batches")
COALESCED = tel.REGISTRY.counter("serve.coalesced")
CACHE_HITS = tel.REGISTRY.counter("serve.cache_hit")
CACHE_MISSES = tel.REGISTRY.counter("serve.cache_miss")

#: default supervisor chunk for farm batches (sweeps between control
#: points: drain latency and deadline granularity)
DEFAULT_CHUNK = 64


class SweepFarm:
    """See the module docstring; construction RECOVERS the directory."""

    def __init__(self, directory: str, *, max_queue: int = 64,
                 max_batch: int = 8, chunk: int = DEFAULT_CHUNK,
                 ckpt_every_sweeps: int = 0, keep: int = 3, device=None):
        from repro_torch.api.session import resolve_device
        resolve_device(device)  # no card and no device named: raise now
        self.device = device
        self.dir = directory
        self.max_queue = max_queue
        self.max_batch = max_batch
        self.chunk = chunk
        self.ckpt_every_sweeps = ckpt_every_sweeps
        self.keep = keep
        self.results_dir = os.path.join(directory, "results")
        self.batches_dir = os.path.join(directory, "batches")
        os.makedirs(self.results_dir, exist_ok=True)
        os.makedirs(self.batches_dir, exist_ok=True)
        # re-entrant: the executor thread journals while holding the
        # lock from nested paths (step -> _fail_expired -> _finish)
        self._lock = threading.RLock()
        self._work = threading.Condition(self._lock)
        self._draining = threading.Event()
        self._current: Optional[Batch] = None
        self._expired_stop = False
        self._runner_pool: dict = {}
        self.journal = Journal(os.path.join(directory, JOURNAL_NAME))
        self.jobs: Dict[str, Job] = {}
        self._next_seq = 1
        self._recover()

    # -- recovery ------------------------------------------------------------
    def _recover(self) -> None:
        submits, dones = job_table(self.journal.records)
        for jid, r in submits.items():
            spec, sweeps, timeout_s = parse_envelope(
                {"spec": r["spec"], "sweeps": r["sweeps"],
                 "timeout_s": r.get("timeout_s")})
            job = Job(id=jid, spec=spec, sweeps=sweeps,
                      timeout_s=timeout_s, submitted_t=r["t"])
            done = dones.get(jid)
            if done is not None:
                job.status = done["status"]
                job.digest = done.get("digest")
                job.error = done.get("error")
                job.summary = done.get("summary", {})
                self._write_result(job)  # regenerable from the journal
            self.jobs[jid] = job
            self._next_seq = max(self._next_seq,
                                 int(jid.lstrip("j")) + 1)
        if submits:
            tel.instant("serve.recover", dir=self.dir,
                        jobs=len(submits), done=len(dones),
                        requeued=len(submits) - len(dones))
        self._gc_batch_dirs()

    def _gc_batch_dirs(self) -> None:
        """Drop batch workdirs no replanned batch will ever resume
        (their jobs all reached ``done`` before the crash); the live
        ones keep their checkpoints for the resume path."""
        queued = [j for j in self.jobs.values() if j.status == "queued"]
        live = {b.id for b in plan_batches(queued, self.max_batch)}
        try:
            stale = [d for d in os.listdir(self.batches_dir)
                     if d not in live]
        except FileNotFoundError:
            return
        for d in stale:
            shutil.rmtree(os.path.join(self.batches_dir, d),
                          ignore_errors=True)

    # -- admission -----------------------------------------------------------
    def submit(self, doc) -> str:
        """Admit one submission document; returns the job id.  The
        submit record is fsync'd before this returns -- an acked job
        survives any crash.  Raises :class:`AdmissionError` /
        :class:`QueueFullError` / :class:`DrainingError`."""
        try:
            spec, sweeps, timeout_s = parse_envelope(doc)
        except AdmissionError:
            REJECTED.inc()
            raise
        with self._work:
            if self._draining.is_set():
                REJECTED.inc()
                raise DrainingError(
                    "server is draining; not admitting new work")
            depth = sum(1 for j in self.jobs.values()
                        if not j.terminal)
            if depth >= self.max_queue:
                REJECTED.inc()
                raise QueueFullError(
                    f"queue at capacity ({depth}/{self.max_queue} "
                    f"jobs outstanding); retry later")
            jid = f"j{self._next_seq:06d}"
            self._next_seq += 1
            now = time.time()
            self.journal.append({"kind": "submit", "job": jid,
                                 "spec": spec.to_dict(),
                                 "sweeps": sweeps,
                                 "timeout_s": timeout_s, "t": now})
            self.jobs[jid] = Job(id=jid, spec=spec, sweeps=sweeps,
                                 timeout_s=timeout_s, submitted_t=now)
            SUBMITTED.inc()
            self._work.notify_all()
            return jid

    # -- introspection -------------------------------------------------------
    def job(self, jid: str) -> Optional[dict]:
        with self._lock:
            job = self.jobs.get(jid)
            return None if job is None else job.to_dict()

    def status(self) -> dict:
        with self._lock:
            by = {"queued": 0, "running": 0, "completed": 0,
                  "failed": 0}
            for j in self.jobs.values():
                by[j.status] += 1
            return {"jobs": by, "draining": self._draining.is_set(),
                    "max_queue": self.max_queue,
                    "max_batch": self.max_batch,
                    "runner_pool": len(self._runner_pool)}

    @property
    def idle(self) -> bool:
        """Every ACCEPTED job is terminal -- vacuously false with no
        jobs at all, so a ``--drain-on-idle`` server waits for its
        first submission instead of exiting at startup."""
        with self._lock:
            return bool(self.jobs) and all(j.terminal
                                           for j in self.jobs.values())

    # -- drain ---------------------------------------------------------------
    def request_drain(self) -> None:
        """Stop admitting; ask the in-flight batch to checkpoint and
        stop at its next chunk boundary.  Signal-handler safe."""
        self._draining.set()
        tel.instant("serve.drain", dir=self.dir)
        with self._work:
            self._work.notify_all()

    @property
    def draining(self) -> bool:
        return self._draining.is_set()

    # -- execution -----------------------------------------------------------
    def _queued(self) -> List[Job]:
        return [j for j in self.jobs.values() if j.status == "queued"]

    def _fail_expired(self) -> None:
        now = time.time()
        for j in self._queued():
            if j.expired(now):
                self._finish(j, "failed",
                             error=f"deadline exceeded: timeout_s="
                                   f"{j.timeout_s} elapsed before "
                                   f"dispatch")

    def _finish(self, job: Job, status: str, digest: str = None,
                summary: dict = None, error: str = None) -> None:
        """The ONLY path to a terminal state: journal the done record
        (fsync'd), then publish.  Guards exactly-once."""
        with self._lock:
            if job.terminal:
                raise JournalError(
                    f"job {job.id} is already {job.status}; refusing "
                    f"a second done record (exactly-once)")
            self.journal.append({"kind": "done", "job": job.id,
                                 "status": status, "digest": digest,
                                 "summary": summary or {},
                                 "error": error, "t": time.time()})
            job.status = status
            job.digest = digest
            job.summary = summary or {}
            job.error = error
            self._write_result(job)
        (COMPLETED if status == "completed" else FAILED).inc()

    def _write_result(self, job: Job) -> None:
        path = os.path.join(self.results_dir, f"{job.id}.json")
        if os.path.exists(path):
            return
        tmp = path + ".tmp"
        with open(tmp, "w") as f:
            json.dump(job.to_dict(), f, indent=1, sort_keys=True)
            f.write("\n")
        os.replace(tmp, path)

    def _on_chunk(self, sup) -> None:
        if self._draining.is_set():
            sup.request_stop()
            return
        batch = self._current
        if batch is not None and batch.jobs and \
                all(j.expired(time.time()) for j in batch.jobs):
            self._expired_stop = True
            sup.request_stop()

    def _open_supervisor(self, batch: Batch, workdir: str):
        from repro_torch.api.session import Session
        spec = batch.spec()
        session = None
        hit = False
        if batch.coalesced:
            from repro_torch.ckpt import Checkpointer
            fresh = Checkpointer(workdir, keep=self.keep) \
                .latest_step() is None
            if fresh:
                runner = self._runner_pool.pop(batch.runner_key(),
                                               None)
                if runner is not None:
                    runner.rebind(spec)
                    session = Session(spec, runner)
                    hit = True
            (CACHE_HITS if hit else CACHE_MISSES).inc()
        try:
            return _make_supervisor(
                spec, workdir, every_sweeps=self.ckpt_every_sweeps,
                chunk=self.chunk, keep=self.keep,
                install_signal_handlers=False,
                on_chunk=self._on_chunk, session=session,
                device=self.device)
        except SupervisorError:
            # a checkpoint from a DIFFERENT grouping (e.g. the farm's
            # max_batch changed across the restart): the work is lost,
            # correctness is not -- wipe and run fresh
            shutil.rmtree(workdir, ignore_errors=True)
            return _make_supervisor(
                spec, workdir, every_sweeps=self.ckpt_every_sweeps,
                chunk=self.chunk, keep=self.keep,
                install_signal_handlers=False,
                on_chunk=self._on_chunk, session=session,
                device=self.device)

    def _run_batch(self, batch: Batch) -> str:
        """Execute one batch; returns ``"completed"``, ``"preempted"``
        (drain: jobs stay queued for the restart), or ``"failed"``."""
        workdir = os.path.join(self.batches_dir, batch.id)
        jids = [j.id for j in batch.jobs]
        with self._lock:
            self.journal.append({"kind": "start", "batch": batch.id,
                                 "jobs": jids,
                                 "key": list(batch.key) if batch.key
                                 else None, "t": time.time()})
            for j in batch.jobs:
                j.status = "running"
        self._current = batch
        self._expired_stop = False
        BATCHES.inc()
        if batch.coalesced and len(batch.jobs) > 1:
            COALESCED.inc(len(batch.jobs))
        try:
            with tel.span("serve.batch", batch=batch.id, jobs=jids,
                          coalesced=batch.coalesced,
                          sweeps=batch.sweeps):
                sup = self._open_supervisor(batch, workdir)
                res = sup.run(batch.sweeps)
                session = sup.session
        except Exception as e:  # noqa: BLE001 -- a job must never
            # take the server down; the failure is the job's result
            for j in batch.jobs:
                self._finish(j, "failed",
                             error=f"{type(e).__name__}: {e}")
            shutil.rmtree(workdir, ignore_errors=True)
            return "failed"
        finally:
            self._current = None
        if res.status == "preempted":
            if self._expired_stop:
                for j in batch.jobs:
                    self._finish(j, "failed",
                                 error=f"deadline exceeded at sweep "
                                       f"{res.step_count}/"
                                       f"{batch.sweeps}")
                shutil.rmtree(workdir, ignore_errors=True)
                return "failed"
            with self._lock:  # drain: progress is checkpointed
                for j in batch.jobs:
                    j.status = "queued"
            return "preempted"
        import numpy as np
        mags = np.atleast_1d(np.asarray(session.magnetization()))
        for i, job in enumerate(batch.jobs):
            if batch.coalesced:
                digest = session.state_digest(member=i)
                abs_m = float(abs(mags[i]))
            else:
                digest = session.state_digest()
                abs_m = float(np.mean(np.abs(mags)))
            self._finish(job, "completed", digest=digest,
                         summary={"abs_m": abs_m,
                                  "step_count": res.step_count,
                                  "batch": batch.id,
                                  "coalesced": len(batch.jobs)})
        if batch.coalesced:
            self._runner_pool[batch.runner_key()] = session._runner
        shutil.rmtree(workdir, ignore_errors=True)
        return "completed"

    def step(self) -> bool:
        """Fail expired queued jobs, then run the next planned batch
        (if any); returns whether any work was done."""
        with self._lock:
            self._fail_expired()
            batches = plan_batches(self._queued(), self.max_batch)
        if not batches or self._draining.is_set():
            return False
        self._run_batch(batches[0])
        return True

    def run_until_idle(self) -> int:
        """Drive the queue to empty (the in-process entry point);
        returns the number of batches run."""
        n = 0
        while not self._draining.is_set():
            if not self.step():
                break
            n += 1
        return n

    def serve_forever(self, poll: float = 0.25,
                      drain_on_idle: bool = False) -> int:
        """The executor loop (run on the MAIN thread so the supervisor
        chunk boundaries see drain requests promptly).  Returns the
        process exit code: 0 = drained with nothing outstanding,
        3 = drained with checkpointed work left (rerun to resume)."""
        while True:
            worked = self.step()
            if self._draining.is_set():
                break
            if worked:
                continue
            if drain_on_idle and self.idle:
                return 0
            with self._work:
                if not self._queued() and not self._draining.is_set():
                    self._work.wait(timeout=poll)
        return 3 if any(not j.terminal
                        for j in self.jobs.values()) else 0

    def write_metrics(self) -> str:
        """Snapshot the telemetry registry (dispatch + serve counters)
        to ``metrics.json`` -- the smoke drill's coalescing evidence."""
        path = os.path.join(self.dir, "metrics.json")
        tmp = path + ".tmp"
        with open(tmp, "w") as f:
            json.dump(tel.REGISTRY.snapshot(), f, indent=1,
                      sort_keys=True)
            f.write("\n")
        os.replace(tmp, path)
        return path

    def close(self) -> None:
        self.journal.close()


def _make_supervisor(*args, **kwargs):
    """Late import: ``repro_torch.resilience.supervisor`` imports the
    session layer, which imports the engine layer -- keep farm import
    light."""
    from repro_torch.resilience import Supervisor
    return Supervisor(*args, **kwargs)


# ---------------------------------------------------------------------------
# HTTP front-end: a thin threaded shell over SweepFarm
# ---------------------------------------------------------------------------

#: endpoint discovery file the server writes into its directory
ENDPOINT_NAME = "serve.json"

#: AdmissionError -> 400, QueueFullError -> 429, DrainingError -> 503
_STATUS = {AdmissionError: 400, QueueFullError: 429,
           DrainingError: 503}


def _make_handler(farm: SweepFarm):
    from http.server import BaseHTTPRequestHandler

    class Handler(BaseHTTPRequestHandler):
        protocol_version = "HTTP/1.1"

        def _reply(self, code: int, doc: dict) -> None:
            body = json.dumps(doc).encode() + b"\n"
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def log_message(self, fmt, *args):  # quiet by default
            pass

        def do_GET(self):
            if self.path == "/v1/status":
                return self._reply(200, farm.status())
            if self.path.startswith("/v1/jobs/"):
                job = farm.job(self.path[len("/v1/jobs/"):])
                if job is None:
                    return self._reply(404, {"error": "unknown job"})
                return self._reply(200, job)
            return self._reply(404, {"error": f"no route {self.path}"})

        def do_POST(self):
            if self.path == "/v1/drain":
                farm.request_drain()
                return self._reply(200, {"draining": True})
            if self.path != "/v1/jobs":
                return self._reply(404,
                                   {"error": f"no route {self.path}"})
            try:
                n = int(self.headers.get("Content-Length", 0))
                doc = json.loads(self.rfile.read(n) or b"null")
            except (ValueError, json.JSONDecodeError) as e:
                REJECTED.inc()
                return self._reply(400, {"error": "AdmissionError",
                                         "detail": f"bad JSON: {e}"})
            try:
                jid = farm.submit(doc)
            except (AdmissionError, QueueFullError,
                    DrainingError) as e:
                return self._reply(_STATUS[type(e)],
                                   {"error": type(e).__name__,
                                    "detail": str(e)})
            return self._reply(200, {"job": jid})

    return Handler


def serve(directory: str, *, port: int = 0, poll: float = 0.25,
          drain_on_idle: bool = False, **farm_kwargs) -> int:
    """Run the farm with the HTTP front-end until drained; returns the
    exit code (0 done / 3 drained-preempted).  Installs SIGTERM/SIGINT
    handlers that trigger a graceful drain; writes ``serve.json``
    (host/port/pid) into the directory for client discovery and a
    final ``metrics.json`` snapshot on the way out."""
    import signal
    from http.server import ThreadingHTTPServer

    farm = SweepFarm(directory, **farm_kwargs)
    httpd = ThreadingHTTPServer(("127.0.0.1", port),
                                _make_handler(farm))
    endpoint = {"host": "127.0.0.1",
                "port": httpd.server_address[1],
                "pid": os.getpid()}
    ep_path = os.path.join(directory, ENDPOINT_NAME)
    with open(ep_path + ".tmp", "w") as f:
        json.dump(endpoint, f)
    os.replace(ep_path + ".tmp", ep_path)

    def _drain_handler(signum, frame):
        farm.request_drain()

    prev = {}
    for sig in (signal.SIGTERM, signal.SIGINT):
        prev[sig] = signal.signal(sig, _drain_handler)
    t = threading.Thread(target=httpd.serve_forever, daemon=True)
    t.start()
    print(f"# serving {directory} on "
          f"http://127.0.0.1:{endpoint['port']} (pid {os.getpid()})",
          flush=True)
    try:
        code = farm.serve_forever(poll=poll,
                                  drain_on_idle=drain_on_idle)
    finally:
        for sig, h in prev.items():
            signal.signal(sig, h)
        httpd.shutdown()
        farm.write_metrics()
        farm.close()
    n_done = sum(1 for j in farm.jobs.values() if j.terminal)
    print(f"# drained: {n_done}/{len(farm.jobs)} jobs terminal, "
          f"exit {code}", flush=True)
    return code
