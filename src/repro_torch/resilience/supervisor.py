"""Run supervisor: periodic checkpoints, preemption, auto-resume.

Counterpart of ``repro.resilience.supervisor``, with its chunk grid, its
spec rule and its checkpoint directory, so that a directory written by
either package's supervisor resumes under the other.  The supervisor
owns a :class:`~repro_torch.api.session.Session` and advances it toward
a sweep target on a **fixed chunk grid**, checkpointing into a
:class:`~repro_torch.ckpt.Checkpointer` directory:

* **resume** -- on start, discover the newest *valid* step (torn,
  truncated, and bit-rotted steps are skipped by the integrity layer),
  verify the stored spec matches the requested one, and rebuild the
  session from it (``resilience.resume`` counter + trace instant);
* **cadence** -- after each chunk, write a checkpoint when
  ``every_sweeps`` sweeps or ``every_seconds`` wall-clock have passed
  since the last one (both zero = no periodic checkpoints and ZERO
  hot-path overhead: the loop is ``session.run`` plus two integer
  compares);
* **preemption** -- SIGTERM/SIGINT set a flag (installed only on the
  main thread; signal-handler-safe: no I/O in the handler); the loop
  notices at the next chunk boundary -- never in the middle of a
  launch -- writes a final checkpoint, and returns
  ``status="preempted"`` instead of dying mid-write.

Bit-exact-resume contract: an interrupted-and-resumed supervised run
produces bit-identical state to an uninterrupted one *of the same
supervisor config*.  Every engine of this package addresses its draws
by (seed, sweep, site), so its stream does not depend on the chunk
size; the fixed grid (``n = min(chunk, total - step_count)``,
checkpoints only at chunk boundaries) is kept all the same, as the JAX
package's key-based engines need it.  A resumed session is built on
the device the supervisor was given (``device``), whatever device
wrote the checkpoint.
"""
from __future__ import annotations

import dataclasses
import signal
import threading
import time
from typing import Callable, List, Optional

import repro_torch.telemetry as tel
from repro_torch.ckpt import Checkpointer

from .errors import SupervisorError

#: module-held reference survives REGISTRY.reset()
RESUMES = tel.REGISTRY.counter("resilience.resume")

#: default sweep-chunk between supervisor control points
DEFAULT_CHUNK = 64


@dataclasses.dataclass
class SupervisorResult:
    """What one :meth:`Supervisor.run` call did."""

    status: str                      # "completed" | "preempted"
    step_count: int                  # sweeps advanced so far (total)
    digest: str                      # Session.state_digest() at return
    resumed_from: Optional[int]      # checkpoint step, None = fresh
    checkpoints_written: List[int]   # steps written THIS call
    stop_signal: Optional[int] = None

    @property
    def completed(self) -> bool:
        return self.status == "completed"


class Supervisor:
    """Drive a session to a sweep target with checkpoints and
    preemption safety; see the module docstring for the contract.

    ``on_chunk(supervisor)`` runs after every advanced chunk (before
    the cadence check) -- the deterministic interruption hook the
    resume tests use (call :meth:`request_stop`, raise a signal, ...).
    """

    def __init__(self, spec, directory: str, *,
                 every_sweeps: int = 0, every_seconds: float = 0.0,
                 chunk: int = DEFAULT_CHUNK, keep: int = 3,
                 install_signal_handlers: bool = True,
                 on_chunk: Optional[Callable[["Supervisor"], None]]
                 = None, session=None, device=None):
        """``session`` (optional) is an already-open
        :class:`~repro_torch.api.session.Session` for ``spec`` used ONLY
        when no valid checkpoint exists in ``directory`` (a warm session
        skips its opening).  A resumable checkpoint always wins (crash
        recovery must restore the persisted trajectory, not a fresh
        injected state); the injected session must be at step 0 of the
        SAME spec.  ``device`` is ``Session.open``'s (default: the CUDA
        card)."""
        if chunk <= 0:
            raise SupervisorError(f"chunk must be positive, got {chunk}")
        if every_sweeps < 0 or every_seconds < 0:
            raise SupervisorError(
                f"checkpoint cadence must be >= 0, got "
                f"every_sweeps={every_sweeps} "
                f"every_seconds={every_seconds}")
        if session is not None:
            if spec is None:
                raise SupervisorError(
                    "session= injection needs the matching spec too")
            if session.spec.to_dict() != spec.to_dict():
                raise SupervisorError(
                    f"injected session's spec does not match the "
                    f"supervised spec ({session.spec.to_dict()} != "
                    f"{spec.to_dict()})")
            if session.step_count != 0:
                raise SupervisorError(
                    f"injected session must be at step 0, is at "
                    f"{session.step_count}")
        self.ckpt = Checkpointer(directory, keep=keep)
        self.chunk = chunk
        self.every_sweeps = every_sweeps
        self.every_seconds = every_seconds
        self.install_signal_handlers = install_signal_handlers
        self.on_chunk = on_chunk
        self._injected = session
        self._device = device
        self._stop = threading.Event()
        self._stop_signal: Optional[int] = None
        self.resumed_from: Optional[int] = None
        self.session = self._open(spec)

    @staticmethod
    def _spec_key(spec) -> dict:
        """The spec fields that define the TRAJECTORY: everything but
        the mesh.  Two specs equal under this key produce bit-identical
        state streams (sharded runs are global-position-keyed), so a
        supervised run may resume on a different device grid."""
        d = spec.to_dict()
        d.pop("mesh", None)
        return d

    # -- resume -------------------------------------------------------------
    def _open(self, spec):
        from repro_torch.api.session import Session
        step = self.ckpt.latest_step()  # newest VALID step only
        if step is None:
            if self._injected is not None:
                return self._injected
            if spec is None:
                raise SupervisorError(
                    f"no spec given and no valid checkpoint to resume "
                    f"in {self.ckpt.dir}")
            return Session.open(spec, self._device)
        from repro_torch.api.spec import RunSpec
        stored_json = self.ckpt.read_spec(step)
        if stored_json is None:
            raise SupervisorError(
                f"checkpoint step {step} in {self.ckpt.dir} has no "
                f"spec.json sidecar; cannot verify it matches this run")
        stored = RunSpec.from_json(stored_json)
        resume_spec = stored
        if spec is not None and stored.to_dict() != spec.to_dict():
            if self._spec_key(stored) != self._spec_key(spec):
                raise SupervisorError(
                    f"checkpoint step {step} in {self.ckpt.dir} was "
                    f"written by a different spec; refusing to resume "
                    f"a different run (stored {stored.to_dict()} != "
                    f"requested {spec.to_dict()})")
            # mesh-only difference: the device grid is an execution
            # detail, not part of the trajectory's identity (global-
            # position Philox keying) -- resume the stored trajectory on
            # the REQUESTED mesh
            resume_spec = spec
        # load_arrays re-validates and falls back if the step rotted
        # between discovery and here
        step, arrays = self.ckpt.load_arrays(step)
        RESUMES.inc()
        tel.instant("resilience.resume", step=step, dir=self.ckpt.dir)
        self.resumed_from = step
        return Session._from_arrays(resume_spec, arrays, step,
                                    device=self._device)

    # -- preemption ---------------------------------------------------------
    def request_stop(self, signum: Optional[int] = None) -> None:
        """Ask the run loop to checkpoint and return at the next chunk
        boundary (what the signal handlers call; also the test hook)."""
        self._stop_signal = signum
        self._stop.set()

    def _handler(self, signum, frame):
        self.request_stop(signum)

    def _install_handlers(self):
        if not self.install_signal_handlers:
            return {}
        if threading.current_thread() is not threading.main_thread():
            return {}  # signal.signal raises off the main thread
        prev = {}
        for sig in (signal.SIGTERM, signal.SIGINT):
            prev[sig] = signal.signal(sig, self._handler)
        return prev

    @staticmethod
    def _restore_handlers(prev):
        for sig, h in prev.items():
            signal.signal(sig, h)

    # -- checkpointing ------------------------------------------------------
    def checkpoint(self) -> int:
        """Write the session's state as a verified step NOW (manifest
        committed under DONE); returns the step number."""
        s = self.session
        step = s.step_count
        with tel.span("supervisor.checkpoint", step=step):
            self.ckpt.save(step, s._runner.state_arrays(),
                           spec_json=s.spec.to_json())
        return step

    # -- the run loop -------------------------------------------------------
    def run(self, total_sweeps: int) -> SupervisorResult:
        """Advance the session to ``total_sweeps`` (absolute, counted
        from step 0 -- a resumed session has less left to do), writing
        cadence checkpoints, and return how it went.  A requested stop
        (signal or :meth:`request_stop`) checkpoints and returns
        ``status="preempted"`` instead of raising."""
        s = self.session
        if s.step_count > total_sweeps:
            raise SupervisorError(
                f"checkpoint is at sweep {s.step_count}, past the "
                f"requested total {total_sweeps}")
        written: List[int] = []
        prev_handlers = self._install_handlers()
        last_ckpt_step = s.step_count
        last_ckpt_time = time.monotonic()
        preempted = False
        try:
            with tel.span("supervisor.run", total=total_sweeps,
                          start=s.step_count,
                          resumed_from=self.resumed_from,
                          chunk=self.chunk):
                while s.step_count < total_sweeps:
                    if self._stop.is_set():
                        preempted = True
                        break
                    # FIXED chunk grid: boundaries depend only on the
                    # config, never on where a past run was interrupted
                    n = min(self.chunk, total_sweeps - s.step_count)
                    s.run(n)
                    if self.on_chunk is not None:
                        self.on_chunk(self)
                    if self._cadence_due(s.step_count, last_ckpt_step,
                                         last_ckpt_time):
                        written.append(self.checkpoint())
                        last_ckpt_step = s.step_count
                        last_ckpt_time = time.monotonic()
                if self._stop.is_set():
                    preempted = s.step_count < total_sweeps
                # final checkpoint: preemption always persists progress;
                # completion persists the final state unless it is
                # already on disk
                if s.step_count != last_ckpt_step or not written:
                    if preempted or self._checkpointing_enabled() \
                            or self.ckpt.all_steps():
                        written.append(self.checkpoint())
                self.ckpt.wait()
        finally:
            self._restore_handlers(prev_handlers)
        return SupervisorResult(
            status="preempted" if preempted else "completed",
            step_count=s.step_count, digest=s.state_digest(),
            resumed_from=self.resumed_from,
            checkpoints_written=written,
            stop_signal=self._stop_signal)

    def _checkpointing_enabled(self) -> bool:
        return bool(self.every_sweeps or self.every_seconds)

    def _cadence_due(self, step: int, last_step: int,
                     last_time: float) -> bool:
        if self.every_sweeps and step - last_step >= self.every_sweeps:
            return True
        if self.every_seconds \
                and time.monotonic() - last_time >= self.every_seconds:
            return True
        return False
