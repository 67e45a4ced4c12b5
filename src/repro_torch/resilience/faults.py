"""Deterministic fault injection: chaos you can write a regression for.

Counterpart of ``repro.resilience.faults``, with the same plan format,
so one ``REPRO_FAULTS`` value drives both packages' CLIs.  Two halves,
matching the two failure surfaces of a long unattended run:

* **Dispatch faults** -- a process-global :class:`FaultPlan` consulted
  by the recovery wrapper (``repro_torch.resilience.degrade.
  run_dispatch``) once per dispatch.  The plan deterministically raises
  :class:`~repro_torch.resilience.errors.TransientDispatchError` for the
  first ``transient_dispatches`` dispatches and
  :class:`~repro_torch.resilience.errors.SimulatedResourceExhausted`
  for the first ``resident_oom`` dispatches that would run on the
  k-sweep tier.  Faults fire BEFORE the dispatch's first launch, so no
  failed attempt has written the state and a retry is always safe.
  ``install_from_env()`` reads the plan from ``REPRO_FAULTS`` (a JSON
  object), which is how the chaos drill injects into a subprocess CLI
  run without touching its command line.

* **Checkpoint corrupters** -- functions that reproduce the on-disk
  crash topologies against a ``Checkpointer`` step directory:
  ``kill_mid_write`` (torn write, no DONE), ``truncate_arrays``
  (short ``arrays.npz`` under a valid DONE), ``stale_done`` (DONE
  marker outliving its arrays), and ``flip_byte`` (silent bit rot).
  Each is deterministic given its arguments; they drive both the test
  suite and the chaos drill (``python -m repro_torch.resilience
  corrupt``).

When no plan is installed the dispatch-fault check is one global
``is None`` load -- nothing on the hot path changes shape.
"""
from __future__ import annotations

import dataclasses
import json
import os
from contextlib import contextmanager
from typing import Optional

from .errors import (FaultPlanError, SimulatedResourceExhausted,
                     TransientDispatchError)

#: environment variable ``install_from_env`` reads a JSON plan from
ENV_VAR = "REPRO_FAULTS"


@dataclasses.dataclass
class FaultPlan:
    """Counters of faults still to inject; fields tick down to zero.

    ``transient_dispatches`` -- raise ``TransientDispatchError`` on
    this many dispatches (recoverable by bounded retry).
    ``resident_oom`` -- raise ``SimulatedResourceExhausted`` on this
    many dispatches whose engine would use the k-sweep tier
    (recoverable by demotion to the per-half-sweep tier).
    """

    transient_dispatches: int = 0
    resident_oom: int = 0
    #: injections actually fired, by kind (for assertions/telemetry)
    fired: dict = dataclasses.field(default_factory=dict)

    def __post_init__(self):
        if self.transient_dispatches < 0 or self.resident_oom < 0:
            raise ValueError(f"fault counts must be >= 0: {self}")

    def maybe_fail_dispatch(self, resident_active: bool) -> None:
        if resident_active and self.resident_oom > 0:
            self.resident_oom -= 1
            self.fired["resident_oom"] = \
                self.fired.get("resident_oom", 0) + 1
            raise SimulatedResourceExhausted(
                "k-sweep tier output planes over the card's memory")
        if self.transient_dispatches > 0:
            self.transient_dispatches -= 1
            self.fired["transient_dispatch"] = \
                self.fired.get("transient_dispatch", 0) + 1
            raise TransientDispatchError(
                "UNAVAILABLE: injected transient dispatch failure")

    @classmethod
    def from_json(cls, s: str) -> "FaultPlan":
        """Parse a plan from JSON; every malformation -- syntax error,
        non-object document, unknown fault kind, non-integer or
        negative count -- raises a typed
        :class:`~repro_torch.resilience.errors.FaultPlanError` carrying
        the offending text (the ``REPRO_FAULTS`` contract: a chaos drill
        must fail loudly, not run faultless)."""
        try:
            d = json.loads(s)
        except json.JSONDecodeError as e:
            raise FaultPlanError(f"malformed JSON: {e}", s) from e
        if not isinstance(d, dict):
            raise FaultPlanError(
                f"must be a JSON object, got {type(d).__name__}", s)
        unknown = sorted(set(d) - {"transient_dispatches",
                                   "resident_oom"})
        if unknown:
            raise FaultPlanError(
                f"unknown fault kind(s) {unknown}; known: "
                f"['resident_oom', 'transient_dispatches']", s)
        counts = {}
        for k, v in d.items():
            if isinstance(v, bool) or not isinstance(v, int):
                raise FaultPlanError(
                    f"count {k}={v!r} must be an integer", s)
            counts[k] = v
        try:
            return cls(**counts)
        except ValueError as e:  # __post_init__: negative counts
            raise FaultPlanError(str(e), s) from e


_PLAN: Optional[FaultPlan] = None


def install(plan: FaultPlan) -> FaultPlan:
    """Make ``plan`` the process-global dispatch fault plan."""
    global _PLAN
    _PLAN = plan
    return plan


def clear() -> None:
    global _PLAN
    _PLAN = None


def active_plan() -> Optional[FaultPlan]:
    return _PLAN


@contextmanager
def injected(plan: FaultPlan):
    """Scoped installation: ``with faults.injected(FaultPlan(...)):``"""
    prev = _PLAN
    install(plan)
    try:
        yield plan
    finally:
        install(prev) if prev is not None else clear()


def install_from_env(env_var: str = ENV_VAR) -> Optional[FaultPlan]:
    """Install a plan from ``$REPRO_FAULTS`` (JSON object); no-op and
    ``None`` when the variable is unset/empty.  Called by the CLI
    supervise path so the chaos drill can inject into a subprocess."""
    raw = os.environ.get(env_var, "")
    if not raw:
        return None
    return install(FaultPlan.from_json(raw))


# ---------------------------------------------------------------------------
# file corrupters: byte-level crash topologies on ANY file, which the
# checkpoint corrupters below are built on
# ---------------------------------------------------------------------------

def truncate_file(path: str, keep_bytes: int) -> str:
    """Truncate ``path`` to ``keep_bytes`` -- a torn write: the tail of
    the file never reached disk (power cut mid-append, lost page-cache
    flush)."""
    if keep_bytes < 0:
        raise ValueError(f"keep_bytes must be >= 0, got {keep_bytes}")
    with open(path, "r+b") as f:
        f.truncate(keep_bytes)
    return path


def flip_byte_in_file(path: str, offset: int = 128) -> str:
    """XOR one byte of ``path`` at ``offset`` (mod file size): silent
    bit rot that only a content checksum catches."""
    size = os.path.getsize(path)
    if size == 0:
        raise ValueError(f"{path}: empty file, nothing to flip")
    with open(path, "r+b") as f:
        f.seek(offset % size)
        b = f.read(1)
        f.seek(offset % size)
        f.write(bytes([b[0] ^ 0xFF]))
    return path


# ---------------------------------------------------------------------------
# checkpoint corrupters: the on-disk crash topologies
# ---------------------------------------------------------------------------

def _step_dir(directory: str, step: int) -> str:
    return os.path.join(directory, f"step_{step:010d}")


def kill_mid_write(directory: str, step: int,
                   partial_bytes: bytes = b"\x93NUMPY-torn") -> str:
    """A writer killed mid-step: the step dir exists with a partial
    ``arrays.npz`` and NO DONE marker (what a crash between ``savez``
    and the marker write leaves when the tmp-rename is also lost)."""
    path = _step_dir(directory, step)
    os.makedirs(path, exist_ok=True)
    with open(os.path.join(path, "arrays.npz"), "wb") as f:
        f.write(partial_bytes)
    done = os.path.join(path, "DONE")
    if os.path.exists(done):
        os.remove(done)
    return path


def truncate_arrays(directory: str, step: int,
                    keep_bytes: int = 64) -> str:
    """Truncate a COMMITTED step's ``arrays.npz`` to ``keep_bytes``,
    leaving the DONE marker valid -- a torn write the marker outlived
    (lost page-cache flush, partial copy)."""
    return truncate_file(
        os.path.join(_step_dir(directory, step), "arrays.npz"),
        keep_bytes)


def stale_done(directory: str, step: int) -> str:
    """Delete a committed step's ``arrays.npz`` out from under its DONE
    marker (a partially-propagated object-store delete, or tooling that
    removed the payload but not the marker)."""
    path = os.path.join(_step_dir(directory, step), "arrays.npz")
    os.remove(path)
    return path


def flip_byte(directory: str, step: int, offset: int = 128,
              filename: str = "arrays.npz") -> str:
    """XOR one byte of a committed step's payload: silent bit rot the
    zip container may or may not notice, but the CRC32C manifest must."""
    return flip_byte_in_file(
        os.path.join(_step_dir(directory, step), filename), offset)


#: corrupter registry for the ``python -m repro_torch.resilience corrupt``
#: CLI
CORRUPTERS = {
    "kill-mid-write": kill_mid_write,
    "truncate": truncate_arrays,
    "stale-done": stale_done,
    "flip-byte": flip_byte,
}
