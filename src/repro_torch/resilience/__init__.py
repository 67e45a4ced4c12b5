"""``repro_torch.resilience`` -- fault tolerance for long unattended runs.

Counterpart of ``repro.resilience``, in four pieces:

* :mod:`~repro_torch.resilience.integrity` -- CRC32C checkpoint manifests
  and verify-on-restore;
* :mod:`~repro_torch.resilience.faults` -- deterministic fault injection
  (crash topologies on disk, transient/out-of-memory dispatch failures);
* :mod:`~repro_torch.resilience.degrade` -- bounded retry/backoff and
  k-sweep-tier demotion around every dispatch, with the CUDA error
  classification;
* :class:`Supervisor` -- the run supervisor behind
  ``python -m repro_torch run --supervise``: periodic checkpoints,
  SIGTERM/SIGINT-safe preemption, resume-from-newest-valid-step with a
  bit-exact-resume contract.

``Supervisor`` is loaded lazily (PEP 562): it imports
``repro_torch.api.session`` which imports ``repro_torch.core.engine``,
and the engine layer imports this package for the degrade path -- eager
loading would cycle.
"""
from __future__ import annotations

from . import degrade, faults, integrity
from .errors import (FaultPlanError, ResilienceError,
                     SimulatedResourceExhausted, SupervisorError,
                     TransientDispatchError)

__all__ = [
    "degrade", "faults", "integrity",
    "ResilienceError", "TransientDispatchError",
    "SimulatedResourceExhausted", "SupervisorError", "FaultPlanError",
    "Supervisor", "SupervisorResult",
]


def __getattr__(name: str):
    if name in ("Supervisor", "SupervisorResult"):
        from .supervisor import Supervisor, SupervisorResult
        return {"Supervisor": Supervisor,
                "SupervisorResult": SupervisorResult}[name]
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
