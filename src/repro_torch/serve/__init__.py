"""``repro_torch.serve`` -- the fault-tolerant sweep-farm service.

Counterpart of ``repro.serve``.  A long-running server (``python -m
repro_torch serve DIR``) that accepts ``RunSpec`` JSON submissions and
executes them on the card with exactly-once, crash-safe semantics:

* :mod:`~repro_torch.serve.journal` -- the durable write-ahead job
  journal (CRC-framed, fsync'd, torn-write recovery);
* :mod:`~repro_torch.serve.scheduler` -- typed admission and the
  coalescer that fuses compatible specs into one ensemble dispatch;
* :mod:`~repro_torch.serve.server` -- :class:`SweepFarm` (the in-process
  service object) and the stdlib HTTP front-end;
* :mod:`~repro_torch.serve.client` -- :class:`ServeClient`, the matching
  submit/poll/drain client;
* :mod:`~repro_torch.serve.smoke` -- the crash drill: submit, SIGKILL,
  restart, assert every job completes with digests bit-identical to
  direct ``Session`` runs.

``SweepFarm``/``ServeClient`` are loaded lazily (PEP 562): the server
module pulls in telemetry and, at run time, the session/engine stack.
"""
from __future__ import annotations

from .errors import (AdmissionError, DrainingError, JournalError,
                     QueueFullError, ServeError)

__all__ = [
    "ServeError", "AdmissionError", "QueueFullError",
    "DrainingError", "JournalError",
    "Journal", "SweepFarm", "ServeClient",
]


def __getattr__(name: str):
    if name == "Journal":
        from .journal import Journal
        return Journal
    if name == "SweepFarm":
        from .server import SweepFarm
        return SweepFarm
    if name == "ServeClient":
        from .client import ServeClient
        return ServeClient
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
