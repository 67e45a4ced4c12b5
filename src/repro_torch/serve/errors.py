"""Typed exceptions of the sweep-farm service.

Counterpart of ``repro.serve.errors``, the same types.  Admission
failures are part of the API, not crashes: every malformed or
unacceptable submission maps to one of these types, and the HTTP
front-end maps each type to a status code (400/429/503).  Nothing a
client sends may take the server down.
"""
from __future__ import annotations


class ServeError(RuntimeError):
    """Base class of the serve subsystem's own failures."""


class AdmissionError(ServeError):
    """A submission is malformed or invalid (bad JSON envelope, spec
    that fails :class:`~repro_torch.api.spec.RunSpec` validation, missing
    sweep target).  HTTP 400."""


class QueueFullError(ServeError):
    """The bounded submission queue is at capacity -- backpressure,
    not data loss: the client retries later.  HTTP 429."""


class DrainingError(ServeError):
    """The server is draining (SIGTERM or ``/v1/drain``) and no longer
    admits work.  HTTP 503."""


class JournalError(ServeError):
    """The job journal cannot be read or written (unrecoverable framing
    damage in the middle of the file, I/O failure on append)."""
