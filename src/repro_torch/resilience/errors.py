"""Typed exceptions of the resilience subsystem.

Counterpart of ``repro.resilience.errors``.  The dispatch-recovery layer
(``repro_torch.resilience.degrade``) classifies failures by
*recoverability*, not by origin: a transient fault is worth retrying
with backoff, a k-sweep-tier resource exhaustion is worth a one-time
demotion to the per-half-sweep tier, and anything else propagates.  The
fault-injection harness (``repro_torch.resilience.faults``) raises
exactly these types so injected and real failures travel the same
recovery paths.
"""
from __future__ import annotations


class ResilienceError(RuntimeError):
    """Base class of the resilience subsystem's own failures."""


class TransientDispatchError(ResilienceError):
    """A dispatch failure worth retrying: the operation itself is fine,
    the attempt hit a transient condition (injected chaos).  The one type
    :func:`repro_torch.resilience.degrade.is_transient` classifies
    transient."""


class SimulatedResourceExhausted(ResilienceError):
    """Injected stand-in for a k-sweep tier that the card cannot hold
    (the class of ``torch.cuda.OutOfMemoryError`` for its output planes,
    or of a tile over the card's shared memory).  The message keeps the
    JAX package's ``RESOURCE_EXHAUSTED`` token."""

    def __init__(self, detail: str = "simulated k-sweep tier exhaustion"):
        super().__init__(f"RESOURCE_EXHAUSTED: {detail} (injected by "
                         f"repro_torch.resilience.faults)")


class SupervisorError(ResilienceError):
    """A supervised run cannot proceed (no spec and no checkpoint, spec
    mismatch against the checkpoint being resumed, ...)."""


class FaultPlanError(ResilienceError):
    """A fault plan cannot be parsed (malformed JSON, not an object,
    unknown fault kind, negative count).  Carries the offending text so
    a bad ``REPRO_FAULTS`` value is diagnosable from the message alone
    -- a chaos drill that silently runs WITHOUT its injected faults would
    pass vacuously."""

    def __init__(self, detail: str, text: str = ""):
        self.text = text
        suffix = f" (offending text: {text!r})" if text else ""
        super().__init__(f"bad fault plan: {detail}{suffix}")
