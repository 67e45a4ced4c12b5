"""Graceful dispatch degradation: bounded retry + k-sweep-tier demotion.

Counterpart of ``repro.resilience.degrade``.  One dispatch (a runner's
``sweeps`` call) travels through :func:`run_dispatch`, which classifies
failures by *recoverability*:

* **transient** (:func:`is_transient` -- ``TransientDispatchError``
  only: no CUDA error code is transient) -- retried with exponential
  backoff under a bounded :class:`RetryPolicy`; each retry increments
  the ``resilience.retry`` counter and emits a ``resilience.retry``
  trace instant.
* **a k-sweep tier the card cannot hold** (:func:`is_resident_oom`) --
  ``torch.cuda.OutOfMemoryError`` (the k-sweep and shard kernels work
  out of place and allocate a second copy of the planes, which the
  per-half-sweep tier does not need), a launch that returned
  ``cudaErrorMemoryAllocation`` (2) or ``cudaErrorLaunchOutOfResources``
  (701), a tile over the card's shared memory
  (``kernels.errors.SharedMemoryOverflow``), or the injected
  ``SimulatedResourceExhausted``.  The (engine family, lattice) is
  *demoted* to the per-half-sweep tier for the rest of the process and
  the dispatch restarted at once.  Both tiers draw the same Philox
  stream, so demotion is invisible in the trajectory.
* anything else propagates unchanged, and so do the sticky CUDA errors
  (an illegal or misaligned address, a kernel that faulted: they poison
  the context, and no retry can succeed) whatever their type.

**When a retry is safe.**  A dispatch is restarted from the state it was
given, so a retry or a demotion is safe only where no launch of the
failed attempt has written that state.  The per-half-sweep kernels (and
their plain versions) update the planes in place: after the first of
them in a dispatch the state has moved, and running the dispatch again
would apply those half-sweeps twice.  They note each write
(``kernels.errors.note_in_place``), and a failure after one propagates,
whatever its class.  The k-sweep and shard tiers work out of place:
they return new planes and leave their inputs as they were, so a
failure in any block of a k-sweep dispatch (an out-of-memory in its
third block, say) restarts from the untouched inputs.  Injected faults
fire before the dispatch's first launch, so they are always safe.

Demotions live in a process-global registry keyed ``(family, n, m)``:
``kernels.resident.plan_resident``, ``decision_attrs`` and the shard
planner consult it, so engine construction, ``--dry-run`` plans, and
dispatch span attributes all agree that a demoted lattice runs the
per-half-sweep tier.  With no fault plan installed and no failure
raised, ``run_dispatch`` adds one ``is None`` load and one counter read
to the hot path.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Callable, Dict, Optional, Tuple

import repro_torch.telemetry as tel
from repro_torch.kernels import errors as kernel_errors

from . import faults
from .errors import SimulatedResourceExhausted, TransientDispatchError

#: recovery counters -- module-held references survive REGISTRY.reset()
RETRIES = tel.REGISTRY.counter("resilience.retry")
DEMOTIONS = tel.REGISTRY.counter("resident.demote")


@dataclasses.dataclass(frozen=True)
class RetryPolicy:
    """Bounded exponential backoff for transient dispatch failures.

    ``sleep`` is injectable so tests retry without wall-clock cost.
    """

    max_retries: int = 3
    base_delay_s: float = 0.05
    multiplier: float = 4.0
    max_delay_s: float = 5.0
    sleep: Callable[[float], None] = time.sleep

    def delay(self, attempt: int) -> float:
        """Backoff before retry ``attempt`` (0-based)."""
        return min(self.base_delay_s * self.multiplier ** attempt,
                   self.max_delay_s)


DEFAULT_POLICY = RetryPolicy()


def is_sticky(exc: BaseException) -> bool:
    """A CUDA error that leaves the context unusable."""
    return isinstance(exc, kernel_errors.CudaLaunchError) and exc.sticky


def is_transient(exc: BaseException) -> bool:
    """Worth retrying: the typed transient error only."""
    return isinstance(exc, TransientDispatchError)


def is_resident_oom(exc: BaseException) -> bool:
    """A k-sweep tier the card cannot hold (module docstring):
    recoverable by demoting to the per-half-sweep tier, NOT by retrying
    the same launch."""
    if isinstance(exc, SimulatedResourceExhausted):
        return True
    if isinstance(exc, kernel_errors.SharedMemoryOverflow):
        return True
    if isinstance(exc, kernel_errors.CudaLaunchError):
        return exc.code in kernel_errors.RESOURCE_CODES
    import torch
    return isinstance(exc, torch.cuda.OutOfMemoryError)


# ---------------------------------------------------------------------------
# demotion registry: (family, n, m) -> reason, process-global
# ---------------------------------------------------------------------------

_DEMOTED: Dict[Tuple[str, int, int], str] = {}


def demote(family: str, n: int, m: int, reason: str) -> None:
    """Record that (family, n, m) must run the per-half-sweep tier from
    now on.  Idempotent; the first reason wins."""
    _DEMOTED.setdefault((family, n, m), reason)


def demotion_reason(family: str, n: int, m: int) -> Optional[str]:
    """The recorded demotion reason, or ``None`` when not demoted."""
    return _DEMOTED.get((family, n, m))


def demotions() -> Dict[Tuple[str, int, int], str]:
    """Snapshot of the registry (copy; mutating it changes nothing)."""
    return dict(_DEMOTED)


def reset_demotions() -> None:
    """Forget every demotion -- test isolation, not production use."""
    _DEMOTED.clear()


def _engine_demotable(engine) -> bool:
    return getattr(engine, "resident_plan", None) is not None


def _reason(exc: BaseException) -> str:
    return f"{type(exc).__name__}: {exc}"


def run_dispatch(attempt: Callable[[], object], *, engine=None,
                 on_demote: Optional[Callable[[], None]] = None,
                 policy: Optional[RetryPolicy] = None):
    """Run one dispatch with recovery (module docstring).

    ``attempt`` is a zero-arg closure over the dispatch; it is re-invoked
    as-is on retry, and after a demotion it must observe the engine's
    new tier (the engines read ``self.resident_plan`` on every call).
    ``on_demote`` lets a caller that holds its own tier (the sharded
    runner's shard plan) drop it when the engine's tier changes.
    """
    policy = DEFAULT_POLICY if policy is None else policy
    retries = 0
    while True:
        plan = faults.active_plan()
        writes = kernel_errors.in_place_count()
        try:
            if plan is not None:
                plan.maybe_fail_dispatch(_engine_demotable(engine))
            return attempt()
        except Exception as exc:
            if is_sticky(exc) or kernel_errors.in_place_count() != writes:
                raise  # the context is lost, or the state has moved
            if (engine is not None and _engine_demotable(engine)
                    and is_resident_oom(exc)):
                reason = _reason(exc)
                DEMOTIONS.inc()
                tel.instant("resident.demote", engine=engine.name,
                            lattice=(engine.cfg.n, engine.cfg.m),
                            reason=reason)
                engine._demote_resident(reason)
                if on_demote is not None:
                    on_demote()
                continue  # immediate restart on the per-half-sweep tier
            if is_transient(exc) and retries < policy.max_retries:
                delay = policy.delay(retries)
                retries += 1
                RETRIES.inc()
                tel.instant("resilience.retry", attempt=retries,
                            max_retries=policy.max_retries,
                            delay_s=delay, error=str(exc))
                policy.sleep(delay)
                continue
            raise
