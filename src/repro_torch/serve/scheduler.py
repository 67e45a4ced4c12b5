"""Admission + coalescing: queued jobs -> deterministic dispatch batches.

Counterpart of ``repro.serve.scheduler``: the same job ids, batch ids and
groupings for the same submissions.  Two pure pieces the farm loop
composes:

* **admission** -- ``parse_envelope`` maps a client document to a
  validated ``(RunSpec, sweeps, timeout_s)`` triple, converting every
  malformation into a typed
  :class:`~repro_torch.serve.errors.AdmissionError` (the server never
  crashes on input; the HTTP layer maps the type to a 400).  A
  ``MeshSpec`` job is admitted as a solo run whatever the number of
  cards: the port's mesh puts several shards on one device
  (``repro_torch.launch.mesh``), where the JAX package refuses a mesh
  larger than its device count;

* **coalescing** -- ``plan_batches`` groups compatible queued jobs into
  ensemble dispatches.  Compatible = single-mode spec on a
  counter-based engine (same engine + params, same lattice, same sweep
  target) with a seed below 2**32 (the ensemble bit-exactness bound):
  exactly the conditions under which member ``i`` of the fused batch
  reproduces job ``i``'s single-run trajectory bit-for-bit, so
  coalescing changes THROUGHPUT, never results.  Everything else runs
  uncoalesced as its own supervised run.

Grouping is a pure function of the queued jobs (submit order, chunks
of ``max_batch``) and batch ids hash (key, member ids) -- so a farm
restarted after a crash re-forms the identical batches and the
supervisor finds the checkpoints the killed run left behind.
"""
from __future__ import annotations

import dataclasses
import json
from typing import List, Optional, Tuple

from repro_torch.api import BatchSpec, RunSpec
from repro_torch.api.spec import MAX_BATCH_SEED
from repro_torch.resilience import integrity

from .errors import AdmissionError

#: submission envelope keys (a bare RunSpec document is also accepted)
ENVELOPE_KEYS = ("spec", "sweeps", "timeout_s")


@dataclasses.dataclass
class Job:
    """One accepted submission, in-memory view of its journal records."""

    id: str
    spec: RunSpec
    sweeps: int
    timeout_s: Optional[float]
    submitted_t: float
    status: str = "queued"       # queued|running|completed|failed
    digest: Optional[str] = None
    error: Optional[str] = None
    summary: dict = dataclasses.field(default_factory=dict)

    @property
    def terminal(self) -> bool:
        return self.status in ("completed", "failed")

    def expired(self, now: float) -> bool:
        return (self.timeout_s is not None
                and now - self.submitted_t > self.timeout_s)

    def to_dict(self) -> dict:
        return {"id": self.id, "status": self.status,
                "sweeps": self.sweeps, "timeout_s": self.timeout_s,
                "digest": self.digest, "error": self.error,
                "summary": self.summary,
                "spec": self.spec.to_dict()}


def parse_envelope(doc) -> Tuple[RunSpec, int, Optional[float]]:
    """Validate a submission document -> ``(spec, sweeps, timeout_s)``.

    Accepts either ``{"spec": <RunSpec doc>, "sweeps": N,
    "timeout_s": T}`` or a bare RunSpec document (sweep target then
    taken from ``spec.sweep.total_sweeps``).  Every malformation is an
    :class:`AdmissionError` -- never a server crash.
    """
    if not isinstance(doc, dict):
        raise AdmissionError(
            f"submission must be a JSON object, got "
            f"{type(doc).__name__}")
    sweeps = None
    timeout_s = None
    spec_doc = doc
    if "spec" in doc:
        unknown = sorted(set(doc) - set(ENVELOPE_KEYS))
        if unknown:
            raise AdmissionError(
                f"envelope: unknown key(s) {unknown}; allowed: "
                f"{sorted(ENVELOPE_KEYS)}")
        spec_doc = doc["spec"]
        sweeps = doc.get("sweeps")
        timeout_s = doc.get("timeout_s")
    try:
        spec = RunSpec.from_dict(spec_doc)
    except (ValueError, KeyError, TypeError) as e:
        raise AdmissionError(f"bad RunSpec: {e}") from e
    if sweeps is None:
        if spec.sweep is None:
            raise AdmissionError(
                "no sweep target: pass 'sweeps' in the envelope or a "
                "spec with a sweep plan")
        sweeps = spec.sweep.total_sweeps
    if isinstance(sweeps, bool) or not isinstance(sweeps, int) \
            or sweeps <= 0:
        raise AdmissionError(
            f"sweeps must be a positive integer, got {sweeps!r}")
    if timeout_s is not None:
        if isinstance(timeout_s, bool) \
                or not isinstance(timeout_s, (int, float)) \
                or float(timeout_s) <= 0:
            raise AdmissionError(
                f"timeout_s must be a positive number, got "
                f"{timeout_s!r}")
        timeout_s = float(timeout_s)
    return spec, int(sweeps), timeout_s


# ---------------------------------------------------------------------------
# coalescing
# ---------------------------------------------------------------------------

def coalesce_key(job: Job) -> Optional[tuple]:
    """The compatibility key of a job, or ``None`` when it must run
    uncoalesced.  Jobs with equal keys fuse into one vmapped ensemble
    dispatch without changing any member's result (see module doc)."""
    spec = job.spec
    if spec.mode != "single":
        return None
    if not spec.engine.cls.counter_based:
        return None
    if spec.seed >= MAX_BATCH_SEED:
        return None
    return (spec.engine.name, spec.engine.params,
            spec.lattice.n, spec.lattice.m, spec.lattice.init_p_up,
            job.sweeps)


@dataclasses.dataclass
class Batch:
    """One dispatch unit: either a fused ensemble of coalesced jobs
    (``key`` set) or a single job run as-is (``key`` None)."""

    id: str
    jobs: List[Job]
    key: Optional[tuple]

    @property
    def coalesced(self) -> bool:
        return self.key is not None

    @property
    def sweeps(self) -> int:
        return self.jobs[0].sweeps

    def spec(self) -> RunSpec:
        """The RunSpec this batch executes: the fused ensemble spec for
        a coalesced batch (member order = job order), the job's own
        spec otherwise."""
        if not self.coalesced:
            return self.jobs[0].spec
        j0 = self.jobs[0].spec
        return RunSpec(
            lattice=j0.lattice, engine=j0.engine,
            temperature=j0.temperature, seed=j0.seed,
            batch=BatchSpec(
                temperatures=tuple(j.spec.temperature
                                   for j in self.jobs),
                seeds=tuple(j.spec.seed for j in self.jobs)))

    def runner_key(self) -> tuple:
        """The runner-pool key: everything an ensemble runner's engine,
        plan and planes depend on -- engine + params, lattice, batch
        size -- and nothing member-specific (temperatures and seeds are
        re-bound: ``_EnsembleRunner.rebind``)."""
        j0 = self.jobs[0].spec
        return (j0.engine.name, j0.engine.params,
                j0.lattice.n, j0.lattice.m, j0.lattice.init_p_up,
                len(self.jobs))


def _batch_id(key: Optional[tuple], jobs: List[Job]) -> str:
    blob = json.dumps([list(key) if key else None,
                       [j.id for j in jobs]], sort_keys=True)
    return f"b{integrity.crc32c(blob.encode()):08x}"


def plan_batches(jobs: List[Job], max_batch: int) -> List[Batch]:
    """Deterministically group queued jobs into dispatch batches.

    Pure function of (job order, ``max_batch``): coalescible jobs
    group by key in submit order and split into chunks of at most
    ``max_batch``; uncoalescible jobs become singleton batches.
    Batches are ordered by their first member's submit position, and
    ids hash (key, member ids) -- a restarted farm re-plans the same
    queue into byte-identical batches, which is how an interrupted
    batch's checkpoints are found again.
    """
    if max_batch <= 0:
        raise ValueError(f"max_batch must be positive, got {max_batch}")
    groups: dict = {}
    order: List[tuple] = []  # (first position, key-or-job-marker)
    for pos, job in enumerate(jobs):
        key = coalesce_key(job)
        gk = key if key is not None else ("__solo__", job.id)
        if gk not in groups:
            groups[gk] = []
            order.append((pos, gk))
        groups[gk].append(job)
    batches: List[Batch] = []
    for _, gk in order:
        members = groups[gk]
        key = None if gk[0] == "__solo__" else gk
        if key is None:
            batches.append(Batch(_batch_id(None, members), members,
                                 None))
            continue
        for i in range(0, len(members), max_batch):
            chunk = members[i:i + max_batch]
            batches.append(Batch(_batch_id(key, chunk), chunk, key))
    return batches
