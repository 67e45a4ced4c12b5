"""Durable write-ahead job journal: CRC-framed, fsync'd, replayable.

Counterpart of ``repro.serve.journal``, byte for byte: either package
reads and appends to the other's ``journal.jsonl``.  The journal is the
farm's ONLY durable source of truth.  One append-only text file, one
record per line:

    <crc32c hex8> <compact JSON object>\\n

The checksum (``repro_torch.resilience.integrity.crc32c`` over the JSON
bytes) frames each record independently, so recovery needs no global
index: replay walks the file line by line and stops at the first line
that is torn (no trailing newline), malformed, or checksum-broken.
Everything after the damage is BY CONSTRUCTION unacknowledged -- a
record is fsync'd before the caller acts on it (``append`` returns
only after ``os.fsync``), so a torn tail can only be the record that
was being written when the process died.

Recovery truncates the file back to the last whole record and
preserves the damaged tail bytes in a ``journal.torn.<k>`` sidecar
(quarantine ethos: never destroy evidence).  Damage in the MIDDLE of
the file -- a good line after a bad one -- is not a crash topology an
append-only fsync'd writer can produce; that is real corruption and
raises :class:`~repro_torch.serve.errors.JournalError` instead of silently
dropping acknowledged records.

Record kinds (the scheduler's protocol, validated loosely here --
the journal stores dicts, the farm assigns meaning):

* ``submit`` -- an accepted job: id, spec document, sweep target,
  optional timeout; fsync'd BEFORE the client is acked, so an acked
  job is never lost;
* ``start``  -- a dispatch batch began: batch id, member job ids,
  coalesce key (informational: replay does not need it, the smoke
  drill asserts coalescing from it);
* ``done``   -- a job reached a terminal state: completed (with
  digest + summary) or failed (with error text).  At most one per
  job -- the exactly-once invariant replay enforces.
"""
from __future__ import annotations

import json
import os
from typing import Iterator, List, Optional, Tuple

from repro_torch.resilience import integrity

from .errors import JournalError

#: journal file name inside the farm directory
JOURNAL_NAME = "journal.jsonl"


def _frame(record: dict) -> bytes:
    body = json.dumps(record, sort_keys=True,
                      separators=(",", ":")).encode()
    crc = integrity.crc32c(body)
    return f"{crc:08x} ".encode() + body + b"\n"


def _parse_line(line: bytes) -> Optional[dict]:
    """The record a complete line holds, or ``None`` when the line is
    damaged (bad frame, bad checksum, bad JSON)."""
    if not line.endswith(b"\n"):
        return None
    try:
        crc_hex, body = line[:-1].split(b" ", 1)
        if len(crc_hex) != 8:
            return None
        want = int(crc_hex, 16)
    except ValueError:
        return None
    if integrity.crc32c(body) != want:
        return None
    try:
        record = json.loads(body)
    except json.JSONDecodeError:
        return None
    return record if isinstance(record, dict) else None


class Journal:
    """Append-only journal over one file; construction RECOVERS.

    ``Journal(path)`` replays the existing file (if any), truncates a
    torn tail (keeping it in a sidecar), and opens for appending; the
    replayed records are in :attr:`records`.  ``append`` is durable:
    it returns only after the bytes are flushed and fsync'd.
    """

    def __init__(self, path: str):
        self.path = path
        self.records: List[dict] = []
        self.recovered_tail: Optional[str] = None  # sidecar path
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        self._recover()
        self._f = open(path, "ab")

    # -- recovery ------------------------------------------------------------
    def _recover(self) -> None:
        if not os.path.exists(self.path):
            return
        with open(self.path, "rb") as f:
            data = f.read()
        good_end = 0
        records: List[dict] = []
        pos = 0
        while pos < len(data):
            nl = data.find(b"\n", pos)
            line = data[pos:] if nl < 0 else data[pos:nl + 1]
            record = _parse_line(line)
            if record is None:
                break
            records.append(record)
            pos = nl + 1
            good_end = pos
        tail = data[good_end:]
        if tail:
            # every line after the damage must ALSO be damaged-or-empty
            # territory; a valid record after a torn one means the file
            # was corrupted in place, not torn by a crash
            rest = tail.split(b"\n")
            for i, cand in enumerate(rest[1:], start=1):
                if cand and _parse_line(cand + b"\n") is not None:
                    raise JournalError(
                        f"{self.path}: valid record found AFTER damaged "
                        f"bytes at offset {good_end} -- mid-file "
                        f"corruption, not a torn append; refusing to "
                        f"drop acknowledged records")
            self.recovered_tail = self._quarantine_tail(tail)
            with open(self.path, "r+b") as f:
                f.truncate(good_end)
                f.flush()
                os.fsync(f.fileno())
        self.records = records

    def _quarantine_tail(self, tail: bytes) -> str:
        k = 0
        while True:
            side = f"{self.path}.torn.{k}"
            if not os.path.exists(side):
                break
            k += 1
        with open(side, "wb") as f:
            f.write(tail)
        return side

    # -- append --------------------------------------------------------------
    def append(self, record: dict) -> dict:
        """Durably append one record (flush + fsync before returning);
        returns the record for chaining."""
        if not isinstance(record, dict) or "kind" not in record:
            raise JournalError(
                f"journal records are dicts with a 'kind', got "
                f"{record!r}")
        try:
            self._f.write(_frame(record))
            self._f.flush()
            os.fsync(self._f.fileno())
        except OSError as e:
            raise JournalError(
                f"{self.path}: append failed: {e}") from e
        self.records.append(record)
        return record

    def close(self) -> None:
        self._f.close()

    def __enter__(self) -> "Journal":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


def replay(path: str) -> Iterator[dict]:
    """Read-only replay of the whole records stream (recovery included,
    via a throwaway :class:`Journal`); what the smoke drill and tests
    use to inspect a farm directory without opening it for writing."""
    j = Journal(path)
    try:
        yield from j.records
    finally:
        j.close()


def job_table(records) -> Tuple[dict, dict]:
    """Fold a record stream into ``(jobs, dones)``:

    ``jobs``  -- job id -> its ``submit`` record, submission order
    preserved (dict insertion order);
    ``dones`` -- job id -> its first ``done`` record.  A second done
    for the same job violates exactly-once and raises."""
    jobs: dict = {}
    dones: dict = {}
    for r in records:
        kind = r.get("kind")
        if kind == "submit":
            jid = r["job"]
            if jid in jobs:
                raise JournalError(
                    f"duplicate submit record for job {jid}")
            jobs[jid] = r
        elif kind == "done":
            jid = r["job"]
            if jid not in jobs:
                raise JournalError(
                    f"done record for unknown job {jid}")
            if jid in dones:
                raise JournalError(
                    f"duplicate done record for job {jid} -- "
                    f"exactly-once violated")
            dones[jid] = r
    return jobs, dones
