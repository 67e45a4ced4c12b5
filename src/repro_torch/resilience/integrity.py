"""Checkpoint integrity: CRC32C, and manifests committed under DONE.

Copied from the JAX package's ``resilience/integrity.py`` so that this
package imports nothing of it.  CRC32C (Castagnoli), numpy only: a
slicing-by-8 table walk for short inputs and a vectorized GF(2)
reduction ladder for long ones, both giving the reference's values (the
tests check them); it is the checksum behind ``Session.state_digest``
and the checkpoint manifests.

A checkpoint step that *looks* complete (its ``DONE`` marker exists) can
still be unreadable: a torn write the marker outlived, a truncated
``arrays.npz``, a flipped byte.  Every step of a
``repro_torch.ckpt.Checkpointer`` has a ``manifest.json`` written
*before* the DONE marker (so the atomic-rename commit covers it too), in
the JAX package's format, so that either package validates the other's
steps:

* per **file** (``arrays.npz``, ``spec.json``): byte length + CRC32C,
  the whole-file check run at discovery time;
* per **array** (each npz key): CRC32C over the raw array bytes plus
  shape and dtype, verified after deserialization so a restore can name
  exactly which array went bad.

The CRC runs on the host: its cost is paid once per checkpoint write
and restore, never on the sweep path.  Verification is *reporting*, not
raising: ``validate_step_dir`` and ``verify_arrays`` return a list of
human-readable problems (empty = valid).
"""
from __future__ import annotations

import json
import os
from typing import Dict, List, Optional

import numpy as np

#: manifest schema version (the JAX package's)
MANIFEST_FORMAT = 1
MANIFEST_NAME = "manifest.json"
DONE_NAME = "DONE"
ARRAYS_NAME = "arrays.npz"
SPEC_NAME = "spec.json"

_POLY = 0x82F63B78  # CRC-32C (Castagnoli), reflected


def _make_tables():
    t0 = []
    for i in range(256):
        c = i
        for _ in range(8):
            c = (c >> 1) ^ (_POLY if c & 1 else 0)
        t0.append(c)
    tables = [t0]
    for _ in range(7):
        prev = tables[-1]
        tables.append([t0[prev[i] & 0xFF] ^ (prev[i] >> 8)
                       for i in range(256)])
    return tables


_T = _make_tables()


#: below this length the scalar slicing-by-8 walk beats numpy setup
_NUMPY_THRESHOLD = 2048


def crc32c(data, value: int = 0) -> int:
    """CRC32C of ``data`` (bytes-like); pass a previous ``value`` to
    checksum incrementally: ``crc32c(b, crc32c(a)) == crc32c(a + b)``.

    Inputs of 2 KiB and more take the vectorized ladder
    (:func:`_crc32c_numpy`); the scalar walk is the oracle it is tested
    against.
    """
    if len(memoryview(data)) * memoryview(data).itemsize \
            >= _NUMPY_THRESHOLD:
        return _crc32c_numpy(data, value)
    return _crc32c_scalar(data, value)


def _crc32c_scalar(data, value: int = 0) -> int:
    crc = (value ^ 0xFFFFFFFF) & 0xFFFFFFFF
    mv = memoryview(data)
    if mv.ndim != 1 or mv.itemsize != 1:
        mv = mv.cast("B")
    t0, t1, t2, t3, t4, t5, t6, t7 = _T
    n = len(mv)
    i = 0
    # slicing-by-8: one table walk per 8 input bytes
    for i in range(0, n - 7, 8):
        crc ^= mv[i] | (mv[i + 1] << 8) | (mv[i + 2] << 16) \
            | (mv[i + 3] << 24)
        crc = (t7[crc & 0xFF] ^ t6[(crc >> 8) & 0xFF]
               ^ t5[(crc >> 16) & 0xFF] ^ t4[(crc >> 24) & 0xFF]
               ^ t3[mv[i + 4]] ^ t2[mv[i + 5]]
               ^ t1[mv[i + 6]] ^ t0[mv[i + 7]])
    for j in range(n - n % 8, n):
        crc = t0[(crc ^ mv[j]) & 0xFF] ^ (crc >> 8)
    return crc ^ 0xFFFFFFFF


# -- vectorized CRC ladder ---------------------------------------------------
#
# The byte-at-a-time recurrence crc' = (crc >> 8) ^ T[(crc ^ b) & 0xFF]
# splits, because T is a table of a GF(2)-LINEAR map on the low byte,
# into  crc' = L(crc) ^ T[b]  with  L(c) = (c >> 8) ^ T[c & 0xFF]  also
# linear.  Unrolling:  crc_n = L^n(init) ^ XOR_i L^(n-1-i)(T[b_i]).
# The XOR sum is an associative reduction -- combine(x, y) over a
# right half of length 2^k is L^(2^k)(x) ^ y -- so it evaluates as a
# log-depth numpy tree: one vectorized 4-table lookup per level, with
# the per-level operator L^(2^k) built once by self-composition and
# cached.  Front-padding with zero *bytes* is free (T[0] = 0 and the
# position weights count from the END), which keeps every level's
# element lengths equal.

_T0_NP = np.array(_T[0], dtype=np.uint32)


def _op_apply_np(op: np.ndarray, v: np.ndarray) -> np.ndarray:
    """Apply a linear op (4 x 256 uint32 byte tables) elementwise."""
    return (op[0][v & 0xFF] ^ op[1][(v >> 8) & 0xFF]
            ^ op[2][(v >> 16) & 0xFF] ^ op[3][v >> 24])


def _make_l1() -> np.ndarray:
    q = np.arange(256, dtype=np.uint32)
    op = np.zeros((4, 256), np.uint32)
    op[0] = _T0_NP                      # L(q)       = T[q]
    for p in range(1, 4):               # L(q << 8p) = q << 8(p-1)
        op[p] = q << (8 * (p - 1))
    return op


#: _LEVELS[k] = byte tables of L^(2^k); grown on demand, process-cached
_LEVELS = [_make_l1()]


def _level(k: int) -> np.ndarray:
    while len(_LEVELS) <= k:
        prev = _LEVELS[-1]
        _LEVELS.append(np.stack([_op_apply_np(prev, prev[p])
                                 for p in range(4)]))
    return _LEVELS[k]


def _crc32c_numpy(data, value: int = 0) -> int:
    d = np.frombuffer(memoryview(data).cast("B"), dtype=np.uint8)
    n = d.size
    if n == 0:
        return value
    e = _T0_NP[d]
    size = 1 << (n - 1).bit_length()
    if size != n:  # zero-pad at the FRONT: weights count from the end
        e = np.concatenate([np.zeros(size - n, np.uint32), e])
    k = 0
    while e.size > 1:
        e = _op_apply_np(_level(k), e[0::2]) ^ e[1::2]
        k += 1
    red = int(e[0])
    # init-register contribution L^n(init), by binary exponentiation
    state = (value ^ 0xFFFFFFFF) & 0xFFFFFFFF
    k, nn = 0, n
    while nn:
        if nn & 1:
            op = _level(k)
            state = int(op[0][state & 0xFF] ^ op[1][(state >> 8) & 0xFF]
                        ^ op[2][(state >> 16) & 0xFF]
                        ^ op[3][state >> 24])
        nn >>= 1
        k += 1
    return (state ^ red) ^ 0xFFFFFFFF


def crc32c_hex(data, value: int = 0) -> str:
    return f"{crc32c(data, value):08x}"


def file_crc32c(path: str, chunk_bytes: int = 1 << 20):
    """``(crc32c, nbytes)`` of a file, streamed in ``chunk_bytes``."""
    crc, n = 0, 0
    with open(path, "rb") as f:
        while True:
            chunk = f.read(chunk_bytes)
            if not chunk:
                break
            crc = crc32c(chunk, crc)
            n += len(chunk)
    return crc, n


def _array_record(a: np.ndarray) -> dict:
    a = np.ascontiguousarray(a)
    return {"crc32c": crc32c_hex(a.tobytes()),
            "nbytes": int(a.nbytes),
            "shape": list(a.shape),
            "dtype": str(a.dtype)}


def build_manifest(step: int, host: Dict[str, np.ndarray],
                   step_dir: str) -> dict:
    """The integrity manifest of one step: per-array CRCs from the
    in-memory host snapshot (the exact bytes ``np.savez`` serialized),
    per-file CRCs from the bytes on disk in ``step_dir``."""
    files = {}
    for name in (ARRAYS_NAME, SPEC_NAME):
        path = os.path.join(step_dir, name)
        if os.path.exists(path):
            crc, nbytes = file_crc32c(path)
            files[name] = {"crc32c": f"{crc:08x}", "nbytes": nbytes}
    return {"format": MANIFEST_FORMAT,
            "algo": "crc32c",
            "step": int(step),
            "files": files,
            "arrays": {k: _array_record(np.asarray(v))
                       for k, v in host.items()}}


def write_manifest(step_dir: str, manifest: dict) -> str:
    path = os.path.join(step_dir, MANIFEST_NAME)
    with open(path, "w") as f:
        json.dump(manifest, f, indent=1, sort_keys=True)
    return path


def load_manifest(step_dir: str) -> Optional[dict]:
    """The parsed manifest, or ``None`` when the step predates the
    integrity format (legacy steps stay restorable)."""
    path = os.path.join(step_dir, MANIFEST_NAME)
    if not os.path.exists(path):
        return None
    with open(path) as f:
        return json.load(f)


def validate_step_dir(step_dir: str,
                      expect_step: Optional[int] = None) -> List[str]:
    """File-level validation of one step directory; returns the list of
    problems (empty = valid).  This is the discovery-time check: cheap
    enough to run on every candidate while walking backwards for the
    newest restorable step, yet strong enough to catch every crash
    topology -- torn write (no DONE), stale DONE (missing arrays),
    truncation, and bit corruption (file CRC mismatch).

    A vanished directory (``keep``-pruning racing the validation) is
    reported as a problem, never an exception: the caller just moves on
    to the next candidate.
    """
    problems: List[str] = []
    try:
        if not os.path.isdir(step_dir):
            return [f"step dir missing: {step_dir}"]
        if not os.path.exists(os.path.join(step_dir, DONE_NAME)):
            return ["no DONE marker (uncommitted/torn write)"]
        arrays_path = os.path.join(step_dir, ARRAYS_NAME)
        if not os.path.exists(arrays_path):
            return [f"DONE present but {ARRAYS_NAME} missing "
                    f"(stale marker)"]
        try:
            manifest = load_manifest(step_dir)
        except (ValueError, OSError) as e:
            return [f"unreadable {MANIFEST_NAME}: {e}"]
        if manifest is None:
            # legacy (pre-integrity) step: the zip container's own
            # per-entry CRC32 is the only line of defense -- read every
            # entry so truncation/corruption surfaces here, not mid-restore
            try:
                with np.load(arrays_path, allow_pickle=False) as z:
                    for k in z.files:
                        z[k]
            except Exception as e:
                problems.append(f"legacy step fails to load: "
                                f"{type(e).__name__}: {e}")
            return problems
        if expect_step is not None \
                and manifest.get("step") != expect_step:
            problems.append(f"manifest step {manifest.get('step')!r} != "
                            f"directory step {expect_step}")
        for name, rec in manifest.get("files", {}).items():
            path = os.path.join(step_dir, name)
            if not os.path.exists(path):
                problems.append(f"{name}: in manifest but missing on disk")
                continue
            size = os.path.getsize(path)
            if size != rec["nbytes"]:
                problems.append(f"{name}: {size} bytes on disk, manifest "
                                f"says {rec['nbytes']} (truncated?)")
                continue
            crc, _ = file_crc32c(path)
            if f"{crc:08x}" != rec["crc32c"]:
                problems.append(f"{name}: CRC32C {crc:08x} != manifest "
                                f"{rec['crc32c']} (corrupt)")
    except (FileNotFoundError, NotADirectoryError) as e:
        # the directory (or a file inside it) vanished mid-validation:
        # a GC prune raced us -- this candidate is simply gone
        problems.append(f"step vanished during validation: {e}")
    return problems


def verify_arrays(arrays: Dict[str, np.ndarray],
                  manifest: Optional[dict]) -> List[str]:
    """Per-array verification of a deserialized checkpoint against its
    manifest: key set, shape, dtype, and CRC32C of the raw bytes.  The
    problem strings NAME the offending array -- a corrupt restore must
    say which key went bad, not just that something did."""
    if manifest is None:
        return []  # legacy step: nothing recorded to verify against
    problems: List[str] = []
    recorded = manifest.get("arrays", {})
    missing = sorted(set(recorded) - set(arrays))
    extra = sorted(set(arrays) - set(recorded))
    if missing:
        problems.append(f"arrays missing vs manifest: {missing}")
    if extra:
        problems.append(f"arrays not in manifest: {extra}")
    for k in sorted(set(recorded) & set(arrays)):
        a = np.ascontiguousarray(np.asarray(arrays[k]))
        rec = recorded[k]
        if list(a.shape) != rec["shape"] or str(a.dtype) != rec["dtype"]:
            problems.append(
                f"array {k!r}: shape/dtype {a.shape}/{a.dtype} != "
                f"manifest {tuple(rec['shape'])}/{rec['dtype']}")
            continue
        got = crc32c_hex(a.tobytes())
        if got != rec["crc32c"]:
            problems.append(f"array {k!r}: CRC32C {got} != manifest "
                            f"{rec['crc32c']} (corrupt)")
    return problems
