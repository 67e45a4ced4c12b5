"""Fault-tolerant checkpointing: atomic, async, verified, reshardable.

Counterpart of ``repro.ckpt.checkpointer``, byte-compatible with it: a
step directory written by either package validates and restores under
the other.  Layout: ``<dir>/step_<N>/arrays.npz`` + ``manifest.json`` +
``DONE`` marker (the marker commits the checkpoint -- a killed writer
never leaves a readable-but-partial step), and a ``spec.json`` sidecar
where the caller gives one.  The manifest
(``repro_torch.resilience.integrity``) carries per-file and per-array
CRC32C records written *before* DONE, so the atomic-rename commit covers
it: restore verifies the bytes it reads, quarantines corrupt/truncated
steps (``quarantine_step_<N>`` rename + ``ckpt.quarantine`` counter),
and falls back to the newest step that validates.

A tree is a tensor or numpy array, or a dict, list or tuple of trees;
its arrays are keyed by their path (``"nested/c/0"``, dict keys in
sorted order), as the JAX package flattens a pytree.  ``save_async``
copies every tensor to the host on the caller's thread (a synchronous
``.cpu()``, so the next sweep cannot change the planes under the
writer), then writes on a worker thread so the sweep loop is not
blocked; a worker failure is stored and re-raised on the next
``save``/``save_async``/``wait``/``close`` call instead of dying
silently on a daemon thread.  Restore returns host numpy arrays and the
caller places them, which is what makes restarts elastic: a checkpoint
written on one mesh restores onto another, or onto none.

Every load-path guard raises a typed :class:`CheckpointError` (or the
:class:`CheckpointIntegrityError` subclass) naming the offending
step/key/shape -- a bare ``assert`` vanishes under ``python -O`` and
would let a corrupt restore proceed.
"""
from __future__ import annotations

import os
import shutil
import threading
from typing import Any, Dict, List, Optional, Tuple

import numpy as np

import repro_torch.telemetry as tel
from repro_torch.resilience import integrity

#: steps renamed out of the way by :meth:`Checkpointer.quarantine`
QUARANTINE_PREFIX = "quarantine_"

#: module-held reference survives REGISTRY.reset()
QUARANTINES = tel.REGISTRY.counter("ckpt.quarantine")


class CheckpointError(RuntimeError):
    """A checkpoint cannot be saved/restored (missing step, shape
    mismatch against the restore template, no valid step left)."""


class CheckpointIntegrityError(CheckpointError):
    """A checkpoint step exists but its bytes fail verification; the
    message carries the per-file/per-array problem list."""

    def __init__(self, step_dir: str, problems: List[str]):
        self.step_dir = step_dir
        self.problems = list(problems)
        lines = "".join(f"\n  - {p}" for p in problems)
        super().__init__(f"checkpoint {step_dir} failed "
                         f"verification:{lines}")


def _leaves(tree, prefix=()):
    """``(path, leaf)`` pairs of a tree, dict keys in sorted order."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k], prefix + (str(k),))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _leaves(v, prefix + (str(i),))
    else:
        yield "/".join(prefix), tree


def _host(leaf) -> np.ndarray:
    """A leaf as a host numpy array: a tensor copied to the host (a copy
    on the CPU too, so that a later in-place sweep cannot reach it)."""
    if hasattr(leaf, "detach"):
        return leaf.detach().to("cpu", copy=True).numpy()
    return np.asarray(leaf)


def _flatten(tree) -> dict:
    return {key: _host(leaf) for key, leaf in _leaves(tree)}


def _unflatten_into(tree, arrays: dict, prefix=()):
    """``tree``'s structure with each leaf replaced by its checkpoint
    array (a host numpy array of the leaf's shape)."""
    if isinstance(tree, dict):
        return {k: _unflatten_into(v, arrays, prefix + (str(k),))
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_unflatten_into(v, arrays, prefix + (str(i),))
                          for i, v in enumerate(tree))
    key = "/".join(prefix)
    if key not in arrays:
        raise CheckpointError(
            f"checkpoint is missing array {key!r} required by the "
            f"restore template (has: {sorted(arrays)})")
    a = arrays[key]
    if a.shape != tuple(tree.shape):
        raise CheckpointError(
            f"checkpoint array {key!r} has shape {tuple(a.shape)}, "
            f"restore template expects {tuple(tree.shape)}")
    return a


class Checkpointer:
    def __init__(self, directory: str, keep: int = 3):
        self.dir = directory
        self.keep = keep
        os.makedirs(directory, exist_ok=True)
        self._worker: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None

    # -- write --------------------------------------------------------------
    def save(self, step: int, tree, spec_json: Optional[str] = None) -> str:
        """``spec_json`` (a serialized ``RunSpec``) is written as a
        ``spec.json`` sidecar inside the step dir, committed by the same
        DONE marker; read it back with :meth:`read_spec`."""
        self._raise_pending()
        host = _flatten(tree)
        return self._write(step, host, spec_json)

    def save_async(self, step: int, tree,
                   spec_json: Optional[str] = None) -> None:
        """Snapshot to host now; write on a background thread.  A
        failure on the worker is re-raised by the NEXT call into this
        checkpointer (store-and-rethrow), never swallowed."""
        self._raise_pending()
        host = _flatten(tree)  # the synchronous device->host copy
        self._join()
        self._raise_pending()
        self._worker = threading.Thread(target=self._write_guarded,
                                        args=(step, host, spec_json),
                                        daemon=True)
        self._worker.start()

    def wait(self) -> None:
        """Block until the in-flight async write (if any) finishes;
        re-raise its failure here if it died."""
        self._join()
        self._raise_pending()

    def close(self) -> None:
        """Flush and surface any pending async-writer failure."""
        self.wait()

    def _join(self):
        if self._worker is not None:
            self._worker.join()
            self._worker = None

    def _raise_pending(self):
        if self._error is not None:
            exc, self._error = self._error, None
            raise CheckpointError(
                f"async checkpoint write failed: "
                f"{type(exc).__name__}: {exc}") from exc

    def _write_guarded(self, step, host, spec_json):
        try:
            self._write(step, host, spec_json)
        except BaseException as exc:  # surfaced on the next call
            self._error = exc

    def _write(self, step: int, host: dict,
               spec_json: Optional[str] = None) -> str:
        # runs on the save_async worker thread: the span lands on its
        # own tid in the trace, visualizing the I/O-compute overlap
        with tel.span("ckpt.write", step=step, dir=self.dir,
                      n_arrays=len(host)):
            path = self._step_dir(step)
            tmp = path + ".tmp"
            if os.path.exists(tmp):
                shutil.rmtree(tmp)
            os.makedirs(tmp)
            np.savez(os.path.join(tmp, integrity.ARRAYS_NAME), **host)
            if spec_json is not None:
                with open(os.path.join(tmp, integrity.SPEC_NAME),
                          "w") as f:
                    f.write(spec_json)
            # manifest before DONE: the marker commits payload AND sums
            integrity.write_manifest(
                tmp, integrity.build_manifest(step, host, tmp))
            with open(os.path.join(tmp, integrity.DONE_NAME), "w") as f:
                f.write(str(step))
            if os.path.exists(path):
                shutil.rmtree(path)
            os.replace(tmp, path)
            self._gc()
        return path

    def _gc(self):
        steps = self.all_steps()
        for s in steps[:-self.keep] if self.keep else []:
            shutil.rmtree(self._step_dir(s), ignore_errors=True)

    # -- discovery / validation ---------------------------------------------
    def _step_dir(self, step: int) -> str:
        return os.path.join(self.dir, f"step_{step:010d}")

    def all_steps(self):
        """Committed steps (DONE marker present), oldest first; no
        byte-level validation -- see :meth:`valid_steps`."""
        out = []
        for d in sorted(os.listdir(self.dir)):
            if d.startswith("step_") and os.path.exists(
                    os.path.join(self.dir, d, integrity.DONE_NAME)):
                out.append(int(d.split("_")[1]))
        return out

    def validate_step(self, step: int) -> List[str]:
        """File-level problems of one step (empty list = valid)."""
        return integrity.validate_step_dir(self._step_dir(step),
                                           expect_step=step)

    def valid_steps(self):
        """Steps whose bytes verify, oldest first.  Walks every
        committed step; prefer :meth:`latest_step` (newest-first early
        exit) when only the restore candidate matters."""
        return [s for s in self.all_steps() if not self.validate_step(s)]

    def latest_step(self, validate: bool = True) -> Optional[int]:
        """Newest restorable step, or ``None``.

        With ``validate`` (the default) candidates are checked newest
        first and invalid ones -- torn writes, truncation, stale DONE,
        bit rot, steps pruned mid-walk -- are skipped, so discovery
        lands on the newest step that will actually restore.
        """
        steps = self.all_steps()
        if not validate:
            return steps[-1] if steps else None
        for s in reversed(steps):
            if not self.validate_step(s):
                return s
        return None

    def quarantine(self, step: int, problems: List[str]) -> Optional[str]:
        """Move a corrupt step out of the discovery namespace
        (``step_N`` -> ``quarantine_step_N``) so it is never considered
        again, keeping the bytes for post-mortem.  Returns the new path
        (``None`` when the step vanished first -- a GC prune race)."""
        src = self._step_dir(step)
        dst = os.path.join(self.dir,
                           QUARANTINE_PREFIX + os.path.basename(src))
        try:
            if os.path.exists(dst):
                shutil.rmtree(dst)
            os.replace(src, dst)
        except (FileNotFoundError, NotADirectoryError):
            return None
        QUARANTINES.inc()
        tel.instant("ckpt.quarantine", step=step, dir=self.dir,
                    problems=problems)
        return dst

    # -- read ---------------------------------------------------------------
    def read_spec(self, step: Optional[int] = None) -> Optional[str]:
        """The ``spec.json`` sidecar of ``step`` (default: newest valid),
        or ``None`` when the checkpoint was written without one."""
        if step is None:
            step = self.latest_step()
        if step is None:
            raise CheckpointError(
                f"no valid checkpoint found in {self.dir}")
        path = os.path.join(self._step_dir(step), integrity.SPEC_NAME)
        if not os.path.exists(path):
            return None
        with open(path) as f:
            return f.read()

    def load_arrays(self, step: Optional[int] = None,
                    quarantine: bool = True
                    ) -> Tuple[int, Dict[str, np.ndarray]]:
        """Load and VERIFY one step's arrays; ``(step, {key: array})``.

        With ``step=None`` the newest valid step is restored; corrupt
        candidates found on the way are quarantined (when ``quarantine``)
        and the walk falls back to the previous good one.  An explicit
        ``step`` that fails verification raises
        :class:`CheckpointIntegrityError` -- the caller asked for those
        exact bytes, silently substituting others would be worse.
        """
        explicit = step is not None
        candidates = [step] if explicit else \
            list(reversed(self.all_steps()))
        if not candidates:
            raise CheckpointError(f"no checkpoint found in {self.dir}")
        for s in candidates:
            step_dir = self._step_dir(s)
            problems = integrity.validate_step_dir(step_dir,
                                                   expect_step=s)
            if not problems:
                try:
                    with np.load(os.path.join(step_dir,
                                              integrity.ARRAYS_NAME),
                                 allow_pickle=False) as z:
                        arrays = {k: z[k] for k in z.files}
                    problems = integrity.verify_arrays(
                        arrays, integrity.load_manifest(step_dir))
                except (FileNotFoundError, NotADirectoryError) as e:
                    problems = [f"step vanished during load: {e}"]
                except Exception as e:
                    problems = [f"arrays fail to load: "
                                f"{type(e).__name__}: {e}"]
            if not problems:
                return s, arrays
            if explicit:
                raise CheckpointIntegrityError(step_dir, problems)
            if quarantine:
                self.quarantine(s, problems)
        raise CheckpointError(
            f"no valid checkpoint left in {self.dir}: every committed "
            f"step failed verification")

    def restore(self, template, step: Optional[int] = None
                ) -> Tuple[int, Any]:
        """Restore into the structure of ``template`` as host numpy
        arrays, which the caller places (on any device or mesh).
        Verifies bytes against the step's manifest and falls back to
        the newest valid step (see :meth:`load_arrays`)."""
        step, arrays = self.load_arrays(step)
        return step, _unflatten_into(template, arrays)
