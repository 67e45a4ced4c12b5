"""Session: open, run, measure, save, restore and digest a single run.

Counterpart of ``repro.api.session`` for single mode.  The checkpoint is
the JAX package's layout -- an atomically renamed ``.npz`` with
``spec_json``, ``step_count`` and ``state_<name>`` arrays -- and
``state_digest`` frames the state as the JAX package does, so a run
saved by either package restores in the other and the digests of equal
states are equal.

The entry points run on CUDA unless the caller passes ``device="cpu"``;
with no device named and no GPU present they raise.  They never move to
the CPU on their own.
"""
from __future__ import annotations

import os
import tempfile

import numpy as np
import torch

from repro_torch.core.engine import make_engine
from repro_torch.resilience import integrity

from .spec import RunSpec


def resolve_device(device=None) -> torch.device:
    """``device`` as a ``torch.device``; ``None`` means the CUDA card,
    and raises where there is none."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; pass device='cpu' to run "
                "the plain PyTorch versions of the kernels")
        return torch.device("cuda")
    return torch.device(device)


def _atomic_savez(path: str, **arrays) -> None:
    """Write-temp-then-rename ``.npz``: a killed writer never leaves a
    readable-but-partial checkpoint."""
    fd, tmp = tempfile.mkstemp(dir=os.path.dirname(path) or ".",
                               suffix=".tmp")
    try:
        with os.fdopen(fd, "wb") as f:
            np.savez(f, **arrays)
        os.replace(tmp, path)
    except BaseException:
        os.unlink(tmp)
        raise


def _load_checkpoint(path: str):
    """Read a checkpoint: ``(spec, step_count, state arrays)``."""
    with np.load(path, allow_pickle=False) as z:
        if "spec_json" not in z.files:
            raise ValueError(f"{path}: not a checkpoint in the RunSpec "
                             f"layout (no 'spec_json')")
        spec = RunSpec.from_json(str(z["spec_json"]))
        step_count = int(z["step_count"])
        arrays = {k[len("state_"):]: z[k] for k in z.files
                  if k.startswith("state_")}
    return spec, step_count, arrays


class _SingleRunner:
    """One lattice, its engine advanced in place."""

    def __init__(self, spec: RunSpec, device: torch.device, state=None,
                 step_count: int = 0, resident_budget_bytes=None):
        self.spec = spec
        self.cfg = spec.sim_config()
        self.engine = make_engine(self.cfg, device, resident_budget_bytes)
        self.step_count = step_count
        self.state = self.engine.init_state() if state is None else state

    def run(self, n_sweeps: int) -> None:
        self.state = self.engine.sweeps(self.state, n_sweeps,
                                        self.step_count)
        self.step_count += n_sweeps

    def measure(self, plan) -> dict:
        from repro_torch.analysis.measure import measure_scan
        self.state, traj, self.step_count = measure_scan(
            self.engine, self.state, plan, step_count=self.step_count)
        return traj

    def magnetization(self) -> float:
        return float(self.engine.magnetization(self.state))

    def energy(self) -> float:
        return float(self.engine.energy(self.state))

    def full_lattice(self) -> torch.Tensor:
        return self.engine.full_lattice(self.state)

    def state_arrays(self) -> dict:
        return self.engine.state_arrays(self.state)

    def load_arrays(self, arrays: dict) -> None:
        self.state = self.engine.from_arrays(arrays)


class Session:
    """Open a spec, run it, measure it, checkpoint it (single mode)."""

    def __init__(self, spec: RunSpec, runner: _SingleRunner):
        self.spec = spec
        self._runner = runner

    @classmethod
    def open(cls, spec: RunSpec, device=None, *,
             resident_budget_bytes=None) -> "Session":
        """A fresh run of ``spec`` on ``device`` (default: the CUDA card).
        ``resident_budget_bytes`` overrides the k-sweep planner's shared
        memory budget per block (0: the per-half-sweep tier)."""
        return cls(spec, _SingleRunner(
            spec, resolve_device(device),
            resident_budget_bytes=resident_budget_bytes))

    @property
    def engine(self):
        return self._runner.engine

    @property
    def device(self) -> torch.device:
        return self._runner.engine.device

    @property
    def state(self):
        """The engine-native state, a pair of (black, white) planes:
        ``stencil_pallas``: int8 +-1 planes ``(n, m/2)``;
        ``multispin``/``multispin_pallas``: int32 tensors ``(n, m/16)``
        holding uint32 words of 8 nibble spins (``black_words``,
        ``white_words`` in a checkpoint); ``bitplane``/
        ``bitplane_pallas``: int32 tensors ``(n, m/2)`` holding uint32
        words whose bit r is replica r (``black_bits``, ``white_bits``);
        ``tensorcore``: a dict of four int8 sublattice planes ``'00'``,
        ``'01'``, ``'10'``, ``'11'`` of ``(n/2, m/2)`` (``plane_XX``)."""
        return self._runner.state

    @property
    def step_count(self) -> int:
        return self._runner.step_count

    def run(self, n_sweeps: int) -> None:
        """Advance ``n_sweeps`` full lattice sweeps."""
        self._runner.run(n_sweeps)

    def measure(self, plan=None) -> dict:
        """Run a measurement plan (default: ``spec.sweep``); returns
        ``{field: (n_measure,) float32 ndarray}``, or ``(n_measure, 32)``
        for the bitplane engines' per-replica observables."""
        if plan is None:
            if self.spec.sweep is None:
                raise ValueError("no plan: pass one or set RunSpec.sweep")
            plan = self.spec.sweep.plan()
        return self._runner.measure(plan)

    def trajectory(self, n_measure: int, sweeps_between: int,
                   thermalize: int = 0) -> np.ndarray:
        """Magnetization samples, shape ``(n_measure,)`` (``(n_measure,
        32)`` for the bitplane engines)."""
        from repro_torch.analysis.measure import MeasurementPlan
        plan = MeasurementPlan(n_measure, sweeps_between, thermalize,
                               fields=("m",))
        return self.measure(plan)["m"]

    def magnetization(self) -> float:
        """Mean spin (for bitplane: the mean over the 32 replicas)."""
        return self._runner.magnetization()

    def energy(self) -> float:
        """Energy per spin (for bitplane: the mean over the replicas)."""
        return self._runner.energy()

    def full_lattice(self) -> torch.Tensor:
        return self._runner.full_lattice()

    def state_digest(self) -> str:
        """CRC32C hex digest of (step_count, every named state array),
        framed as the JAX package frames it: equal digests mean
        bit-identical lattices at the same point of the trajectory."""
        crc = integrity.crc32c(
            f"step_count={self._runner.step_count}".encode())
        for k, v in sorted(self._runner.state_arrays().items()):
            a = np.ascontiguousarray(np.asarray(v))
            crc = integrity.crc32c(f"{k}:{a.dtype}:{a.shape}:".encode(), crc)
            crc = integrity.crc32c(a.tobytes(), crc)
        return f"{crc:08x}"

    def save(self, path: str) -> None:
        """Atomic checkpoint: serialized spec, step count and the
        engine's named state arrays."""
        arrays = {f"state_{k}": v
                  for k, v in self._runner.state_arrays().items()}
        _atomic_savez(path, spec_json=self.spec.to_json(),
                      step_count=self._runner.step_count, **arrays)

    @classmethod
    def restore(cls, path: str, device=None, *,
                resident_budget_bytes=None) -> "Session":
        """Rebuild a session from a checkpoint of either package; a
        counter-based engine continues the exact Philox stream.
        ``resident_budget_bytes`` as for :meth:`open`."""
        spec, step_count, arrays = _load_checkpoint(path)
        runner = _SingleRunner(spec, resolve_device(device),
                               state=_SENTINEL, step_count=step_count,
                               resident_budget_bytes=resident_budget_bytes)
        runner.load_arrays(arrays)
        return cls(spec, runner)


#: placeholder state that lets ``restore`` skip the fresh init
_SENTINEL = ()
