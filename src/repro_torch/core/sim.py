"""``SimConfig`` and ``Simulation``, the legacy single-run entry point.

Counterpart of ``repro.core.sim``.  ``SimConfig`` is the engine
construction config a ``RunSpec`` lowers to; ``Simulation`` is a thin
façade over :class:`repro_torch.api.Session` in single mode, kept so that
code and checkpoints of the config-era API keep working.  New code should
build a ``RunSpec``.

Checkpoints written here carry both the serialized spec (``spec_json``,
the layout ``Session.restore`` reads) and the legacy ``config_json``, so
that a restored ``.config`` equals the saved one, knobs the engine
ignores included; either package restores the other's.
"""
from __future__ import annotations

import dataclasses
import json

import numpy as np


@dataclasses.dataclass
class SimConfig:
    n: int = 512
    m: int = 512
    temperature: float = 2.0
    seed: int = 1234
    engine: str = "multispin"
    tc_block: int = 128
    # 0.5 = random (hot) start; 1.0 = ordered start, for steady-state
    # runs below Tc (cold random starts can stripe-lock)
    init_p_up: float = 0.5
    # spin glass only: probability that a quenched bond is ferromagnetic
    p_ferro: float = 0.5

    @property
    def inv_temp(self) -> float:
        return 1.0 / self.temperature


class Simulation:
    """One 2D Ising run of a registry engine, on ``device`` (default: the
    CUDA card; raises where there is none)."""

    def __init__(self, config: SimConfig, device=None):
        from repro_torch.api import RunSpec, Session
        self.config = config
        self._session = Session.open(RunSpec.from_sim_config(config), device)

    @property
    def engine(self):
        return self._session.engine

    @property
    def state(self):
        return self._session.state

    @state.setter
    def state(self, v):
        self._session.state = v

    @property
    def step_count(self) -> int:
        return self._session.step_count

    @step_count.setter
    def step_count(self, v: int) -> None:
        self._session.step_count = v

    def full_lattice(self):
        return self._session.full_lattice()

    def run(self, n_sweeps: int) -> None:
        self._session.run(n_sweeps)

    def magnetization(self) -> float:
        """Mean spin, read on the host (so it waits for the card)."""
        return self._session.magnetization()

    def energy(self) -> float:
        return self._session.energy()

    def measure(self, plan) -> dict:
        """Run a :class:`repro_torch.analysis.MeasurementPlan`: ``{field:
        (n_measure,) float32 ndarray}``."""
        return self._session.measure(plan)

    def trajectory(self, n_measure: int, sweeps_between: int,
                   thermalize: int = 0) -> np.ndarray:
        """Magnetization samples, ``(n_measure,)``; the bitplane engines
        give ``(n_measure, 32)``, one series a replica."""
        return self._session.trajectory(n_measure, sweeps_between,
                                        thermalize)

    def save(self, path: str) -> None:
        """Atomic checkpoint: the spec layout plus the legacy
        ``config_json``."""
        self._session.save(path, extra={
            "config_json": json.dumps(dataclasses.asdict(self.config))})

    @classmethod
    def restore(cls, path: str, device=None) -> "Simulation":
        """A simulation from a single-mode checkpoint of either package
        (of the spec layout or the config layout before it)."""
        from repro_torch.api import Session
        from repro_torch.api.session import _load_checkpoint
        spec, step_count, arrays, legacy = _load_checkpoint(path)
        if spec.mode != "single":
            raise ValueError(
                f"{path} holds a {spec.mode!r} checkpoint; restore it "
                "with repro_torch.api.Session.restore")
        sim = cls.__new__(cls)
        sim.config = SimConfig(**legacy) if legacy is not None \
            else spec.sim_config()
        sim._session = Session._from_arrays(spec, arrays, step_count,
                                            device=device)
        return sim
