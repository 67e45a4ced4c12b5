"""Ensemble: the JAX package's compatibility shim over ``Session``.

Counterpart of ``repro.core.ensemble``: a batch of independent lattices,
one (temperature, seed) each, as a ``RunSpec`` with a ``BatchSpec`` run
by ``Session``'s ensemble runner.  New code builds the ``RunSpec``
itself.  As there, seeds of 2^32 or more raise (a member's Philox key is
one uint32 lane), member 0's temperature and seed reach the engine
config, and ``tc_block``/``p_ferro`` reach only an engine that declares
them in ``param_fields`` (no counter-based engine does).  The entry
points run on the CUDA card unless ``device="cpu"`` is given.
"""
from __future__ import annotations

from typing import Optional, Sequence

import numpy as np


class Ensemble:
    """A batch of independent lattices, one (temperature, seed) each.

    Member ``i`` follows exactly the trajectory of the single-mode
    session of ``temperature=temps[i], seed=seeds[i]``.
    """

    def __init__(self, n: int, m: int, temperatures: Sequence[float],
                 seeds: Optional[Sequence[int]] = None,
                 engine: str = "multispin", init_p_up: float = 0.5,
                 tc_block: int = 128, p_ferro: float = 0.5, device=None):
        from repro_torch.api import (BatchSpec, EngineSpec, LatticeSpec,
                                     RunSpec, Session)
        temps = np.asarray(temperatures, np.float32)
        if temps.ndim != 1 or temps.size == 0:
            raise ValueError(f"need a 1-D temp batch, got shape "
                             f"{temps.shape}")
        if seeds is not None:
            seeds_arr = np.asarray(seeds)
            if seeds_arr.shape != temps.shape:
                raise ValueError(f"seeds/temps shape mismatch: "
                                 f"{seeds_arr.shape} vs {temps.shape}")
            seeds = tuple(int(s) for s in seeds_arr.tolist())
        params = {k: v for k, v in
                  (("tc_block", tc_block), ("p_ferro", p_ferro))
                  if k in _param_fields(engine)}
        spec = RunSpec(
            lattice=LatticeSpec(n=n, m=m, init_p_up=init_p_up),
            engine=EngineSpec(name=engine, params=params),
            batch=BatchSpec(
                temperatures=tuple(
                    float(t) for t in np.asarray(temperatures).tolist()),
                seeds=seeds))
        self._session = Session.open(spec, device=device)
        self.config = self._session._runner.cfg
        self.temperatures = self._session._runner.temperatures

    @property
    def engine(self):
        return self._session._runner.engine

    @property
    def states(self):
        return self._session.state

    @states.setter
    def states(self, v):
        self._session.state = v

    @property
    def inv_temps(self):
        return self._session._runner.inv_temps

    @property
    def seeds(self):
        return self._session._runner.seeds

    @property
    def step_count(self) -> int:
        return self._session.step_count

    @step_count.setter
    def step_count(self, v: int) -> None:
        self._session.step_count = v

    @property
    def size(self) -> int:
        return self._session._runner.size

    def run(self, n_sweeps: int) -> np.ndarray:
        """Advance every member ``n_sweeps`` sweeps; returns the (B,)
        per-member magnetizations after them."""
        return self._session.run(n_sweeps)

    def magnetizations(self) -> np.ndarray:
        """(B,) per-member magnetization of the current states."""
        return self._session.magnetization()

    def full_lattices(self):
        """(B, N, M) stacked +-1 lattices (measurement and debug view)."""
        return self._session.full_lattice()

    def measure(self, plan) -> dict:
        """Run a ``MeasurementPlan`` on every member; returns ``{field:
        (n_measure, B) float32 ndarray}``."""
        return self._session.measure(plan)

    def trajectory(self, n_measure: int, sweeps_between: int,
                   thermalize: int = 0) -> np.ndarray:
        """(n_measure, B) magnetization samples along the trajectory."""
        return self._session.trajectory(n_measure, sweeps_between,
                                        thermalize)

    def save(self, path: str) -> None:
        """Atomic checkpoint of every member's state, the step count and
        the spec (the ``Session`` layout, restorable by either
        package)."""
        self._session.save(path)

    @classmethod
    def restore(cls, path: str, device=None) -> "Ensemble":
        from repro_torch.api import Session
        session = Session.restore(path, device=device)
        if session.mode != "ensemble":
            raise ValueError(
                f"{path} holds a {session.mode!r} checkpoint; restore it "
                "with repro_torch.api.Session")
        ens = cls.__new__(cls)
        ens._session = session
        ens.config = session._runner.cfg
        ens.temperatures = session._runner.temperatures
        return ens


def _param_fields(engine: str):
    from .engine import ENGINES
    cls = ENGINES.get(engine)
    return cls.param_fields if cls is not None else ()
