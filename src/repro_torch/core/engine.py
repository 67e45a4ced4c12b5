"""Engine registry: one protocol for the update algorithms of the port.

Counterpart of ``repro.core.engine``, as far as this slice of the port
goes: the registry, the ``Engine`` protocol, the counter-based
``CounterEngine`` with its two tiers, and the ``stencil_pallas`` engine,
registered under the JAX package's name so that a JAX checkpoint's spec
resolves here.  Any other name raises and lists what is ported.

Protocol:

* ``init_state()``            -- fresh engine-native state on the device;
* ``sweeps(state, n, step)``  -- advance ``n`` full sweeps at the
                                 config's own temperature and seed;
* ``scan_step(state, inv_temp, seed, step_count, n)`` -- the same with
  explicit arguments; ``measure_scan`` chains it;
* ``full_lattice``, ``magnetization``, ``energy``, ``observables``;
* ``state_arrays`` / ``from_arrays`` -- named host numpy arrays, the
  checkpoint layout the JAX package uses.

Counter-based engines draw from Philox addressed by (seed, half-sweep
offset, site), so a run continues its stream bit for bit from any
``step_count``, and both tiers of ``sweep_fn`` draw the same stream.
"""
from __future__ import annotations

from typing import ClassVar, Dict, Optional, Type

import torch

from repro_torch import convert

from . import lattice as lat
from . import metropolis as metro
from . import observables as obs
from . import rng

ENGINES: Dict[str, Type["Engine"]] = {}


def register(cls: Type["Engine"]) -> Type["Engine"]:
    """Class decorator: add an engine to the registry under ``cls.name``."""
    if cls.name in ENGINES:
        raise ValueError(f"duplicate engine {cls.name!r}")
    ENGINES[cls.name] = cls
    return cls


def engine_class(name: str) -> Type["Engine"]:
    """The registered engine class called ``name``."""
    try:
        return ENGINES[name]
    except KeyError:
        raise ValueError(
            f"engine {name!r} is not ported to repro_torch; ported "
            f"engines: {sorted(ENGINES)}") from None


def make_engine(config, device,
                resident_budget_bytes: Optional[int] = None) -> "Engine":
    """Instantiate the engine named by ``config.engine`` on ``device``.
    ``resident_budget_bytes`` is the k-sweep planner's shared-memory
    budget (``None``: the card's); 0 sends the run through the
    per-half-sweep tier."""
    return engine_class(config.engine)(
        config, torch.device(device),
        resident_budget_bytes=resident_budget_bytes)


class Engine:
    """Base class: holds the config and the device, defines the protocol."""

    name: ClassVar[str]
    #: engine-specific config knobs (``EngineSpec.params`` is checked
    #: against them)
    param_fields: ClassVar[tuple] = ()
    #: keys of :meth:`observables`
    observable_fields: ClassVar[tuple] = ("m", "e")

    @classmethod
    def validate_lattice(cls, n: int, m: int) -> None:
        if n % 2 or m % 2:
            raise ValueError(
                f"engine {cls.name!r} needs even lattice dims for the "
                f"checkerboard decomposition, got ({n}, {m})")

    def __init__(self, config, device: torch.device):
        self.cfg = config
        self.device = device

    def init_state(self):
        raise NotImplementedError

    def full_lattice(self, state) -> torch.Tensor:
        raise NotImplementedError

    def magnetization(self, state) -> torch.Tensor:
        raise NotImplementedError

    def energy(self, state) -> torch.Tensor:
        return self.observables(state, self.cfg.inv_temp)["e"]

    def observables(self, state, inv_temp) -> dict:
        """``{"m": mean spin, "e": energy per spin}`` as 0-d float32
        tensors on the device."""
        raise NotImplementedError

    def sweeps(self, state, n_sweeps: int, step_count: int):
        """``scan_step`` at the config's own temperature and seed."""
        return self.scan_step(state, self.cfg.inv_temp, self.cfg.seed,
                              step_count, n_sweeps)

    def scan_step(self, state, inv_temp, seed, step_count, n_sweeps: int):
        raise NotImplementedError

    def state_arrays(self, state) -> dict:
        raise NotImplementedError

    def from_arrays(self, arrays: dict):
        raise NotImplementedError


class CounterEngine(Engine):
    """Counter-based (Philox skip-ahead) engines, with two tiers.

    Subclasses implement ``color_update`` (one half-sweep) and, where a
    k-sweep kernel exists, ``resident_sweeps``.  At construction the
    planner (``repro_torch.kernels.resident``) decides whether this
    lattice runs k sweeps per launch; ``sweep_fn`` then routes every
    block of sweeps through it, or else through the per-half-sweep loop.
    Both tiers use the counter layout of ``rng.half_sweep_offset``, so
    which one ran cannot be seen in the trajectory.
    """

    #: planner family of the k-sweep tier; ``None``: no k-sweep kernel
    resident_family: ClassVar[Optional[str]] = None

    def __init__(self, config, device: torch.device,
                 resident_budget_bytes: Optional[int] = None):
        super().__init__(config, device)
        self.resident_plan = None
        if self.resident_family is not None:
            from repro_torch.kernels.resident import plan_resident
            self.resident_plan = plan_resident(
                self.resident_family, config.n, config.m,
                budget_bytes=resident_budget_bytes)

    def color_update(self, target, op, table, is_black, seed, offset):
        """One half-sweep of ``target`` against ``op``."""
        raise NotImplementedError

    def resident_sweeps(self, state, table, seed, start_offset,
                        n_sweeps: int):
        """``n_sweeps`` full sweeps through the k-sweep kernel tier."""
        raise NotImplementedError

    def sweep_context(self, inv_temp) -> torch.Tensor:
        """The acceptance table, computed once per call on the host."""
        return metro.acceptance_table(inv_temp)

    def sweep_fn(self, state, inv_temp, seed, start_offset, n_sweeps: int):
        """``n_sweeps`` x (black, white) half-sweeps at offsets
        ``half_sweep_offset(start_offset, i, colour)``."""
        table = self.sweep_context(inv_temp)
        if self.resident_plan is not None and n_sweeps > 0:
            return tuple(self.resident_sweeps(state, table, seed,
                                              start_offset, n_sweeps))
        b, w = state
        for i in range(n_sweeps):
            b = self.color_update(b, w, table, True, seed,
                                  rng.half_sweep_offset(start_offset, i, 0))
            w = self.color_update(w, b, table, False, seed,
                                  rng.half_sweep_offset(start_offset, i, 1))
        return (b, w)

    def scan_step(self, state, inv_temp, seed, step_count, n_sweeps: int):
        # one half-sweep offset per colour: cumulative offset = 2 * sweeps
        return self.sweep_fn(state, inv_temp, seed,
                             (2 * int(step_count)) & rng.MASK32, n_sweeps)


class _PlanesEngine(Engine):
    """(black, white) int8 compact-plane state."""

    def init_state(self):
        cfg = self.cfg
        return lat.init_planes(cfg.n, cfg.m, cfg.init_p_up, cfg.seed,
                               self.device)

    def full_lattice(self, state) -> torch.Tensor:
        return lat.merge_checkerboard(*state)

    def magnetization(self, state) -> torch.Tensor:
        return obs.magnetization(*state)

    def observables(self, state, inv_temp) -> dict:
        return {"m": obs.magnetization(*state),
                "e": obs.energy_per_spin(*state)}

    def state_arrays(self, state) -> dict:
        return convert.state_to_reference(state)

    def from_arrays(self, arrays: dict):
        black, white = convert.state_from_reference(arrays, self.device)
        want = (self.cfg.n, self.cfg.m // 2)
        if tuple(black.shape) != want:
            raise ValueError(f"state planes are {tuple(black.shape)}, the "
                             f"{self.cfg.n}x{self.cfg.m} lattice needs {want}")
        return black, white


@register
class StencilPallasEngine(_PlanesEngine, CounterEngine):
    """The stencil kernel pair (paper S3.1): ``stencil_update`` per
    half-sweep, ``stencil_sweeps_resident`` for k sweeps per launch.

    Keeps the JAX package's engine name.  Philox is keyed on the global
    (row, col) index, so both tiers give one trajectory, and it is the
    JAX engine's bit for bit from the same state wherever the two
    acceptance tables decide flips alike (``metropolis.acceptance_table``).
    The half-sweep tier updates the state planes in place.
    """

    name = "stencil_pallas"
    resident_family = "stencil"

    def color_update(self, target, op, table, is_black, seed, offset):
        from repro_torch.kernels.stencil import stencil_update
        return stencil_update(target, op, table, is_black=is_black,
                              seed=seed, offset=offset)

    def resident_sweeps(self, state, table, seed, start_offset, n_sweeps):
        from repro_torch.kernels.stencil import stencil_sweeps_resident
        return stencil_sweeps_resident(*state, table, n_sweeps=n_sweeps,
                                       seed=seed, start_offset=start_offset,
                                       plan=self.resident_plan)
