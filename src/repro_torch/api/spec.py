"""Typed, serializable run specification (counterpart of ``repro.api.spec``).

The same frozen dataclass tree and the same JSON document as the JAX
package: ``version``, ``lattice``, ``engine``, ``temperature``, ``seed``,
``sweep``, ``batch``, ``mesh``, serialized with ``sort_keys=True``, so a
spec written by either package reads in the other.  Engine names resolve
against this package's registry.  Dispatch is a function of the tree's
shape, as there: no ``batch`` and no ``mesh`` -- one run; a ``batch`` --
one ensemble over its members (counter-based engines only); a ``mesh``
-- a sharded run; both at once are refused.
"""
from __future__ import annotations

import dataclasses
import json
from typing import Any, Dict, Mapping, Optional, Tuple, Union

SPEC_VERSION = 1

#: ensemble seeds are uint32 Philox keys in the JAX package
MAX_BATCH_SEED = 2 ** 32


def _positive_int(v, name: str) -> int:
    if isinstance(v, bool) or not isinstance(v, int) or v <= 0:
        raise ValueError(f"{name} must be a positive int, got {v!r}")
    return v


def _unit_float(v, name: str) -> float:
    if isinstance(v, bool) or not isinstance(v, (int, float)) \
            or not 0.0 <= float(v) <= 1.0:
        raise ValueError(f"{name} must be a float in [0, 1], got {v!r}")
    return float(v)


#: validators of the engine params declared by ``Engine.param_fields``:
#: each maps a JSON value to the normalized value or raises ValueError
_PARAM_VALIDATORS = {
    "tc_block": lambda v: _positive_int(v, "tc_block"),
    "p_ferro": lambda v: _unit_float(v, "p_ferro"),
}


def _engine_cls(name: str):
    from repro_torch.core.engine import engine_class
    return engine_class(name)


def _check_keys(d: Mapping, allowed, what: str) -> None:
    """Reject unknown keys: a typo'd key must fail, not run another run."""
    unknown = sorted(set(d) - set(allowed))
    if unknown:
        raise ValueError(f"{what}: unknown key(s) {unknown}; "
                         f"allowed: {sorted(allowed)}")


@dataclasses.dataclass(frozen=True)
class LatticeSpec:
    """Lattice geometry and initialization (``init_p_up`` 0.5: hot
    random start; 1.0: ordered start)."""

    n: int = 512
    m: int = 512
    init_p_up: float = 0.5

    def __post_init__(self):
        if not (isinstance(self.n, int) and isinstance(self.m, int)) \
                or self.n <= 0 or self.m <= 0:
            raise ValueError(f"lattice dims must be positive ints, got "
                             f"({self.n!r}, {self.m!r})")
        if self.n % 2 or self.m % 2:
            raise ValueError(
                f"lattice dims must be even for the checkerboard "
                f"decomposition, got ({self.n}, {self.m})")
        if not 0.0 <= float(self.init_p_up) <= 1.0:
            raise ValueError(f"init_p_up must be in [0, 1], got "
                             f"{self.init_p_up!r}")
        object.__setattr__(self, "init_p_up", float(self.init_p_up))

    def to_dict(self) -> dict:
        return {"n": self.n, "m": self.m, "init_p_up": self.init_p_up}

    @classmethod
    def from_dict(cls, d: Mapping) -> "LatticeSpec":
        _check_keys(d, ("n", "m", "init_p_up"), "lattice spec")
        return cls(**dict(d))


@dataclasses.dataclass(frozen=True)
class EngineSpec:
    """Registry engine name + engine-specific params (normalized to a
    sorted tuple of pairs and checked against ``param_fields``)."""

    name: str = "multispin"
    params: Union[Mapping[str, Any], Tuple[Tuple[str, Any], ...]] = ()

    def __post_init__(self):
        cls = _engine_cls(self.name)
        raw = dict(self.params)
        unknown = sorted(set(raw) - set(cls.param_fields))
        if unknown:
            raise ValueError(
                f"engine {self.name!r} takes no params {unknown}; "
                f"declared param_fields: {list(cls.param_fields)}")
        norm = {k: _PARAM_VALIDATORS[k](v) if k in _PARAM_VALIDATORS
                else v for k, v in raw.items()}
        object.__setattr__(self, "params", tuple(sorted(norm.items())))

    @property
    def param_dict(self) -> Dict[str, Any]:
        return dict(self.params)

    @property
    def cls(self):
        return _engine_cls(self.name)

    def to_dict(self) -> dict:
        return {"name": self.name, "params": self.param_dict}

    @classmethod
    def from_dict(cls, d: Mapping) -> "EngineSpec":
        _check_keys(d, ("name", "params"), "engine spec")
        return cls(name=d["name"], params=d.get("params", {}))


@dataclasses.dataclass(frozen=True)
class SweepSpec:
    """Measurement schedule: ``thermalize`` sweeps, then ``n_measure``
    samples ``measure_every`` sweeps apart, recording ``fields``."""

    thermalize: int = 0
    measure_every: int = 1
    n_measure: int = 100
    fields: Tuple[str, ...] = ("m", "e")

    def __post_init__(self):
        if self.thermalize < 0 or self.measure_every <= 0 \
                or self.n_measure <= 0:
            raise ValueError(f"bad sweep schedule {self}")
        if not self.fields:
            raise ValueError("SweepSpec.fields needs at least one "
                             "observable field")
        object.__setattr__(self, "fields", tuple(self.fields))

    @property
    def total_sweeps(self) -> int:
        return self.thermalize + self.n_measure * self.measure_every

    def plan(self):
        """The :class:`repro_torch.analysis.MeasurementPlan`."""
        from repro_torch.analysis.measure import MeasurementPlan
        return MeasurementPlan(self.n_measure, self.measure_every,
                               self.thermalize, self.fields)

    def to_dict(self) -> dict:
        return {"thermalize": self.thermalize,
                "measure_every": self.measure_every,
                "n_measure": self.n_measure,
                "fields": list(self.fields)}

    @classmethod
    def from_dict(cls, d: Mapping) -> "SweepSpec":
        _check_keys(d, ("thermalize", "measure_every", "n_measure",
                        "fields"), "sweep spec")
        d = dict(d)
        d["fields"] = tuple(d.get("fields", ("m", "e")))
        return cls(**d)


@dataclasses.dataclass(frozen=True)
class BatchSpec:
    """The (temperature, seed) members of an ensemble: the zip of
    ``temperatures`` and ``seeds`` (default seeds 0, 1, ...), or with
    ``grid`` their cross product, temperature-major.  Seeds are uint32
    Philox keys, so a member's key lane 1 is 0."""

    temperatures: Tuple[float, ...] = ()
    seeds: Optional[Tuple[int, ...]] = None
    grid: bool = False

    def __post_init__(self):
        temps = tuple(float(t) for t in self.temperatures)
        if not temps:
            raise ValueError("BatchSpec needs at least one temperature")
        if any(t <= 0 for t in temps):
            raise ValueError(f"temperatures must be positive: {temps}")
        object.__setattr__(self, "temperatures", temps)
        seeds = self.seeds
        if seeds is not None:
            seeds = tuple(int(s) for s in seeds)
            bad = [s for s in seeds if not 0 <= s < MAX_BATCH_SEED]
            if bad:
                raise ValueError(f"ensemble seeds must be in [0, 2**32), "
                                 f"got {bad}")
            if not self.grid and len(seeds) != len(temps):
                raise ValueError(
                    f"zipped batch needs len(seeds) == len(temperatures); "
                    f"got {len(seeds)} vs {len(temps)}")
            if self.grid and not seeds:
                raise ValueError("grid batch needs at least one seed")
        object.__setattr__(self, "seeds", seeds)

    @property
    def members(self) -> Tuple[Tuple[float, int], ...]:
        """Expanded (temperature, seed) pairs, batch-axis order."""
        if self.grid:
            seeds = self.seeds or (0,)
            return tuple((t, s) for t in self.temperatures for s in seeds)
        seeds = self.seeds if self.seeds is not None \
            else tuple(range(len(self.temperatures)))
        return tuple(zip(self.temperatures, seeds))

    @property
    def size(self) -> int:
        return len(self.members)

    @property
    def member_temperatures(self) -> Tuple[float, ...]:
        return tuple(t for t, _ in self.members)

    @property
    def member_seeds(self) -> Tuple[int, ...]:
        return tuple(s for _, s in self.members)

    def to_dict(self) -> dict:
        return {"temperatures": list(self.temperatures),
                "seeds": None if self.seeds is None else list(self.seeds),
                "grid": self.grid}

    @classmethod
    def from_dict(cls, d: Mapping) -> "BatchSpec":
        _check_keys(d, ("temperatures", "seeds", "grid"), "batch spec")
        return cls(temperatures=tuple(d["temperatures"]),
                   seeds=None if d.get("seeds") is None
                   else tuple(d["seeds"]),
                   grid=bool(d.get("grid", False)))


@dataclasses.dataclass(frozen=True)
class MeshSpec:
    """The mesh of a sharded run: plane rows are cut over every axis but
    the last, plane columns over the last.  Shard ``i`` (row-major over
    the mesh) lives on the ``i % count``-th device, so several shards may
    share one (``repro_torch.launch.mesh``)."""

    shape: Tuple[int, ...] = (1, 1)
    axis_names: Tuple[str, ...] = ("data", "model")

    def __post_init__(self):
        shape = tuple(int(d) for d in self.shape)
        names = tuple(str(a) for a in self.axis_names)
        if len(shape) < 2 or any(d <= 0 for d in shape):
            raise ValueError(f"mesh shape needs >= 2 positive dims, got "
                             f"{shape}")
        if len(names) != len(shape):
            raise ValueError(f"mesh needs one axis name per dim: "
                             f"{shape} vs {names}")
        if len(set(names)) != len(names):
            raise ValueError(f"duplicate mesh axis names: {names}")
        object.__setattr__(self, "shape", shape)
        object.__setattr__(self, "axis_names", names)

    def to_dict(self) -> dict:
        return {"shape": list(self.shape),
                "axis_names": list(self.axis_names)}

    @classmethod
    def from_dict(cls, d: Mapping) -> "MeshSpec":
        _check_keys(d, ("shape", "axis_names"), "mesh spec")
        return cls(shape=tuple(d["shape"]),
                   axis_names=tuple(d["axis_names"]))


@dataclasses.dataclass(frozen=True)
class RunSpec:
    """The complete, serializable description of one run.

    ``temperature`` and ``seed`` drive single and sharded runs; an
    ensemble takes its members from ``batch`` (the scalar fields then
    describe member 0, which is also what its engine config carries)."""

    lattice: LatticeSpec = dataclasses.field(default_factory=LatticeSpec)
    engine: EngineSpec = dataclasses.field(default_factory=EngineSpec)
    temperature: float = 2.0
    seed: int = 1234
    sweep: Optional[SweepSpec] = None
    batch: Optional[BatchSpec] = None
    mesh: Optional[MeshSpec] = None

    def __post_init__(self):
        cls = self.engine.cls
        if float(self.temperature) <= 0:
            raise ValueError(f"temperature must be positive, got "
                             f"{self.temperature!r}")
        object.__setattr__(self, "temperature", float(self.temperature))
        if not 0 <= int(self.seed) < 2 ** 64:
            raise ValueError(f"seed must be a uint64, got {self.seed!r}")
        object.__setattr__(self, "seed", int(self.seed))
        if self.batch is not None and self.mesh is not None:
            raise ValueError(
                "batch + mesh in one RunSpec is not supported yet: "
                "run the ensemble per mesh shard or drop one of them")
        if self.batch is not None and not cls.counter_based:
            raise ValueError(
                f"engine {self.engine.name!r} is not counter-based; a "
                f"batched ensemble needs a Philox engine whose sweep_fn "
                f"is a pure function of (seed, offset) -- see DESIGN.md "
                f"S3/S4")
        if self.mesh is not None and cls.dist_factory is None:
            from repro_torch.core.engine import ENGINES
            have = sorted(n for n, c in ENGINES.items()
                          if c.dist_factory is not None)
            raise ValueError(
                f"engine {self.engine.name!r} has no distributed step "
                f"(dist_factory is None); mesh-capable engines: {have}")
        cls.validate_lattice(self.lattice.n, self.lattice.m,
                             **self.engine.param_dict)

    @property
    def mode(self) -> str:
        """"ensemble" with a batch, "sharded" with a mesh, else
        "single"."""
        if self.batch is not None:
            return "ensemble"
        return "single" if self.mesh is None else "sharded"

    def sim_config(self):
        """The equivalent :class:`repro_torch.core.sim.SimConfig` (for an
        ensemble: member 0's scalars)."""
        from repro_torch.core.sim import SimConfig
        temp, seed = self.temperature, self.seed
        if self.batch is not None:
            temp, seed = self.batch.members[0]
        return SimConfig(n=self.lattice.n, m=self.lattice.m,
                         temperature=temp, seed=seed,
                         engine=self.engine.name,
                         init_p_up=self.lattice.init_p_up,
                         **self.engine.param_dict)

    @classmethod
    def from_sim_config(cls, cfg, sweep: Optional[SweepSpec] = None,
                        batch: Optional[BatchSpec] = None,
                        mesh: Optional[MeshSpec] = None) -> "RunSpec":
        """Lift a legacy ``SimConfig`` into a spec.  Only the params the
        engine declares (``param_fields``) are carried; the other config
        knobs are defaults the engine ignores."""
        fields = _engine_cls(cfg.engine).param_fields
        params = {k: getattr(cfg, k) for k in fields}
        return cls(lattice=LatticeSpec(n=cfg.n, m=cfg.m,
                                       init_p_up=cfg.init_p_up),
                   engine=EngineSpec(name=cfg.engine, params=params),
                   temperature=cfg.temperature, seed=cfg.seed,
                   sweep=sweep, batch=batch, mesh=mesh)

    def to_dict(self) -> dict:
        return {
            "version": SPEC_VERSION,
            "lattice": self.lattice.to_dict(),
            "engine": self.engine.to_dict(),
            "temperature": self.temperature,
            "seed": self.seed,
            "sweep": None if self.sweep is None else self.sweep.to_dict(),
            "batch": None if self.batch is None else self.batch.to_dict(),
            "mesh": None if self.mesh is None else self.mesh.to_dict(),
        }

    def to_json(self, indent: Optional[int] = None) -> str:
        return json.dumps(self.to_dict(), indent=indent, sort_keys=True)

    @classmethod
    def from_dict(cls, d: Mapping) -> "RunSpec":
        _check_keys(d, ("version", "lattice", "engine", "temperature",
                        "seed", "sweep", "batch", "mesh"), "run spec")
        version = d.get("version", SPEC_VERSION)
        if version > SPEC_VERSION:
            raise ValueError(f"spec version {version} is newer than this "
                             f"release understands ({SPEC_VERSION})")
        return cls(
            lattice=LatticeSpec.from_dict(d.get("lattice", {})),
            engine=EngineSpec.from_dict(d["engine"])
            if "engine" in d else EngineSpec(),
            temperature=d.get("temperature", 2.0),
            seed=d.get("seed", 1234),
            sweep=None if d.get("sweep") is None
            else SweepSpec.from_dict(d["sweep"]),
            batch=None if d.get("batch") is None
            else BatchSpec.from_dict(d["batch"]),
            mesh=None if d.get("mesh") is None
            else MeshSpec.from_dict(d["mesh"]),
        )

    @classmethod
    def from_json(cls, s: str) -> "RunSpec":
        return cls.from_dict(json.loads(s))
