"""Session: open, run, measure, save, restore and digest a run.

Counterpart of ``repro.api.session``.  ``Session.open(spec)`` builds
the runner the spec's shape asks for:

* single   -- the registry engine advanced in place;
* ensemble -- a ``BatchSpec``'s (temperature, seed) members, stacked
              ``(B, n, w)`` planes advanced together (``_EnsembleRunner``):
              each block of sweeps one launch of the kernel's member
              axis for all members, member i on the trajectory of the
              single-mode run of its own (temperature, seed);
* sharded  -- a ``MeshSpec`` mesh of shards (``_ShardedRunner``): the
              sharded resident tier (``repro_torch.dist``) where the
              shard planner fits the engine's ``shard_family``, else the
              per-half-sweep step named by its ``dist_factory``
              (``repro_torch.core.distributed``).

The checkpoint is the JAX package's layout -- an atomically renamed
``.npz`` with ``spec_json``, ``step_count`` and ``state_<name>`` arrays
(the whole planes in single and sharded mode, batched along axis 0 for
an ensemble) -- and ``state_digest`` frames the state as the JAX package
does, so a run saved by either package restores in the other, on any
mesh or none, and the digests of equal states are equal.

The entry points run on CUDA unless the caller passes ``device="cpu"``;
with no device named and no GPU present they raise.  They never move to
the CPU on their own.

Telemetry and recovery are the JAX package's: every runner's ``run`` is
one dispatch through ``resilience.degrade.run_dispatch`` (counted in the
canonical counters, a ``dispatch`` span when tracing is on, retried or
demoted on the failures that allow it); the session adds the
``session.open``, ``session.run``, ``session.measure``, ``ckpt.save``
and ``ckpt.restore`` spans, the ``spec.validate`` span with its
``planner.decide`` and ``planner.decide_shard`` instants in
:func:`describe`, and the ``rolling_flips_per_ns`` gauge of traced runs.
A sharded run's halo exchanges go into the ``halo_exchanges`` and
``halo_bytes`` counters as well as ``Session.halo_exchanges``.
"""
from __future__ import annotations

import dataclasses
import os
import tempfile

import numpy as np
import torch

import repro_torch.telemetry as tel
from repro_torch import convert
from repro_torch.core import distributed as dist
from repro_torch.core import rng
from repro_torch.core.engine import engine_class, make_engine
from repro_torch.resilience import degrade, integrity

from .spec import RunSpec

#: default of ``Session.restore(mesh=...)``: keep the checkpoint's mesh
_KEEP = object()


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


def _read_spec(z, path: str) -> RunSpec:
    if "spec_json" not in z.files:
        raise ValueError(f"{path}: not a checkpoint in the RunSpec "
                         f"layout (no 'spec_json')")
    return RunSpec.from_json(str(z["spec_json"]))


def load_spec(path: str) -> RunSpec:
    """The spec of a checkpoint of either package, and nothing else: the
    state arrays stay on disk (an ``.npz`` reads an entry when asked)."""
    with np.load(path, allow_pickle=False) as z:
        return _read_spec(z, path)


def _load_checkpoint(path: str):
    """Read a checkpoint: ``(spec, step_count, state arrays)``."""
    with np.load(path, allow_pickle=False) as z:
        spec = _read_spec(z, path)
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


class _EnsembleRunner:
    """A (temperature, seed) batch advanced together: the counterpart of
    the JAX package's vmapped ``_EnsembleRunner``.

    Member ``i`` follows exactly the trajectory of the single-mode spec
    with ``temperature=members[i][0], seed=members[i][1]``: the same
    Philox stream from the same offset, its own table and keys; the
    plan of the k-sweep tier depends on the lattice alone, so every
    member runs on the single-mode tier.  ``BatchSpec`` keeps seeds below
    2^32 (key lane 1 is 0).
    """

    def __init__(self, spec: RunSpec, device: torch.device, state=None,
                 step_count: int = 0, resident_budget_bytes=None):
        self.spec = spec
        self.cfg = spec.sim_config()
        self.engine = make_engine(self.cfg, device, resident_budget_bytes)
        self.step_count = step_count
        self._set_members(spec)
        self.state = self._fresh_states() if state is None else state

    def _set_members(self, spec: RunSpec) -> None:
        temps = spec.batch.member_temperatures
        self.temperatures = np.asarray(temps, np.float32)
        # inverted in Python-float precision as SimConfig.inv_temp is, so
        # that a member's table is its single-mode run's
        self.inv_temps = [1.0 / float(t) for t in temps]
        self.seeds = [int(s) for s in spec.batch.member_seeds]

    def _fresh_states(self):
        return self.engine.init_states(self.seeds)

    def rebind(self, spec: RunSpec) -> None:
        """Re-point this runner at a new (temperature, seed) batch of the
        same shape (engine and params, lattice, batch size): the same
        engine object and plan, no new build or load of a library; fresh
        states at step 0."""
        if spec.mode != "ensemble":
            raise ValueError(
                f"rebind needs an ensemble spec, got mode={spec.mode!r}")
        old, new = self.spec, spec
        same = (old.engine.to_dict() == new.engine.to_dict()
                and old.lattice.to_dict() == new.lattice.to_dict()
                and old.batch.size == new.batch.size)
        if not same:
            raise ValueError(
                f"rebind shape mismatch: cached runner is "
                f"{old.engine.name}/{old.lattice.n}x{old.lattice.m}/"
                f"B{old.batch.size}, spec wants "
                f"{new.engine.name}/{new.lattice.n}x{new.lattice.m}/"
                f"B{new.batch.size}")
        self.spec = spec
        self._set_members(spec)
        self.state = self._fresh_states()
        self.step_count = 0

    @property
    def size(self) -> int:
        return int(self.temperatures.size)

    def run(self, n_sweeps: int) -> np.ndarray:
        """Advance every member, as one dispatch through
        ``degrade.run_dispatch``; returns the (B,) per-member
        magnetizations (at fixed seeds: the magnetization-vs-temperature
        curve)."""
        engine = self.engine

        def attempt():
            with engine._dispatch(n_sweeps, batch=self.size,
                                  **engine.resident_attrs) as sp:
                out = engine.sweep_fn_batched(
                    self.state, self.inv_temps, self.seeds,
                    (2 * self.step_count) & rng.MASK32, n_sweeps)
                sp.fence(out)
            return out

        self.state = degrade.run_dispatch(attempt, engine=engine)
        self.step_count += n_sweeps
        return self.magnetization()

    def measure(self, plan) -> dict:
        from repro_torch.analysis.measure import measure_scan_batched
        self.state, traj, self.step_count = measure_scan_batched(
            self.engine, self.state, self.inv_temps, self.seeds, plan,
            step_count=self.step_count)
        return traj

    def magnetization(self) -> np.ndarray:
        """(B,) float32: each member's magnetization."""
        return self.engine.magnetizations(self.state).cpu().numpy()

    def full_lattice(self) -> torch.Tensor:
        """(B, N, M): each member's lattice (measurement and debug
        view)."""
        return self.engine.full_lattices(self.state)

    def state_arrays(self) -> dict:
        """The engine's named arrays with the batch axis leading: the
        names of a single checkpoint, one rank higher."""
        return self.engine.state_arrays(self.state)

    def load_arrays(self, arrays: dict) -> None:
        self.state = self.engine.from_arrays(arrays, members=self.size)


#: ``Engine.dist_factory`` -> the ``repro_torch.core.distributed``
#: factory of the per-half-sweep tier
_DIST_FACTORIES = {
    "basic": dist.make_ising_step,
    "packed": dist.make_packed_ising_step,
    "bitplane": dist.make_bitplane_ising_step,
}


class _ShardedRunner:
    """A ``MeshSpec`` run: the sharded resident tier
    (``repro_torch.dist``) where the shard planner fits the engine's
    ``shard_family``, else the per-half-sweep step of its
    ``dist_factory``.

    The state is a pair of lists of shards, shard ``i`` (row-major over
    the mesh) on ``mesh.device_of(i)``; each shard makes its own part of
    a fresh lattice.  The draws are keyed on global positions on both
    tiers, so the trajectory is the single-device engine's on any mesh,
    and a demotion (``_on_demote``) drops the shard plan for the
    per-half-sweep step without forking it.  ``halo_exchanges`` counts
    exchange events as the JAX package's telemetry does: one per block
    of k sweeps on the resident tier, one per half-sweep on the other;
    :meth:`_record_halo` adds them and their bytes to the telemetry
    counters too.
    """

    def __init__(self, spec: RunSpec, device=None, state=None,
                 step_count: int = 0, resident_budget_bytes=None):
        from repro_torch.dist import make_resident_step, plan_shard_resident
        from repro_torch.launch.mesh import make_mesh
        self.spec = spec
        self.cfg = spec.sim_config()
        self.mesh = make_mesh(spec.mesh.shape, spec.mesh.axis_names, device)
        self.engine = make_engine(self.cfg, self.mesh.devices[0])
        eng, cfg = self.engine, self.cfg
        self.grid = dist.ShardGrid.of(self.mesh, cfg.n,
                                      cfg.m // eng.col_divisor)
        self._budget = resident_budget_bytes
        self.plan = None
        if eng.shard_family is not None:
            self.plan = plan_shard_resident(
                eng.shard_family, cfg.n, cfg.m, self.grid.rows_devs,
                self.grid.cols_devs, budget_bytes=resident_budget_bytes)
        self._dist_attrs = self._decision()
        if self.plan is not None:
            self._step = make_resident_step(self.mesh, self.plan,
                                            seed=cfg.seed)
            self._offset_scale = 2
        else:
            self._use_half_sweeps()
        self.halo_exchanges = 0
        self.step_count = step_count
        self.state = self._fresh_state() if state is None else state

    def _fresh_state(self):
        grid, d = self.grid, self.engine.col_divisor
        black, white = [], []
        for i in range(self.mesh.size):
            r0, c0 = grid.origin(i)
            b, w = self.engine.init_block(
                (r0, r0 + grid.n_loc), (c0 * d, (c0 + grid.w_loc) * d),
                self.mesh.device_of(i))
            black.append(b)
            white.append(w)
        return black, white

    def _use_half_sweeps(self) -> None:
        """Step with the per-half-sweep distributed factory of the
        engine's ``dist_factory``."""
        cfg, eng = self.cfg, self.engine
        self._step = _DIST_FACTORIES[eng.dist_factory](
            self.mesh, n=cfg.n, m=cfg.m, seed=cfg.seed)
        # the basic step takes its start in sweep units, the others in
        # half-sweep units (as in the JAX package)
        self._offset_scale = 1 if eng.dist_factory == "basic" else 2

    def _decision(self) -> dict:
        """The shard planner's decision as span attributes."""
        fam = self.engine.shard_family
        if fam is None:
            return {}
        from repro_torch.dist import shard_decision_attrs
        return shard_decision_attrs(fam, self.cfg.n, self.cfg.m,
                                    self.grid.rows_devs,
                                    self.grid.cols_devs,
                                    budget_bytes=self._budget)

    def _on_demote(self) -> None:
        """A demotion (``degrade.run_dispatch``): drop to the
        per-half-sweep distributed step -- the same trajectory, by the
        shared global-position keying -- and refresh the span attributes
        so that traces show the fallback and its reason."""
        if self.plan is not None:
            self.plan = None
            self._use_half_sweeps()
            self._dist_attrs = self._decision()

    def _record_halo(self, n_sweeps: int) -> int:
        """Count this dispatch's halo exchanges, here and in the telemetry
        counters with the JAX package's byte count; returns the events."""
        if self.plan is not None:
            ex = self.plan.exchanges(n_sweeps)
            per_event = self.plan.halo_bytes_per_exchange
        else:
            # one event a half-sweep, four 1-wide strips of the
            # opposite-colour plane a shard (the JAX package's count)
            grid = self.grid
            cell = np.dtype(self.engine.plane_dtype).itemsize
            ex = 2 * n_sweeps
            per_event = (2 * grid.n_loc + 2 * grid.w_loc) * cell \
                * self.mesh.size
        self.halo_exchanges += ex
        tel.record_halo_exchange(ex, ex * per_event)
        return ex

    def run(self, n_sweeps: int) -> None:
        """Advance every shard, as one dispatch through
        ``degrade.run_dispatch``."""
        def attempt():
            with self.engine._dispatch(
                    n_sweeps, mesh=list(self.spec.mesh.shape),
                    **self._dist_attrs) as sp:
                state = self.state
                if n_sweeps > 0:
                    table = self.engine.sweep_context(self.cfg.inv_temp)
                    start = (self._offset_scale * self.step_count) \
                        & rng.MASK32
                    state = self._step(*state, table, start, n_sweeps)
                sp.set(halo_exchanges=self._record_halo(n_sweeps))
                sp.fence(state)
            return state

        self.state = degrade.run_dispatch(attempt, engine=self.engine,
                                          on_demote=self._on_demote)
        self.step_count += n_sweeps

    def observables(self, fields=("m", "e")) -> dict:
        return dist.shard_observables(self.engine.dist_factory, self.grid,
                                      *self.state, fields)

    def measure(self, plan) -> dict:
        """Per-sample, as in the JAX package: thermalize, then
        ``n_measure`` rounds of (run; observe)."""
        missing = set(plan.fields) - set(self.engine.observable_fields)
        if missing:
            raise ValueError(f"plan fields {sorted(missing)} not in engine "
                             f"{self.engine.name!r} observables")
        if plan.thermalize:
            self.run(plan.thermalize)
        samples = []
        for _ in range(plan.n_measure):
            self.run(plan.sweeps_between)
            samples.append(self.observables(plan.fields))
        return {k: torch.stack([s[k] for s in samples]).cpu().numpy()
                .astype(np.float32) for k in plan.fields}

    def magnetization(self) -> float:
        return _replica_mean(dist.magnetization_dist(
            self.engine.dist_factory, *self.state))

    def energy(self) -> float:
        return _replica_mean(self.observables(("e",))["e"])

    def full_lattice(self) -> torch.Tensor:
        """The whole state gathered on shard 0's device, as the engine's
        ``full_lattice``."""
        return self.engine.full_lattice(
            tuple(self.grid.gather(p) for p in self.state))

    def state_arrays(self) -> dict:
        """The whole planes as host numpy arrays (the single-mode
        layout), gathered a shard at a time."""
        grid, eng = self.grid, self.engine
        out = {k: np.empty((grid.n, grid.width), eng.plane_dtype)
               for k in eng.plane_keys}
        for i, (b, w) in enumerate(zip(*self.state)):
            r0, c0 = grid.origin(i)
            for k, a in eng.state_arrays((b, w)).items():
                out[k][r0:r0 + grid.n_loc, c0:c0 + grid.w_loc] = a
        return out

    def load_arrays(self, arrays: dict) -> None:
        grid, eng = self.grid, self.engine
        for k in eng.plane_keys:
            shape = np.shape(arrays.get(k))
            if shape != (grid.n, grid.width):
                raise ValueError(f"state plane {k!r} is {shape}, the "
                                 f"{self.cfg.n}x{self.cfg.m} lattice needs "
                                 f"{(grid.n, grid.width)}")
        black, white = [], []
        for i in range(self.mesh.size):
            r0, c0 = grid.origin(i)
            block = {k: np.asarray(arrays[k])[r0:r0 + grid.n_loc,
                                              c0:c0 + grid.w_loc]
                     for k in eng.plane_keys}
            b, w = convert.state_from_reference(
                block, self.mesh.device_of(i), eng.plane_keys,
                eng.plane_dtype)
            black.append(b)
            white.append(w)
        self.state = (black, white)


def _replica_mean(value: torch.Tensor) -> float:
    """A 0-d value, or the mean of per-replica values as the bitplane
    engines take it (float64, rounded once to float32)."""
    return float(value.to(torch.float64).mean().to(torch.float32)
                 if value.numel() > 1 else value)


def describe(spec: RunSpec) -> dict:
    """The validated dispatch plan of ``spec`` as one dict, with no
    device work and no card needed: what ``python -m repro_torch run
    --dry-run`` prints.  The keys are the JAX package's ``describe``'s;
    ``"resident"`` is the k-sweep planner's decision for the lattice
    (``kernels.resident.decision_attrs``) and ``"dist"``, for a mesh
    spec, the shard planner's (``dist.planner.shard_decision_attrs``)."""
    cls = engine_class(spec.engine.name)
    resident = None
    dist_plan = None
    with tel.span("spec.validate", mode=spec.mode, engine=spec.engine.name,
                  lattice=(spec.lattice.n, spec.lattice.m)):
        if cls.resident_family is not None:
            from repro_torch.kernels.resident import decision_attrs
            # the one rendering of the decision: the --dry-run output and
            # the planner.decide and dispatch attributes
            resident = decision_attrs(cls.resident_family, spec.lattice.n,
                                      spec.lattice.m)
            tel.instant("planner.decide", **resident)
        if spec.mesh is not None:
            dist_plan = _shard_decision(cls, spec)
            if cls.shard_family is not None:
                tel.instant("planner.decide_shard", **dist_plan)
    out = {
        "mode": spec.mode,
        "engine": spec.engine.name,
        "engine_params": spec.engine.param_dict,
        "counter_based": cls.counter_based,
        "replicas": cls.replicas,
        "dist_factory": cls.dist_factory,
        "resident": resident,
        "dist": dist_plan,
        "lattice": [spec.lattice.n, spec.lattice.m],
        "init_p_up": spec.lattice.init_p_up,
        "batch_size": 1 if spec.batch is None else spec.batch.size,
        "mesh": None if spec.mesh is None else spec.mesh.to_dict(),
        "total_sweeps": None if spec.sweep is None
        else spec.sweep.total_sweeps,
        "spec": spec.to_dict(),
    }
    if spec.batch is not None:
        out["members"] = [list(p) for p in spec.batch.members]
    return out


def _shard_decision(cls, spec: RunSpec) -> dict:
    """The sharded tier of ``spec``'s mesh: rows over every mesh axis but
    the last, columns over the last (``ShardGrid.of``'s default)."""
    from repro_torch.dist.planner import (SMEM_BUDGET_BYTES,
                                          shard_decision_attrs)
    rows_devs = int(np.prod(spec.mesh.shape[:-1], dtype=np.int64))
    cols_devs = spec.mesh.shape[-1]
    if cls.shard_family is not None:
        return shard_decision_attrs(cls.shard_family, spec.lattice.n,
                                    spec.lattice.m, rows_devs, cols_devs)
    return {"family": None, "grid": f"{rows_devs}x{cols_devs}",
            "sharded_resident": False, "budget_bytes": SMEM_BUDGET_BYTES,
            "reason": f"engine {spec.engine.name!r} has no sharded "
                      f"resident tier: per-half-sweep distributed step "
                      f"{cls.dist_factory!r}"}


def _runner(spec: RunSpec, device, *, state=None, step_count: int = 0,
            resident_budget_bytes=None):
    """The runner of ``spec``'s mode."""
    if spec.mode == "sharded":
        return _ShardedRunner(spec, device, state, step_count,
                              resident_budget_bytes)
    cls = _EnsembleRunner if spec.mode == "ensemble" else _SingleRunner
    return cls(spec, resolve_device(device), state, step_count,
               resident_budget_bytes)


class Session:
    """Open a spec, run it, measure it, checkpoint it: single, ensemble
    or sharded mode.  ``run``, ``measure``, ``magnetization`` and
    ``full_lattice`` return single values in single and sharded mode and
    values with a batch axis in ensemble mode (``run`` then returns the
    (B,) per-member magnetizations)."""

    def __init__(self, spec: RunSpec, runner):
        self.spec = spec
        self._runner = runner

    @classmethod
    def open(cls, spec: RunSpec, device=None, *,
             resident_budget_bytes=None) -> "Session":
        """A fresh run of ``spec`` on ``device`` (default: the CUDA card;
        a sharded spec spreads its shards over every card; an ensemble
        spec holds its members on the one device).
        ``resident_budget_bytes`` overrides the k-sweep planner's (or, in
        sharded mode, the shard planner's) shared memory budget per block
        (0: the per-half-sweep tier)."""
        with tel.span("session.open", mode=spec.mode,
                      engine=spec.engine.name,
                      lattice=(spec.lattice.n, spec.lattice.m),
                      batch=1 if spec.batch is None
                      else spec.batch.size) as sp:
            runner = _runner(spec, device,
                             resident_budget_bytes=resident_budget_bytes)
            sp.fence(runner.state)
        return cls(spec, runner)

    @property
    def mode(self) -> str:
        """"single", "ensemble" or "sharded"."""
        return self.spec.mode

    @property
    def engine(self):
        return self._runner.engine

    @property
    def device(self) -> torch.device:
        """The device of the state (sharded mode: of shard 0)."""
        return self._runner.engine.device

    @property
    def shard_plan(self):
        """The sharded resident tier's ``ShardPlan``, or ``None`` (single
        mode, or the per-half-sweep distributed tier)."""
        return getattr(self._runner, "plan", None)

    @property
    def halo_exchanges(self) -> int:
        """Halo exchange events of a sharded session so far (0 in single
        mode)."""
        return getattr(self._runner, "halo_exchanges", 0)

    @property
    def state(self):
        """The engine-native state, a pair of (black, white) planes:
        ``basic``, ``basic_philox``, ``stencil_pallas``: int8 +-1 planes
        ``(n, m/2)``;
        ``multispin``/``multispin_pallas``: int32 tensors ``(n, m/16)``
        holding uint32 words of 8 nibble spins (``black_words``,
        ``white_words`` in a checkpoint); ``bitplane``/
        ``bitplane_pallas``: int32 tensors ``(n, m/2)`` holding uint32
        words whose bit r is replica r (``black_bits``, ``white_bits``);
        ``tensorcore``: a dict of four int8 sublattice planes ``'00'``,
        ``'01'``, ``'10'``, ``'11'`` of ``(n/2, m/2)`` (``plane_XX``);
        ``wolff``: the int8 ``(n, m)`` lattice (``lattice``);
        ``spinglass``: ``(lattice, j_up, j_left)``, the lattice and its
        int8 +-1 couplings.
        In ensemble mode each plane has the batch axis leading, ``(B, n,
        w)``, member i at index i.  In sharded mode each plane is a list
        of its shards, shard ``i`` at position ``i`` of the mesh in
        row-major order."""
        return self._runner.state

    @state.setter
    def state(self, value) -> None:
        self._runner.state = value

    @property
    def step_count(self) -> int:
        return self._runner.step_count

    @step_count.setter
    def step_count(self, value: int) -> None:
        self._runner.step_count = value

    def _flip_rate(self, n_sweeps: int, duration_ns) -> None:
        """Update the ``rolling_flips_per_ns`` gauge from a fenced span's
        duration (only when tracing is on: otherwise there is no honest
        device-complete duration to divide by)."""
        if not duration_ns:
            return
        eng = self._runner.engine
        batch = self._runner.size if self.mode == "ensemble" else 1
        flips = n_sweeps * eng.cfg.n * eng.cfg.m * eng.replicas * batch
        tel.REGISTRY.gauge("rolling_flips_per_ns").set(flips / duration_ns)

    def run(self, n_sweeps: int):
        """Advance ``n_sweeps`` full lattice sweeps (every member, in
        ensemble mode, which returns the (B,) per-member
        magnetizations)."""
        with tel.span("session.run", mode=self.mode,
                      engine=self.spec.engine.name, k=n_sweeps) as sp:
            out = self._runner.run(n_sweeps)
            sp.fence(self.state)
        self._flip_rate(n_sweeps, sp.duration_ns)
        return out

    def measure(self, plan=None) -> dict:
        """Run a measurement plan (default: ``spec.sweep``); returns
        ``{field: (n_measure,) float32 ndarray}``, with a trailing batch
        axis in ensemble mode and a trailing replica axis (32) for the
        bitplane engines' per-replica observables."""
        if plan is None:
            if self.spec.sweep is None:
                raise ValueError("no plan: pass one or set RunSpec.sweep")
            plan = self.spec.sweep.plan()
        with tel.span("session.measure", mode=self.mode,
                      engine=self.spec.engine.name,
                      n_measure=plan.n_measure,
                      sweeps_between=plan.sweeps_between,
                      thermalize=plan.thermalize) as sp:
            traj = self._runner.measure(plan)
            sp.fence(self.state)
        self._flip_rate(plan.total_sweeps, sp.duration_ns)
        return traj

    def plan(self) -> dict:
        """The dispatch plan of this session's spec (:func:`describe`)."""
        return describe(self.spec)

    def trajectory(self, n_measure: int, sweeps_between: int,
                   thermalize: int = 0) -> np.ndarray:
        """Magnetization samples, shape ``(n_measure,)``, with the batch
        and replica axes of :meth:`measure`."""
        from repro_torch.analysis.measure import MeasurementPlan
        plan = MeasurementPlan(n_measure, sweeps_between, thermalize,
                               fields=("m",))
        return self.measure(plan)["m"]

    def magnetization(self):
        """Mean spin (for bitplane: the mean over the 32 replicas); in
        ensemble mode a (B,) float32 array, one a member."""
        return self._runner.magnetization()

    def energy(self) -> float:
        """Energy per spin (for bitplane: the mean over the replicas)."""
        return self._runner.energy()

    def full_lattice(self) -> torch.Tensor:
        """The +-1 lattice (ensemble mode: ``(B, N, M)``, one a
        member)."""
        return self._runner.full_lattice()

    def state_digest(self, member=None) -> str:
        """CRC32C hex digest of (step_count, every named state array),
        framed as the JAX package frames it: equal digests mean
        bit-identical lattices at the same point of the trajectory.

        ``member`` (ensemble mode only) digests one member's slice of the
        batched state with a single-mode session's framing: by the
        ensemble's contract it equals the digest of the single-mode run
        of that member's (temperature, seed)."""
        arrays = self._runner.state_arrays()
        if member is not None:
            if self.mode != "ensemble":
                raise ValueError(
                    f"member= digest needs ensemble mode, this session "
                    f"is {self.mode!r}")
            if not 0 <= member < self._runner.size:
                raise ValueError(
                    f"member {member} out of range for batch size "
                    f"{self._runner.size}")
            arrays = {k: np.asarray(v)[member] for k, v in arrays.items()}
        crc = integrity.crc32c(
            f"step_count={self._runner.step_count}".encode())
        for k, v in sorted(arrays.items()):
            a = np.ascontiguousarray(np.asarray(v))
            crc = integrity.crc32c(f"{k}:{a.dtype}:{a.shape}:".encode(), crc)
            crc = integrity.crc32c(a.tobytes(), crc)
        return f"{crc:08x}"

    def save(self, path: str) -> None:
        """Atomic checkpoint: serialized spec, step count and the
        engine's named state arrays (batched in ensemble mode)."""
        with tel.span("ckpt.save", path=path, mode=self.mode,
                      step_count=self._runner.step_count):
            arrays = {f"state_{k}": v
                      for k, v in self._runner.state_arrays().items()}
            _atomic_savez(path, spec_json=self.spec.to_json(),
                          step_count=self._runner.step_count, **arrays)

    @classmethod
    def restore(cls, path: str, device=None, *, mesh=_KEEP,
                resident_budget_bytes=None) -> "Session":
        """Rebuild a session from a checkpoint of either package; a
        counter-based engine continues the exact Philox stream.  ``mesh``
        overrides the checkpoint's ``MeshSpec`` (a ``MeshSpec`` to
        reshard, ``None`` to continue in single mode): the draws are
        keyed on global positions, so the run continues bit for bit on
        any mesh.  ``resident_budget_bytes`` as for :meth:`open`."""
        with tel.span("ckpt.restore", path=path) as sp:
            spec, step_count, arrays = _load_checkpoint(path)
            if mesh is not _KEEP and mesh != spec.mesh:
                spec = dataclasses.replace(spec, mesh=mesh)
            sp.set(mode=spec.mode, engine=spec.engine.name,
                   step_count=step_count)
            return cls._from_arrays(
                spec, arrays, step_count, device=device,
                resident_budget_bytes=resident_budget_bytes)

    @classmethod
    def _from_arrays(cls, spec: RunSpec, arrays: dict, step_count: int, *,
                     device=None, resident_budget_bytes=None) -> "Session":
        """A session of ``spec`` at ``step_count`` from its named state
        arrays (a checkpoint's, without the ``state_`` prefix; host numpy
        arrays, placed here on ``device`` or the mesh): what
        ``Session.restore`` and the supervisor's resume build."""
        runner = _runner(spec, device, state=_SENTINEL,
                         step_count=step_count,
                         resident_budget_bytes=resident_budget_bytes)
        runner.load_arrays(arrays)
        return cls(spec, runner)


#: placeholder state that lets ``restore`` skip the fresh init
_SENTINEL = ()
