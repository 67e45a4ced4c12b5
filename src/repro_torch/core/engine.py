"""Engine registry: one protocol for the update algorithms of the port.

Counterpart of ``repro.core.engine``: the registry, the ``Engine``
protocol, the counter-based ``CounterEngine`` with its two tiers, and
all ten of the JAX package's engines under its names, so that a JAX
checkpoint's spec resolves here: ``basic``, ``basic_philox``,
``stencil_pallas``, ``multispin``, ``multispin_pallas``, ``bitplane``,
``bitplane_pallas``, ``tensorcore``, ``wolff`` and ``spinglass``.  Any
other name raises and lists them.  The four whose update the JAX
package leaves to ``jnp`` (``basic``, ``basic_philox``, ``spinglass``,
``wolff``) update in plain PyTorch here too, and draw their uniforms on
the card from the kernel ``philox_fill`` (``repro_torch.kernels.draws``).

Protocol:

* ``init_state()``            -- fresh engine-native state on the device;
* ``sweeps(state, n, step)``  -- advance ``n`` full sweeps at the
                                 config's own temperature and seed: one
                                 dispatch (``_dispatch``: the telemetry
                                 counters and the ``dispatch`` span),
                                 launched through
                                 ``resilience.degrade.run_dispatch``;
* ``scan_step(state, inv_temp, seed, step_count, n)`` -- the same with
  explicit arguments; ``measure_scan`` chains it;
* ``full_lattice``, ``magnetization``, ``energy``, ``observables``;
* ``state_arrays`` / ``from_arrays`` -- named host numpy arrays, the
  checkpoint layout the JAX package uses.

Counter-based engines draw from Philox addressed by (seed, half-sweep
offset, site), so a run continues its stream bit for bit from any
``step_count``, and both tiers of ``sweep_fn`` draw the same stream.
They also advance an ensemble's members at once (``sweep_fn_batched``:
``(B, n, w)`` planes, an inverse temperature and a seed a member, one
shared offset, as the JAX package's ``vmap`` of ``sweep_fn`` over
``in_axes=(0, 0, 0, None)``), each member on the trajectory of its own
single-mode run; ``sweep_fn`` is its batch of one.  On a mesh
(``api.session._ShardedRunner``) an engine's ``dist_factory`` and
``shard_family`` name its two sharded tiers, and ``init_block`` makes a
shard's part of a fresh lattice.
"""
from __future__ import annotations

import contextlib
import functools
from typing import ClassVar, Dict, Optional, Type

import numpy as np
import torch

import repro_torch.telemetry as tel
from repro_torch import convert
from repro_torch.resilience import degrade

from . import bitplane as bp
from . import lattice as lat
from . import metropolis as metro
from . import multispin as ms
from . import observables as obs
from . import rng
from . import spinglass as sg
from . import tensorcore as tc
from . import wolff as wolff_mod

ENGINES: Dict[str, Type["Engine"]] = {}

#: bytes of state planes in one chunk of an ensemble's observables
#: (``CounterEngine.member_chunks``): one member of 8192^2 or more a
#: chunk, every member of a 64^2 scan in one
OBSERVABLE_CHUNK_BYTES = 1 << 24


@functools.lru_cache(maxsize=1024)
def host_table(make, inv_temp) -> torch.Tensor:
    """``make(inv_temp)``, made once: a measured trajectory asks for every
    member's table each block of sweeps.  The members of an ensemble are
    a cycle of lookups, which an LRU cache serves only where they all fit:
    1024 entries hold the largest launch's members (350) twice over.  The
    tables are read, never written."""
    return make(inv_temp)


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
            f"engine {name!r} is not ported to repro_torch; its engines "
            f"(the JAX package's ten): {sorted(ENGINES)}") from None


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
    #: the JAX registry's flag: a Philox engine whose sweep is a function
    #: of (state, inverse temperature, seed, offset), so that an ensemble
    #: (``BatchSpec``) may batch it
    counter_based: ClassVar[bool] = False
    #: planner family of the k-sweep tier; ``None``: no k-sweep kernel
    resident_family: ClassVar[Optional[str]] = None
    #: engine-specific config knobs (``EngineSpec.params`` is checked
    #: against them)
    param_fields: ClassVar[tuple] = ()
    #: keys of :meth:`observables`
    observable_fields: ClassVar[tuple] = ("m", "e")
    #: lattices one state advances (32 for the bitplane engines)
    replicas: ClassVar[int] = 1
    #: the per-half-sweep distributed step that runs this engine on a
    #: mesh (``repro_torch.core.distributed``: "basic", "packed" or
    #: "bitplane"); ``None``: the engine takes no mesh
    dist_factory: ClassVar[Optional[str]] = None
    #: planner family of the sharded resident tier (``repro_torch.dist``)
    #: on a mesh; ``None``: the per-half-sweep distributed step only.  As
    #: in the JAX package only the ``_pallas`` engines have one, though
    #: the port's ``multispin`` and ``bitplane`` have a single-device
    #: k-sweep tier too
    shard_family: ClassVar[Optional[str]] = None
    #: the k-sweep planner's decision as span attributes
    #: (``kernels.resident.decision_attrs``: ``describe()``'s
    #: ``"resident"``); empty for an engine with no k-sweep tier
    resident_attrs: dict = {}

    @classmethod
    def validate_lattice(cls, n: int, m: int, **params) -> None:
        """Raise ``ValueError`` where the lattice (with the engine's
        ``params``) does not fit the engine's layout."""
        if n % 2 or m % 2:
            raise ValueError(
                f"engine {cls.name!r} needs even lattice dims for the "
                f"checkerboard decomposition, got ({n}, {m})")

    def __init__(self, config, device: torch.device,
                 resident_budget_bytes: Optional[int] = None):
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
        tensors on the device; a counter-based engine's also of an
        ensemble's ``(B, n, w)`` planes, as ``(B,)`` tensors (neither
        depends on ``inv_temp``)."""
        raise NotImplementedError

    @contextlib.contextmanager
    def _dispatch(self, n_sweeps: int, batch: int = 1, **attrs):
        """Account and trace ONE dispatch: the canonical counters advance
        at once (on the host, once a call, as in the JAX package), and
        a ``dispatch`` span records the phase (the host's launches, which
        do not wait for the card).  ``attrs`` are the planner's
        decision; its sweeps per launch ``k`` become ``resident_k`` (the
        span's ``k`` is the dispatch's sweeps, as in the JAX package)."""
        attrs = {("resident_k" if key == "k" else key): v
                 for key, v in attrs.items()}
        tel.record_dispatch(n_sweeps=n_sweeps,
                            sites=self.cfg.n * self.cfg.m,
                            replicas=self.replicas, batch=batch,
                            counter_based=self.counter_based)
        with tel.span("dispatch", engine=self.name,
                      lattice=(self.cfg.n, self.cfg.m), k=n_sweeps,
                      replicas=self.replicas, batch=batch,
                      **attrs) as sp:
            yield sp

    def sweeps(self, state, n_sweeps: int, step_count: int):
        """``scan_step`` at the config's own temperature and seed, as ONE
        dispatch, launched through ``resilience.degrade.run_dispatch``:
        each (re)attempt is its own accounted dispatch, and a k-sweep
        tier the card cannot hold demotes to the per-half-sweep tier."""
        def attempt():
            with self._dispatch(n_sweeps, **self.resident_attrs):
                return self.scan_step(state, self.cfg.inv_temp,
                                      self.cfg.seed, step_count, n_sweeps)

        return degrade.run_dispatch(attempt, engine=self)

    def scan_step(self, state, inv_temp, seed, step_count, n_sweeps: int):
        raise NotImplementedError

    def state_arrays(self, state) -> dict:
        raise NotImplementedError

    def from_arrays(self, arrays: dict):
        raise NotImplementedError


class CounterEngine(Engine):
    """Counter-based (Philox skip-ahead) engines, with two tiers.

    Subclasses implement ``color_update`` (one half-sweep) and, where a
    k-sweep kernel exists, ``resident_sweeps``, both on ``(B, n, w)``
    planes with a table and a seed a member.  At construction the
    planner (``repro_torch.kernels.resident``) decides whether this
    lattice runs k sweeps per launch; ``sweep_fn_batched`` then routes
    every block of sweeps through it, or else through the per-half-sweep
    loop, and ``sweep_fn`` is its batch of one.  Both tiers use the
    counter layout of ``rng.half_sweep_offset``, so which one ran cannot
    be seen in the trajectory.
    """

    counter_based = True

    def __init__(self, config, device: torch.device,
                 resident_budget_bytes: Optional[int] = None):
        super().__init__(config, device)
        self.resident_plan = None
        self._budget = resident_budget_bytes
        if self.resident_family is not None:
            from repro_torch.kernels.resident import (decision_attrs,
                                                      plan_resident)
            self.resident_plan = plan_resident(
                self.resident_family, config.n, config.m,
                budget_bytes=resident_budget_bytes)
            self.resident_attrs = decision_attrs(
                self.resident_family, config.n, config.m,
                budget_bytes=resident_budget_bytes)

    def _demote_resident(self, reason: str) -> None:
        """Demote this (family, lattice) to the per-half-sweep tier for
        the rest of the process: record it in the process-global registry
        (so freshly built engines and ``--dry-run`` plans agree), drop
        the plan and re-render the span attributes.  Both tiers draw the
        same Philox stream, so the trajectory does not fork."""
        from repro_torch.kernels.resident import decision_attrs
        degrade.demote(self.resident_family, self.cfg.n, self.cfg.m,
                       reason)
        self.resident_plan = None
        self.resident_attrs = decision_attrs(
            self.resident_family, self.cfg.n, self.cfg.m,
            budget_bytes=self._budget)

    def color_update(self, targets, ops, tables, is_black, seeds, offset):
        """One half-sweep of every member's target plane."""
        raise NotImplementedError

    def resident_sweeps(self, states, tables, seeds, start_offset,
                        n_sweeps: int):
        """``n_sweeps`` sweeps of every member through the k-sweep tier."""
        raise NotImplementedError

    def sweep_context(self, inv_temp) -> torch.Tensor:
        """The acceptance table (float32 for the int8 planes, uint32
        thresholds for word planes), computed on the host once per
        inverse temperature (:func:`host_table`)."""
        return host_table(metro.acceptance_table, inv_temp)

    def sweep_fn_batched(self, states, inv_temps, seeds, start_offset,
                         n_sweeps: int):
        """``n_sweeps`` x (black, white) half-sweeps of every member (its
        inverse temperature and seed) at the shared offsets
        ``half_sweep_offset(start_offset, i, colour)``, on the tier the
        plan chose: it depends on (n, m) alone, so every member shares
        it.  Each block of sweeps (or half-sweep) is one launch of the
        kernel's member axis for all members."""
        tables = [self.sweep_context(beta) for beta in inv_temps]
        seeds = [int(s) for s in seeds]
        if self.resident_plan is not None and n_sweeps > 0:
            return tuple(self.resident_sweeps(
                states, tables, seeds, start_offset, n_sweeps))
        b, w = states
        for i in range(n_sweeps):
            b = self.color_update(b, w, tables, True, seeds,
                                  rng.half_sweep_offset(start_offset, i, 0))
            w = self.color_update(w, b, tables, False, seeds,
                                  rng.half_sweep_offset(start_offset, i, 1))
        return (b, w)

    def sweep_fn(self, state, inv_temp, seed, start_offset, n_sweeps: int):
        """:meth:`sweep_fn_batched` of one member: the planes viewed as a
        batch of one, which launches the kernels' single-member
        instances; returns views of member 0's planes."""
        states = tuple(p[None] for p in state)
        return self.member(self.sweep_fn_batched(
            states, [inv_temp], [seed], start_offset, n_sweeps), 0)

    def scan_step(self, state, inv_temp, seed, step_count, n_sweeps: int):
        # one half-sweep offset per colour: cumulative offset = 2 * sweeps
        return self.sweep_fn(state, inv_temp, seed,
                             (2 * int(step_count)) & rng.MASK32, n_sweeps)

    def scan_step_batched(self, states, inv_temps, seeds, step_count,
                          n_sweeps: int):
        return self.sweep_fn_batched(states, inv_temps, seeds,
                                     (2 * int(step_count)) & rng.MASK32,
                                     n_sweeps)

    # -- ensembles: (B, n, w) planes, one member a leading index --------

    def init_states(self, seeds, out=None):
        """Every member's fresh state, stacked: member i's is the
        single-mode fresh state of seed i, made one member at a time
        (into ``out``'s planes where given, a state of as many members)."""
        stacked = out
        for i, seed in enumerate(seeds):
            member = self.init_member(int(seed))
            if stacked is None:
                stacked = tuple(torch.empty((len(seeds), *p.shape),
                                            dtype=p.dtype, device=p.device)
                                for p in member)
            for dst, src in zip(stacked, member):
                dst[i] = src
            del member
        return stacked

    def init_member(self, seed: int):
        """The fresh state of the config's lattice for ``seed``."""
        raise NotImplementedError

    @staticmethod
    def member(states, i: int):
        """Member ``i``'s state: views of its planes."""
        return tuple(p[i] for p in states)

    def member_chunks(self, states):
        """Consecutive members' planes (views), as many a chunk as hold
        :data:`OBSERVABLE_CHUNK_BYTES` of state, at least one: the
        observables of an ensemble run over a chunk at once, and their
        temporaries, a fixed multiple of the chunk's state, stay below
        those of one member of that size."""
        members = states[0].shape[0]
        member_bytes = sum(p[0].numel() * p.element_size() for p in states)
        step = max(1, OBSERVABLE_CHUNK_BYTES // member_bytes)
        return [tuple(p[lo:lo + step] for p in states)
                for lo in range(0, members, step)]

    def magnetizations(self, states) -> torch.Tensor:
        """(B,) float32: each member's :meth:`magnetization`, a chunk of
        members at a time."""
        return torch.cat([self.magnetization(chunk)
                          for chunk in self.member_chunks(states)])

    def full_lattices(self, states) -> torch.Tensor:
        """(B, N, M): each member's :meth:`full_lattice`."""
        return torch.cat([self.full_lattice(chunk)
                          for chunk in self.member_chunks(states)])

    def observables_batched(self, states, inv_temps) -> dict:
        """Each member's :meth:`observables`, a chunk of members at a
        time: ``{field: (B,)}``, or ``(B, 32)`` for the bitplane engines'
        per-replica values.  The sums are integers, so each member's
        values are its single-mode ones bit for bit."""
        chunks = [self.observables(chunk, None)
                  for chunk in self.member_chunks(states)]
        return {k: torch.cat([c[k] for c in chunks]) for k in chunks[0]}


class _TwoPlaneEngine(CounterEngine):
    """(black, white) plane state: two ``(n, m / col_divisor)`` planes,
    named ``plane_keys`` of ``plane_dtype`` in ``state_arrays`` (the JAX
    engine's layout)."""

    plane_keys: ClassVar[tuple] = ("black", "white")
    plane_dtype: ClassVar[type] = np.int8
    #: lattice columns per plane column
    col_divisor: ClassVar[int] = 2

    def init_state(self):
        return self.init_member(self.cfg.seed)

    def init_member(self, seed: int):
        cfg = self.cfg
        return self.init_block((0, cfg.n), (0, cfg.m), self.device, seed)

    def init_block(self, rows, cols, device, seed=None):
        """The fresh planes of the lattice block ``rows`` x ``cols``
        (``(start, stop)`` lattice ranges, the start even) on ``device``,
        drawn for ``seed`` (default: the config's): what
        :meth:`init_state` holds there, so that each shard of a sharded
        run makes its own part."""
        raise NotImplementedError

    def state_arrays(self, state) -> dict:
        """Named host arrays of the planes; an ensemble's ``(B, n, w)``,
        as the JAX package's ensemble checkpoint holds them."""
        return convert.state_to_reference(state, self.plane_keys,
                                          self.plane_dtype)

    def from_arrays(self, arrays: dict, members: Optional[int] = None):
        """The state of named host arrays: ``(n, w)`` planes, or an
        ensemble's ``(members, n, w)``."""
        black, white = convert.state_from_reference(
            arrays, self.device, self.plane_keys, self.plane_dtype,
            batched=members is not None)
        want = (self.cfg.n, self.cfg.m // self.col_divisor)
        if members is not None:
            want = (members, *want)
        if tuple(black.shape) != want:
            raise ValueError(f"state planes are {tuple(black.shape)}, the "
                             f"{self.cfg.n}x{self.cfg.m} lattice needs {want}")
        return black, white


class _Int8PlanesEngine(_TwoPlaneEngine):
    """(black, white) int8 +-1 compact colour planes, ``(n, m/2)``: the
    state of ``basic``, ``basic_philox`` and ``stencil_pallas``."""

    def init_block(self, rows, cols, device, seed=None):
        cfg = self.cfg
        return lat.init_planes(cfg.n, cfg.m, cfg.init_p_up,
                               cfg.seed if seed is None else seed, device,
                               rows, cols)

    def full_lattice(self, state) -> torch.Tensor:
        return lat.merge_checkerboard(*state)

    def magnetization(self, state) -> torch.Tensor:
        return obs.magnetization(*state)

    def observables(self, state, inv_temp) -> dict:
        return {"m": obs.magnetization(*state),
                "e": obs.energy_per_spin(*state)}


@register
class BasicPhiloxEngine(_Int8PlanesEngine):
    """The basic checkerboard Metropolis engine with counter-based Philox
    (paper S3.1; the JAX package's ``update_color_philox``): each
    half-sweep draws lane 0 of Philox at ``(offset, 0, row*h + col, 0)``
    for the whole target plane -- on the card with the kernel
    ``philox_fill``, every member of an ensemble in one launch -- then
    updates it in plain PyTorch (``metropolis.update_color``).  It has no
    k-sweep tier; on a mesh it takes the per-half-sweep distributed step
    "basic" (``distributed.make_ising_step``, its draws from
    ``philox_fill`` too, one launch a shard).

    It is the oracle the stencil kernels match: its trajectory is
    ``stencil_pallas``'s bit for bit from the same state, in single mode,
    in an ensemble and on any mesh.
    """

    name = "basic_philox"
    dist_factory = "basic"

    def color_update(self, targets, ops, tables, is_black, seeds, offset):
        from repro_torch.kernels.draws import philox_fill
        u = philox_fill(seeds, offset, shape=tuple(targets.shape[1:]),
                        device=targets.device)[0]
        nn = metro.neighbor_sums(ops, is_black)
        return torch.stack([metro.accept_flips(t, c, v, table) for t, c, v,
                            table in zip(targets, nn, u, tables)])


@register
class BasicEngine(BasicPhiloxEngine):
    """Paper S3.1's basic path: each half-sweep first fills the whole
    plane with uniforms (``philox_fill`` on the card), then updates it.
    It is ``basic_philox``'s loop at ``basic_philox``'s counters, so its
    trajectory is ``basic_philox``'s.

    The JAX engine of this name draws from ``jax.random``, which this
    package cannot reproduce; as there it is not counter-based (refused
    in a ``BatchSpec``) and takes no mesh.
    """

    name = "basic"
    counter_based = False
    dist_factory = None


@register
class StencilPallasEngine(_Int8PlanesEngine):
    """The stencil kernel pair (paper S3.1): ``stencil_update`` per
    half-sweep, ``stencil_sweeps_resident`` for k sweeps per launch; on
    a mesh ``stencil_shard_sweeps`` (``repro_torch.dist``).

    Keeps the JAX package's engine name.  Philox is keyed on the global
    (row, col) index, so both tiers give one trajectory, and it is the
    JAX engine's bit for bit from the same state wherever the two
    acceptance tables decide flips alike (``metropolis.acceptance_table``).
    The half-sweep tier updates the state planes in place.
    """

    name = "stencil_pallas"
    resident_family = "stencil"
    dist_factory = "basic"
    shard_family = "stencil"

    def color_update(self, targets, ops, tables, is_black, seeds,
                     offset):
        from repro_torch.kernels.stencil import stencil_update_batched
        return stencil_update_batched(targets, ops, tables,
                                      is_black=is_black, seeds=seeds,
                                      offset=offset)

    def resident_sweeps(self, states, tables, seeds, start_offset,
                        n_sweeps):
        from repro_torch.kernels.stencil import \
            stencil_sweeps_resident_batched
        return stencil_sweeps_resident_batched(
            *states, tables, n_sweeps=n_sweeps, seeds=seeds,
            start_offset=start_offset, plan=self.resident_plan)


class _WordPlanesEngine(_TwoPlaneEngine):
    """(black, white) uint32 word planes, held as int32 tensors; the
    accept compares raw draws with 10 uint32 thresholds."""

    plane_dtype = np.uint32

    def sweep_context(self, inv_temp) -> torch.Tensor:
        return host_table(ms.acceptance_thresholds, inv_temp)


@register
class MultispinEngine(_WordPlanesEngine):
    """Multi-spin coding (paper S3.3), 8 spins per uint32 word:
    ``multispin_update`` per half-sweep, ``multispin_sweeps_resident``
    for k sweeps per launch.

    In the JAX package ``multispin`` is the plain-jnp oracle and
    ``multispin_pallas`` the Pallas engine; both give one trajectory, so
    here both run the CUDA kernels.  State: ``(black_words,
    white_words)``, ``(n, m/16)`` int32 tensors of nibble words.  A fresh
    state packs the single-lattice init of the same spec, so its
    ``full_lattice`` is ``stencil_pallas``'s.  The half-sweep tier
    updates the planes in place.
    """

    name = "multispin"
    resident_family = "multispin"
    dist_factory = "packed"
    plane_keys = ("black_words", "white_words")
    col_divisor = 2 * lat.SPINS_PER_WORD

    @classmethod
    def validate_lattice(cls, n: int, m: int, **params) -> None:
        super().validate_lattice(n, m, **params)
        if (m // 2) % lat.SPINS_PER_WORD:
            raise ValueError(
                f"engine {cls.name!r} packs {lat.SPINS_PER_WORD} spins per "
                f"uint32 word: the compact plane width m/2 must be a "
                f"multiple of {lat.SPINS_PER_WORD}, got m={m}")

    def init_block(self, rows, cols, device, seed=None):
        cfg = self.cfg
        return ms.pack_lattice(*lat.init_planes(
            cfg.n, cfg.m, cfg.init_p_up, cfg.seed if seed is None else seed,
            device, rows, cols))

    def full_lattice(self, state) -> torch.Tensor:
        return lat.merge_checkerboard(*ms.unpack_lattice(*state))

    def magnetization(self, state) -> torch.Tensor:
        return obs.magnetization(*ms.unpack_lattice(*state))

    def observables(self, state, inv_temp) -> dict:
        planes = ms.unpack_lattice(*state)
        return {"m": obs.magnetization(*planes),
                "e": obs.energy_per_spin(*planes)}

    def color_update(self, targets, ops, tables, is_black, seeds,
                     offset):
        from repro_torch.kernels.multispin import multispin_update_batched
        return multispin_update_batched(targets, ops, tables,
                                        is_black=is_black, seeds=seeds,
                                        offset=offset)

    def resident_sweeps(self, states, tables, seeds, start_offset,
                        n_sweeps):
        from repro_torch.kernels.multispin import \
            multispin_sweeps_resident_batched
        return multispin_sweeps_resident_batched(
            *states, tables, n_sweeps=n_sweeps, seeds=seeds,
            start_offset=start_offset, plan=self.resident_plan)


@register
class MultispinPallasEngine(MultispinEngine):
    """The JAX package's ``multispin_pallas``: the same engine as
    ``multispin``, so a checkpoint of either restores as either; on a
    mesh it takes the sharded resident tier (``multispin_shard_sweeps``),
    where ``multispin`` takes the per-half-sweep distributed step."""

    name = "multispin_pallas"
    shard_family = "multispin"


@register
class BitplaneEngine(_WordPlanesEngine):
    """Bitplane multi-spin coding, 32 replicas per uint32 word (bit r =
    replica r): ``bitplane_update`` per half-sweep,
    ``bitplane_sweeps_resident`` for k sweeps per launch,
    ``bitplane_counts`` for the observables.

    State: ``(black_bits, white_bits)``, ``(n, m/2)`` int32 tensors.
    ``observables`` returns per-replica ``(32,)`` vectors, so
    ``measure`` trajectories are ``(n_measure, 32)``; ``magnetization``
    and ``energy`` are the means over the replicas and ``full_lattice``
    is replica 0.  A fresh state draws each replica with the port's own
    Philox init keyed on the replica (``bitplane.init_words``); replica 0
    is the single-lattice init of the same spec.  ``bitplane`` and
    ``bitplane_pallas`` are one engine, as in the JAX package.  All 32
    replicas share their draws: replicas that start equal stay equal,
    so a run meant to carry 32 lattices starts hot.
    """

    name = "bitplane"
    replicas = bp.N_REPLICAS
    resident_family = "bitplane"
    dist_factory = "bitplane"
    plane_keys = ("black_bits", "white_bits")

    @classmethod
    def validate_lattice(cls, n: int, m: int, **params) -> None:
        super().validate_lattice(n, m, **params)
        if (m // 2) % 4:
            raise ValueError(
                f"engine {cls.name!r} draws one Philox call per 4-site "
                f"group: the compact plane width m/2 must be a multiple "
                f"of 4, got m={m}")

    def init_block(self, rows, cols, device, seed=None):
        cfg = self.cfg
        return bp.init_words(cfg.n, cfg.m, cfg.init_p_up,
                             cfg.seed if seed is None else seed, device,
                             rows, cols)

    def full_lattice(self, state) -> torch.Tensor:
        return bp.replica_lattice(*state, r=0)

    def magnetization(self, state) -> torch.Tensor:
        return _replica_mean(bp.magnetizations_of(
            self._counts(state, 0, bp.up_counts), bp.replica_sites(state[0])))

    def energy(self, state) -> torch.Tensor:
        return _replica_mean(bp.energies_of(
            self._counts(state, 1, bp.disagreements),
            bp.replica_sites(state[0])))

    def observables(self, state, inv_temp) -> dict:
        """Per-replica vectors: ``{"m": (32,), "e": (32,)}``, from the
        counts of one ``bitplane_counts`` launch on the card."""
        from repro_torch.kernels.bitplane.counts import bitplane_counts
        return bp.observables_of(bitplane_counts(*state),
                                 bp.replica_sites(state[0]))

    @staticmethod
    def _counts(state, row: int, plain) -> torch.Tensor:
        """Row ``row`` of ``bitplane_counts`` (0: up spins, 1: disagreeing
        bonds) on the card; on the CPU that row's plain count alone."""
        if state[0].device.type == "cpu":
            return plain(*state)
        from repro_torch.kernels.bitplane.counts import bitplane_counts
        return bitplane_counts(*state)[..., row, :]

    def color_update(self, targets, ops, tables, is_black, seeds,
                     offset):
        from repro_torch.kernels.bitplane import bitplane_update_batched
        return bitplane_update_batched(targets, ops, tables,
                                       is_black=is_black, seeds=seeds,
                                       offset=offset)

    def resident_sweeps(self, states, tables, seeds, start_offset,
                        n_sweeps):
        from repro_torch.kernels.bitplane import \
            bitplane_sweeps_resident_batched
        return bitplane_sweeps_resident_batched(
            *states, tables, n_sweeps=n_sweeps, seeds=seeds,
            start_offset=start_offset, plan=self.resident_plan)


@register
class BitplanePallasEngine(BitplaneEngine):
    """The JAX package's ``bitplane_pallas``: the same engine as
    ``bitplane``; on a mesh it takes the sharded resident tier
    (``bitplane_shard_sweeps``), where ``bitplane`` takes the
    per-half-sweep distributed step."""

    name = "bitplane_pallas"
    shard_family = "bitplane"


@register
class TensorCoreEngine(CounterEngine):
    """Paper S3.2: neighbour sums as banded products on the tensor cores,
    through the fused kernel ``tensorcore_update``, two launches per
    sweep (there is no k-sweep tier).

    State: the four int8 sublattice planes ``{'00', '01', '10', '11'}``
    of shape ``(n/2, m/2)`` (``plane_XX`` in a checkpoint, int8 as in the
    JAX package).  A fresh state decomposes the single-lattice init of
    the same spec, so its ``full_lattice`` is ``stencil_pallas``'s.

    The JAX engine of this name draws from ``jax.random``; this one
    draws what the fused kernel draws (Philox lanes 0/1, key ``(seed mod
    2^32, 0)``, offsets ``half_sweep_offset(2 step_count, i, colour)``),
    so it is counter-based here: its trajectory from a state is the JAX
    package's ``run_sweeps_tensorcore`` from that state and its step
    count.  The half-sweeps update the planes in place.
    """

    name = "tensorcore"
    # the JAX engine of this name draws from jax.random and is refused in
    # a batch; so is this one, which adds no feature the JAX package lacks
    counter_based = False
    param_fields = ("tc_block",)

    @classmethod
    def validate_lattice(cls, n: int, m: int, **params) -> None:
        super().validate_lattice(n, m, **params)
        block = params.get("tc_block", tc.BLOCK)
        if (n // 2) % block or (m // 2) % block:
            raise ValueError(
                f"engine {cls.name!r}: tc_block {block} must divide the "
                f"sublattice planes ({n // 2}, {m // 2}) of a {n}x{m} "
                f"lattice")

    def __init__(self, config, device: torch.device,
                 resident_budget_bytes: Optional[int] = None):
        super().__init__(config, device, resident_budget_bytes)
        self.block = config.tc_block

    def init_state(self):
        cfg = self.cfg
        return tc.init_planes(cfg.n, cfg.m, cfg.init_p_up, cfg.seed,
                              self.device)

    def full_lattice(self, state) -> torch.Tensor:
        return tc.recompose(state)

    def magnetization(self, state) -> torch.Tensor:
        return obs.magnetization_planes(state)

    def observables(self, state, inv_temp) -> dict:
        return {"m": obs.magnetization_planes(state),
                "e": obs.energy_per_spin_planes(state)}

    def sweep_fn(self, state, inv_temp, seed, start_offset, n_sweeps: int):
        from repro_torch.kernels.tensorcore import run_sweeps_tensorcore
        return run_sweeps_tensorcore(state, inv_temp, n_sweeps, seed=seed,
                                     start_offset=start_offset,
                                     block=self.block)

    def state_arrays(self, state) -> dict:
        return convert.planes_to_reference(state)

    def from_arrays(self, arrays: dict):
        return convert.planes_from_reference(
            arrays, self.device, (self.cfg.n // 2, self.cfg.m // 2))


def _replica_mean(values: torch.Tensor) -> torch.Tensor:
    """Mean of per-replica float32 values (the last axis), taken in
    float64 and rounded once to float32."""
    return values.to(torch.float64).mean(-1).to(torch.float32)


class _LatticeEngine(Engine):
    """Engines whose state holds the whole ``(n, m)`` int8 lattice
    (``wolff``; ``spinglass`` beside its couplings), key-based as in the
    JAX package: no ensemble, no mesh.  A fresh lattice is the
    single-lattice init of the same spec (``stencil_pallas``'s
    ``full_lattice``)."""

    def fresh_lattice(self) -> torch.Tensor:
        cfg = self.cfg
        return lat.merge_checkerboard(*lat.init_planes(
            cfg.n, cfg.m, cfg.init_p_up, cfg.seed, self.device))


@register
class WolffEngine(_LatticeEngine):
    """Wolff cluster updates (paper S2): one "sweep" is one cluster flip
    (``core.wolff``), cluster ``step_count + i`` drawn from Philox lane
    c1 = 2 (``philox_fill`` on the card).  State: the lattice
    (``lattice`` in a checkpoint).  The bond probability comes from
    ``cfg.temperature``, not ``1 / inv_temp``, as in the JAX package.
    The JAX engine of this name draws from ``jax.random``."""

    name = "wolff"
    #: mean cluster size of the last ``sweeps`` (a 0-d float32 tensor on
    #: the device; ``None`` before the first)
    mean_cluster_size = None

    def init_state(self):
        return self.fresh_lattice()

    def full_lattice(self, state) -> torch.Tensor:
        return state

    def magnetization(self, state) -> torch.Tensor:
        return obs.magnetization_full(state)

    def observables(self, state, inv_temp) -> dict:
        return {"m": obs.magnetization_full(state),
                "e": obs.energy_per_spin_full(state)}

    def scan_step(self, state, inv_temp, seed, step_count, n_sweeps: int):
        state, self.mean_cluster_size = wolff_mod.run_wolff(
            state, self.cfg.temperature, n_sweeps, seed, step_count)
        return state

    def state_arrays(self, state) -> dict:
        return convert.state_to_reference((state,), ("lattice",))

    def from_arrays(self, arrays: dict):
        return _whole_planes(self, arrays, ("lattice",))[0]


@register
class SpinGlassEngine(_LatticeEngine):
    """2D +-J Edwards-Anderson spin glass (paper S6's extension,
    ``core.spinglass``).  State: ``(lattice, j_up, j_left)``, the
    quenched couplings carried beside the lattice so that a checkpoint
    restores the disorder sample.  The couplings are a pure function of
    the seed and ``p_ferro`` (Philox lane c1 = 3), the sweeps draw as
    ``basic_philox`` does (lane c1 = 0 at the compact colour-plane
    index; ``philox_fill`` on the card), so at ``p_ferro = 1`` a run is
    ``basic_philox``'s.  The observables weight every bond by its
    coupling.  The JAX engine of this name draws from ``jax.random``."""

    name = "spinglass"
    param_fields = ("p_ferro",)

    def init_state(self):
        cfg = self.cfg
        return (self.fresh_lattice(),
                *sg.init_couplings(cfg.n, cfg.m, cfg.p_ferro, cfg.seed,
                                   self.device))

    def full_lattice(self, state) -> torch.Tensor:
        return state[0]

    def magnetization(self, state) -> torch.Tensor:
        return obs.magnetization_full(state[0])

    def observables(self, state, inv_temp) -> dict:
        return {"m": obs.magnetization_full(state[0]),
                "e": sg.energy_per_spin(*state)}

    def scan_step(self, state, inv_temp, seed, step_count, n_sweeps: int):
        table = host_table(metro.acceptance_table, inv_temp)
        full = sg.run_sweeps(*state, table, n_sweeps, seed,
                             (2 * int(step_count)) & rng.MASK32)
        return (full, state[1], state[2])

    def state_arrays(self, state) -> dict:
        return convert.state_to_reference(state, ("lattice", "j_up",
                                                  "j_left"))

    def from_arrays(self, arrays: dict):
        return _whole_planes(self, arrays, ("lattice", "j_up", "j_left"))


def _whole_planes(engine, arrays: dict, keys) -> tuple:
    """The int8 ``(n, m)`` planes ``keys`` of a checkpoint, on the
    engine's device."""
    planes = convert.state_from_reference(arrays, engine.device, keys)
    want = (engine.cfg.n, engine.cfg.m)
    if tuple(planes[0].shape) != want:
        raise ValueError(f"state planes are {tuple(planes[0].shape)}, the "
                         f"lattice needs {want}")
    return planes
