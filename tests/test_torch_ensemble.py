"""Ensembles in the port (CPU): a JAX ensemble checkpoint of each
counter-based engine resumes in repro_torch with every member's digest,
the same state arrays and the same samples, and back; member i of a
fresh port ensemble is the port's single-mode run of (T_i, seed_i); the
``BatchSpec`` members, refusals and ``rebind``; the ``Ensemble`` shim's
cases of the JAX package's ``tests/test_ensemble.py``; the command
line's ``--temps/--seeds/--grid``; and the kernels' member axis as the
card runs it: the wrappers' launch loops against a stand-in library that
applies each member's single-member plain version at the member's plane
offset and record, as the CUDA kernels' ``blockIdx.z`` does."""
import ctypes
import dataclasses
import types

import numpy as np
import pytest
import torch

import repro.api as japi
import repro_torch.api as tapi
from repro.analysis.measure import MeasurementPlan as JaxPlan
from repro_torch import __main__ as cli
from repro_torch.analysis import MeasurementPlan, measure_scan_batched
from repro_torch.api import (BatchSpec, EngineSpec, LatticeSpec, MeshSpec,
                             RunSpec, Session)
from repro_torch.core import metropolis, multispin, rng
from repro_torch.core.ensemble import Ensemble
from repro_torch.kernels import _members, _words, resident
from repro_torch.kernels import bitplane as kbp
from repro_torch.kernels import multispin as kms
from repro_torch.kernels import stencil as kst
from repro_torch.kernels.stencil import resident as kst_resident
from repro_torch.kernels.stencil import stencil as kst_update

ENGINES = ("stencil_pallas", "multispin", "multispin_pallas", "bitplane",
           "bitplane_pallas")
N, M = 16, 32
#: parity temperatures (tests/test_torch_session.py) and member seeds of
#: a uint32 key: its top bit, and 2^32 - 1
TEMPS = (1.8, 2.5, 2.2)
SEEDS = (3, 2 ** 31 + 11, 2 ** 32 - 1)
PRE = 2          # sweeps the JAX ensemble makes before it saves
RUN = 3          # sweeps both packages make after the restore
PLAN = dict(n_measure=2, sweeps_between=1, thermalize=1)
TIERS = ("k-sweep", "half-sweep")


def budget(tier):
    return 0 if tier == "half-sweep" else None


def batch_spec(package, engine, temps=TEMPS, seeds=SEEDS, n=N, m=M,
               **batch):
    return package.RunSpec(
        lattice=package.LatticeSpec(n, m),
        engine=package.EngineSpec(engine),
        batch=package.BatchSpec(temperatures=temps, seeds=seeds, **batch))


@pytest.fixture(scope="module", params=ENGINES)
def reference(request, tmp_path_factory):
    """A JAX ensemble checkpoint of one engine at step PRE, and what the
    JAX package computes from it."""
    engine = request.param
    path = str(tmp_path_factory.mktemp(engine) / "jax.npz")
    j = japi.Session.open(batch_spec(japi, engine))
    j.run(PRE)
    j.save(path)
    out = {"engine": engine, "path": path,
           "digests": [j.state_digest(member=i) for i in range(len(TEMPS))],
           "digest": j.state_digest()}
    j = japi.Session.restore(path)
    out["mags"] = j.run(RUN)
    out["run"] = j.state_digest(), j._runner.state_arrays()
    j = japi.Session.restore(path)
    out["measure"] = j.measure(JaxPlan(**PLAN)), j.state_digest()
    return out


def test_reference_checkpoint_restores_with_member_digests(reference):
    s = Session.restore(reference["path"], device="cpu")
    assert s.mode == "ensemble" and s.step_count == PRE
    assert s.state_digest() == reference["digest"]
    assert [s.state_digest(member=i) for i in range(len(TEMPS))] == \
        reference["digests"]


@pytest.mark.parametrize("tier", TIERS)
def test_resume_run_matches_reference(reference, tier):
    s = Session.restore(reference["path"], device="cpu",
                        resident_budget_bytes=budget(tier))
    assert (s.engine.resident_plan is not None) == (tier == "k-sweep")
    mags = s.run(RUN)
    digest, arrays = reference["run"]
    assert s.state_digest() == digest
    got = s._runner.state_arrays()
    assert sorted(got) == sorted(arrays)
    for k in arrays:
        assert got[k].dtype == arrays[k].dtype
        np.testing.assert_array_equal(got[k], arrays[k])
    np.testing.assert_array_equal(mags, reference["mags"])


def test_resume_measure_matches_reference(reference):
    s = Session.restore(reference["path"], device="cpu")
    traj = s.measure(MeasurementPlan(**PLAN))
    want, digest = reference["measure"]
    assert sorted(traj) == sorted(want)
    for k in want:
        assert traj[k].dtype == np.float32
        assert traj[k].shape == np.shape(want[k])
        np.testing.assert_array_equal(traj[k], want[k])
    assert s.state_digest() == digest


def test_port_ensemble_checkpoint_resumes_in_reference(reference, tmp_path):
    """Reverse direction: the JAX ensemble continued by the port, saved,
    continues in the JAX package."""
    s = Session.restore(reference["path"], device="cpu")
    s.run(RUN)
    path = str(tmp_path / "port.npz")
    s.save(path)
    j = japi.Session.restore(path)
    assert j.mode == "ensemble"
    assert j.state_digest() == s.state_digest() == reference["run"][0]
    np.testing.assert_array_equal(j.run(1), s.run(1))
    assert j.state_digest() == s.state_digest()


@pytest.mark.parametrize("engine", ENGINES)
@pytest.mark.parametrize("tier", TIERS)
def test_member_equals_single_mode(engine, tier):
    """Member i of a fresh ensemble follows the single-mode run of
    (T_i, seed_i), its fresh state included."""
    e = Session.open(batch_spec(tapi, engine), device="cpu",
                     resident_budget_bytes=budget(tier))
    fresh = [e.state_digest(member=i) for i in range(len(TEMPS))]
    mags = e.run(RUN)
    assert mags.shape == (len(TEMPS),) and mags.dtype == np.float32
    for i, (t, seed) in enumerate(zip(TEMPS, SEEDS)):
        s = Session.open(RunSpec(lattice=LatticeSpec(N, M),
                                 engine=EngineSpec(engine), temperature=t,
                                 seed=seed), device="cpu",
                         resident_budget_bytes=budget(tier))
        assert s.state_digest() == fresh[i]
        s.run(RUN)
        assert e.state_digest(member=i) == s.state_digest()
        assert float(mags[i]) == s.magnetization()
        assert torch.equal(e.full_lattice()[i], s.full_lattice())


# -- the spec ----------------------------------------------------------------

@pytest.mark.parametrize("grid", [False, True])
def test_members_in_the_reference_order(grid):
    kw = dict(temperatures=(1.5, 2.0, 2.5), seeds=(7, 8, 9), grid=grid)
    port, ref = BatchSpec(**kw), japi.BatchSpec(**kw)
    assert port.members == ref.members
    assert port.size == ref.size == (9 if grid else 3)
    assert port.member_temperatures == ref.member_temperatures
    assert port.member_seeds == ref.member_seeds
    assert BatchSpec((1.9, 2.3)).members == japi.BatchSpec((1.9, 2.3)).members
    spec = RunSpec(lattice=LatticeSpec(N, M), batch=port)
    assert spec.mode == "ensemble"
    cfg = spec.sim_config()
    assert (cfg.temperature, cfg.seed) == port.members[0]


@pytest.mark.parametrize("what,make,match", [
    ("seed 2^32", lambda: RunSpec(batch=BatchSpec((2.0,), (2 ** 32,))),
     "2\\*\\*32"),
    ("tensorcore", lambda: RunSpec(engine=EngineSpec("tensorcore"),
                                   batch=BatchSpec((2.0,))),
     "not counter-based"),
    ("batch + mesh", lambda: RunSpec(batch=BatchSpec((2.0,)),
                                     mesh=MeshSpec((2, 1))),
     "batch \\+ mesh"),
])
def test_refused_batches(what, make, match):
    with pytest.raises(ValueError, match=match):
        make()


# -- rebind --------------------------------------------------------------------

def test_rebind_keeps_engine_and_plan_and_equals_fresh_session():
    spec = batch_spec(tapi, "multispin_pallas")
    e = Session.open(spec, device="cpu")
    e.run(2)
    engine, plan = e.engine, e.engine.resident_plan
    new = dataclasses.replace(spec, batch=BatchSpec((2.0, 2.3, 1.9),
                                                    (4, 5, 6)))
    e._runner.rebind(new)
    assert e.engine is engine and e.engine.resident_plan is plan
    assert e.step_count == 0
    f = Session.open(new, device="cpu")
    assert e.state_digest() == f.state_digest()
    np.testing.assert_array_equal(e._runner.run(RUN), f.run(RUN))
    assert e.state_digest() == f.state_digest()


@pytest.mark.parametrize("change", ["batch size", "lattice", "engine",
                                    "no batch"])
def test_rebind_refuses_another_shape(change):
    spec = batch_spec(tapi, "multispin")
    new = {"batch size": dict(batch=BatchSpec((2.0, 2.3), (4, 5))),
           "lattice": dict(lattice=LatticeSpec(N, 2 * M)),
           "engine": dict(engine=EngineSpec("stencil_pallas")),
           "no batch": dict(batch=None)}[change]
    e = Session.open(spec, device="cpu")
    with pytest.raises(ValueError, match="rebind"):
        e._runner.rebind(dataclasses.replace(spec, **new))


# -- the Ensemble shim: the JAX package's tests/test_ensemble.py cases -------

@pytest.mark.parametrize("engine", ENGINES)
def test_ensemble_member_matches_single_run(engine):
    temps, seeds = [1.8, 2.5], [3, 4]
    ens = Ensemble(16, 16, temps, seeds, engine=engine, device="cpu")
    ens.run(3)
    lattices = ens.full_lattices()
    for i, (temp, seed) in enumerate(zip(temps, seeds)):
        s = Session.open(RunSpec(lattice=LatticeSpec(16, 16),
                                 engine=EngineSpec(engine),
                                 temperature=temp, seed=seed), device="cpu")
        s.run(3)
        assert torch.equal(s.full_lattice(), lattices[i]), f"member {i}"


def test_ensemble_run_returns_magnetization_curve():
    """One call gives m(T): ordered below Tc, disordered far above."""
    ens = Ensemble(32, 32, [1.5, 5.0], seeds=[11, 12], engine="multispin",
                   init_p_up=1.0, device="cpu")
    mags = ens.run(5)
    assert mags.shape == (2,)
    assert abs(mags[0]) > 0.9, mags
    assert abs(mags[1]) < 0.3, mags


def test_ensemble_trajectory_shape_and_offsets():
    ens = Ensemble(16, 16, [2.0, 2.0, 2.0], seeds=[1, 2, 3],
                   engine="multispin", device="cpu")
    samples = ens.trajectory(n_measure=2, sweeps_between=2, thermalize=1)
    assert samples.shape == (2, 3)
    assert ens.step_count == 1 + 2 * 2
    # distinct seeds at the same temperature give distinct trajectories
    assert (ens.full_lattices()[0] != ens.full_lattices()[1]).any()


@pytest.mark.parametrize("engine,match", [("tensorcore", "not counter-based"),
                                          ("wolff", "not counter-based"),
                                          ("spinglass", "not counter-based"),
                                          ("basic", "not counter-based")])
def test_ensemble_rejects_key_based_engines(engine, match):
    with pytest.raises(ValueError, match=match):
        Ensemble(16, 16, [2.0], engine=engine, device="cpu")


def test_ensemble_default_seeds_and_size():
    ens = Ensemble(16, 16, [1.9, 2.3], engine="multispin", device="cpu")
    assert ens.size == 2 and ens.seeds == [0, 1]
    assert ens.run(1).shape == (2,)


def test_ensemble_threads_member0_into_config():
    ens = Ensemble(16, 16, [1.75, 2.5], seeds=[42, 43], engine="multispin",
                   device="cpu")
    assert ens.config.temperature == 1.75
    assert ens.config.seed == 42
    assert ens.config.engine == "multispin"


def test_ensemble_checkpoint_via_shim(tmp_path):
    ens = Ensemble(16, 16, [1.9, 2.4], seeds=[5, 6], engine="multispin",
                   device="cpu")
    ens.run(3)
    path = str(tmp_path / "ens.npz")
    ens.save(path)
    back = Ensemble.restore(path, device="cpu")
    assert back.step_count == ens.step_count
    ens.run(2)
    back.run(2)
    assert torch.equal(ens.full_lattices(), back.full_lattices())
    samples = back.trajectory(n_measure=2, sweeps_between=1)
    assert samples.shape == (2, 2)


def test_ensemble_restore_rejects_single_checkpoint(tmp_path):
    s = Session.open(RunSpec(lattice=LatticeSpec(16, 16)), device="cpu")
    path = str(tmp_path / "single.npz")
    s.save(path)
    with pytest.raises(ValueError, match="'single'"):
        Ensemble.restore(path, device="cpu")


def test_member_digest_needs_an_ensemble_member():
    s = Session.open(RunSpec(lattice=LatticeSpec(16, 16)), device="cpu")
    with pytest.raises(ValueError, match="ensemble mode"):
        s.state_digest(member=0)
    e = Session.open(RunSpec(lattice=LatticeSpec(16, 16),
                             batch=BatchSpec((2.0,))), device="cpu")
    with pytest.raises(ValueError, match="out of range"):
        e.state_digest(member=1)


def test_measure_scan_batched_refuses_key_based_engines():
    engine = types.SimpleNamespace(counter_based=False, name="tensorcore")
    with pytest.raises(ValueError, match="not counter-based"):
        measure_scan_batched(engine, None, [0.5], [1],
                             MeasurementPlan(1, 1))


# -- the command line ----------------------------------------------------------

@pytest.mark.parametrize("grid", [False, True])
def test_cli_runs_an_ensemble(grid, capsys, tmp_path):
    path = str(tmp_path / "e.npz")
    args = ["run", "--device", "cpu", "--n", "16", "--temps", "1.8,2.2",
            "--seeds", "3,4", "--sweeps", "2", "--n-measure", "2",
            "--save", path] + (["--grid"] if grid else [])
    assert cli.main(args) == 0
    out = capsys.readouterr().out
    members = BatchSpec((1.8, 2.2), (3, 4), grid=grid).members
    for i, (t, seed) in enumerate(members):
        assert f"member {i} T={t:g} seed={seed}: |m| = " in out
        assert f"member {i} T={t:g} seed={seed}: m_mean=" in out
    s = Session.restore(path, device="cpu")
    assert s.mode == "ensemble" and s.step_count == 4
    assert s.spec.batch.members == members


# -- the member axis as the card runs it -----------------------------------------

def _plane(ptr: int, shape, dtype):
    """A tensor over ``prod(shape)`` elements of memory at ``ptr``."""
    ctype = {torch.int8: ctypes.c_int8, torch.int32: ctypes.c_int32}[dtype]
    count = int(np.prod(shape))
    return torch.from_numpy(np.ctypeslib.as_array(
        (ctype * count).from_address(ptr)).reshape(shape))


def _seed(keys, z: int) -> int:
    return int(keys[2 * z]) | int(keys[2 * z + 1]) << 32


class _CardLike:
    """A stand-in for a family's library: each launch function runs the
    member loop of the card's grid (blockIdx.z = z < members) on the
    planes at the member's offset z n w, with the member's record read
    from the launch's argument arrays, which must be the marshalled
    record of that member's table; the update is the family's
    single-member plain version."""

    def __init__(self, family, tables, limit):
        self.family, self.tables, self.limit = family, tables, limit
        self.first = 0   # the member of the next launch's z = 0
        self.dtype = torch.int8 if family == "stencil" else torch.int32
        setattr(self, f"{family}_max_members", lambda: limit)
        setattr(self, f"{family}_update_launch", self._update)
        setattr(self, f"{family}_sweeps_resident_launch", self._sweeps)

    def _record(self, args, z):
        """The member's table, after checking its record."""
        table = self.tables[self.first + z]
        if self.family == "stencil":
            want = list(kst_update.bounds_arg(table))
            got = list(args[0][10 * z:10 * z + 10])
        elif self.family == "multispin":
            want = list((_words.thresholds_arg if self.update
                         else _words.key_table_arg)(table))
            got = list(args[0][len(want) * z:len(want) * (z + 1)])
        else:
            array, count = args
            want = list(_words.accept_args([table])[0]) if count == 2 \
                else list(_words.thresholds_arg(table))
            got = list(array[count * z:count * (z + 1)])
        assert got == want, f"member {self.first + z}'s record"
        return table

    def _bounds(self, ptr, members):
        return np.ctypeslib.as_array(
            (ctypes.c_uint64 * (10 * members)).from_address(ptr))

    def _update(self, t_ptr, o_ptr, n, w, is_black, *rest):
        *args, keys, members, offset, _ = rest
        if self.family == "stencil":
            args = [self._bounds(args[0], members)]
        self.update = True
        size = (1 if self.family == "stencil" else 4) * n * w
        plain = getattr(kst if self.family == "stencil" else
                        kms if self.family == "multispin" else kbp,
                        f"{self.family}_update_plain")
        for z in range(members):
            t = _plane(t_ptr + z * size, (n, w), self.dtype)
            o = _plane(o_ptr + z * size, (n, w), self.dtype)
            t.copy_(plain(t, o, self._record(args, z),
                          is_black=bool(is_black), seed=_seed(keys, z),
                          offset=offset))
        self._next(members)
        return 0

    def _next(self, members):
        """The members of a launch done; the last launch of a block of
        sweeps (or a half-sweep) goes back to member 0."""
        self.first += members
        if self.first == len(self.tables):
            self.first = 0

    def _sweeps(self, b_ptr, w_ptr, bo_ptr, wo_ptr, n, w, *rest):
        *args, keys, members, start, k, _tr, _tc, _threads, _ = rest
        self.update = False
        size = (1 if self.family == "stencil" else 4) * n * w
        plain = getattr(kst if self.family == "stencil" else
                        kms if self.family == "multispin" else kbp,
                        f"{self.family}_sweeps_resident_plain")
        for z in range(members):
            b, wp = (_plane(p + z * size, (n, w), self.dtype)
                     for p in (b_ptr, w_ptr))
            got = plain(b, wp, self._record(args, z), n_sweeps=k,
                        seed=_seed(keys, z), start_offset=start)
            for p, new in zip((bo_ptr, wo_ptr), got):
                _plane(p + z * size, (n, w), self.dtype).copy_(new)
        self._next(members)
        return 0


def _batch(family, members, n, w, seed):
    r = np.random.default_rng(seed)
    if family == "stencil":
        return tuple(torch.tensor(np.where(r.random((members, n, w)) < 0.5,
                                           1, -1).astype(np.int8))
                     for _ in range(2))
    mask = 0x11111111 if family == "multispin" else 0xFFFFFFFF
    return tuple(torch.tensor((r.integers(0, 2 ** 32, (members, n, w),
                                          dtype=np.uint64) & mask)
                              .astype(np.uint32).view(np.int32))
                 for _ in range(2))


def _tables(family, accept):
    make = metropolis.acceptance_table if family == "stencil" \
        else multispin.acceptance_thresholds
    tables = [make(1.0 / t) for t in TEMPS]
    if accept == "general":
        tables[0] = tables[0][torch.tensor((3, 8, 1, 0, 9, 5, 7, 2, 4, 6))]
    return tables


#: (family, accept, members a launch at the most); limit 2 splits the 3
#: members into two launches
MEMBER_AXIS_CASES = [(f, a, lim) for f in ("stencil", "multispin",
                                           "bitplane")
                     for a in (("three", "general") if f == "bitplane"
                               else ("three",))
                     for lim in (64, 2)]


@pytest.fixture
def card_like(monkeypatch):
    """Route a family's wrappers to a :class:`_CardLike` library (the
    planes stay on the CPU, the stream is 0)."""
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda device=None: types.SimpleNamespace(
                            cuda_stream=0))

    def install(family, tables, limit):
        lib = _CardLike(family, tables, limit)
        for mod in ((kst_update, kst_resident) if family == "stencil"
                    else (kms.multispin, kms.resident) if family ==
                    "multispin" else (kbp.bitplane, kbp.resident)):
            monkeypatch.setattr(mod, "library", lambda: lib)
        return lib
    return install


@pytest.mark.parametrize("family,accept,limit", MEMBER_AXIS_CASES)
def test_update_member_axis_as_the_card_runs_it(card_like, family, accept,
                                                limit):
    tables = _tables(family, accept)
    card_like(family, tables, limit)
    n, w = (13, 12) if family != "multispin" else (13, 5)
    t, o = _batch(family, 3, n, w, limit)
    want = getattr(kst if family == "stencil" else kms if family ==
                   "multispin" else kbp, f"{family}_update_batched_plain")(
        t, o, tables, is_black=False, seeds=SEEDS, offset=2 ** 32 - 1)
    wrapper = getattr(kst if family == "stencil" else kms if family ==
                      "multispin" else kbp, f"{family}_update")
    before = wrapper.launches
    got = _launch_update(family, t.clone(), o, tables)
    assert torch.equal(got, want)
    assert wrapper.launches - before == -(-3 // limit)


def _launch_update(family, t, o, tables):
    if family == "stencil":
        return kst_update._launch_update(t, o, tables, is_black=False,
                                         seeds=list(SEEDS),
                                         offset=2 ** 32 - 1)
    lib = (kms.multispin if family == "multispin" else kbp.bitplane).library()
    wrapper = getattr(kms if family == "multispin" else kbp,
                      f"{family}_update")
    return _words.launch_update(lib, family, wrapper, t, o, tables,
                                is_black=False, seeds=list(SEEDS),
                                offset=2 ** 32 - 1)


@pytest.mark.parametrize("family,accept,limit", MEMBER_AXIS_CASES)
def test_sweeps_member_axis_as_the_card_runs_it(card_like, family, accept,
                                                limit):
    tables = _tables(family, accept)
    card_like(family, tables, limit)
    n = 13
    w = {"stencil": 12, "multispin": 5, "bitplane": 12}[family]
    divisor = resident.GEOMETRY[family].col_divisor
    plan = dataclasses.replace(
        resident.plan_resident(family, n + 1, w * divisor), n=n, k=2)
    b, wp = _batch(family, 3, n, w, limit + 1)
    mod = kst if family == "stencil" else kms if family == "multispin" \
        else kbp
    want = getattr(mod, f"{family}_sweeps_resident_batched_plain")(
        b, wp, tables, n_sweeps=3, seeds=SEEDS, start_offset=2 ** 32 - 3)
    wrapper = getattr(mod, f"{family}_sweeps_resident")
    before = (wrapper.launches, getattr(wrapper, "general_launches", 0))
    if family == "stencil":
        got = kst_resident._launch(b, wp, tables, n_sweeps=3,
                                   seeds=list(SEEDS),
                                   start_offset=2 ** 32 - 3, plan=plan)
    else:
        got = _words.launch_resident(
            mod.resident.library(), family, wrapper, b, wp, tables,
            n_sweeps=3, seeds=list(SEEDS), start_offset=2 ** 32 - 3,
            plan=plan)
    for a, c in zip(got, want):
        assert torch.equal(a, c)
    # ceil(3 / k) = 2 blocks of sweeps, each ceil(3 / limit) launches;
    # a launch takes the general accept where one of its members' tables
    # needs it: the shuffled table of member 0, in each block's first
    assert wrapper.launches - before[0] == 2 * -(-3 // limit)
    if family == "bitplane":
        assert getattr(wrapper, "general_launches") - before[1] == (
            2 if accept == "general" else 0)


@pytest.mark.parametrize("family", ["stencil", "multispin", "bitplane"])
def test_batched_plain_is_each_member_plain(family):
    """The plain batched versions, and the batched wrappers on CPU
    planes, are the single-member plain versions member by member."""
    tables = _tables(family, "three")
    mod = kst if family == "stencil" else kms if family == "multispin" \
        else kbp
    w = 5 if family == "multispin" else 12
    b, wp = _batch(family, 3, 11, w, 9)
    got = getattr(mod, f"{family}_sweeps_resident_batched_plain")(
        b, wp, tables, n_sweeps=2, seeds=SEEDS, start_offset=7)
    t = getattr(mod, f"{family}_update_batched")(
        b.clone(), wp, tables, is_black=True, seeds=SEEDS, offset=9)
    for i in range(3):
        one = getattr(mod, f"{family}_sweeps_resident_plain")(
            b[i], wp[i], tables[i], n_sweeps=2, seed=SEEDS[i],
            start_offset=7)
        assert torch.equal(got[0][i], one[0])
        assert torch.equal(got[1][i], one[1])
        assert torch.equal(t[i], getattr(mod, f"{family}_update_plain")(
            b[i], wp[i], tables[i], is_black=True, seed=SEEDS[i], offset=9))


def test_member_arguments():
    """Key pairs a member, launch chunks by the library's limit, and the
    bitplane accept of a batch: three-threshold only where every table
    has a ferromagnet's layout."""
    keys = list(_members.keys_arg([2 ** 32 - 1, 2 ** 33 + 5]))
    assert keys == [2 ** 32 - 1, 0, *rng.seed_keys(2 ** 33 + 5)]
    lib = types.SimpleNamespace(bitplane_max_members=lambda: 2)
    assert _members.member_chunks(lib, "bitplane", 5) == [(0, 2), (2, 4),
                                                          (4, 5)]
    three = _tables("bitplane", "three")
    assert _words.accept_args(three)[1] == 2
    assert _words.accept_args(_tables("bitplane", "general"))[1] == 10
    with pytest.raises(ValueError, match="as many tables"):
        kbp.bitplane_update_batched(*_batch("bitplane", 3, 4, 4, 0),
                                    three[:2], is_black=True, seeds=SEEDS,
                                    offset=0)
