"""The engines of plain updates and their draws (CPU): ``basic_philox``
resumes a JAX checkpoint to the JAX package's digest in single mode, as
an ensemble and on a 2 x 2 mesh, and equals ``stencil_pallas``; ``basic``
equals ``basic_philox``, and ``metropolis.update_color`` (both rules)
equals the JAX function on JAX's uniforms; ``philox_fill``'s plain
version, its checks and its launch loop as the card runs it; the
registry, the front door and ``describe`` of the four engines."""
import ctypes
import json
import types
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.api as japi
import repro_torch.api as tapi
from repro.core import engine as jengine
from repro.core import lattice as jlat
from repro.core import metropolis as jmetro
from repro_torch import __main__ as cli
from repro_torch.api import BatchSpec, MeshSpec, RunSpec, Session, describe
from repro_torch.core import engine, metropolis, rng
from repro_torch.kernels import draws

N, M = 16, 32
#: a temperature whose acceptance tables are the JAX package's entry for
#: entry (tests/test_torch_session.py)
TEMPERATURE = 2.2
SEED = 2 ** 35 + 3
PRE = 3          # sweeps the JAX run makes before it saves
RUN = 4          # sweeps the port makes after the restore
TEMPS = (1.8, 2.5, 2.2)
SEEDS = (3, 2 ** 31 + 11, 2 ** 32 - 1)
NEW_ENGINES = ("basic", "basic_philox", "spinglass", "wolff")


def spec_of(package, engine_name="basic_philox", **kw):
    kw.setdefault("temperature", TEMPERATURE)
    kw.setdefault("seed", SEED)
    return package.RunSpec(lattice=package.LatticeSpec(N, M),
                           engine=package.EngineSpec(engine_name), **kw)


@pytest.fixture(scope="module")
def jax_runs(tmp_path_factory):
    """JAX ``basic_philox`` checkpoints (single mode, an ensemble of 3)
    after PRE sweeps, and the JAX digests after RUN more."""
    root = tmp_path_factory.mktemp("basic_philox")
    out = {}
    for mode, spec in (("single", spec_of(japi)),
                       ("ensemble", spec_of(
                           japi, batch=japi.BatchSpec(TEMPS, SEEDS)))):
        s = japi.Session.open(spec)
        s.run(PRE)
        path = str(root / f"{mode}.npz")
        s.save(path)
        s.run(RUN)
        out[mode] = (path, s.state_digest(),
                     [s.state_digest(member=i) for i in range(3)]
                     if mode == "ensemble" else None)
    return out


def test_basic_philox_single_resumes_to_the_jax_digest(jax_runs):
    path, want, _ = jax_runs["single"]
    s = Session.restore(path, device="cpu")
    s.run(RUN)
    assert s.state_digest() == want


def test_basic_philox_ensemble_resumes_to_the_jax_digests(jax_runs):
    path, want, members = jax_runs["ensemble"]
    s = Session.restore(path, device="cpu")
    assert s.mode == "ensemble"
    s.run(RUN)
    assert s.state_digest() == want
    assert [s.state_digest(member=i) for i in range(3)] == members


def test_basic_philox_mesh_resumes_to_the_jax_digest(jax_runs):
    path, want, _ = jax_runs["single"]
    s = Session.restore(path, device="cpu",
                        mesh=MeshSpec((2, 2), ("data", "model")))
    assert s.mode == "sharded" and s.shard_plan is None
    s.run(RUN)
    assert s.state_digest() == want


@pytest.mark.parametrize("budget", [None, 0])
def test_basic_philox_equals_stencil_pallas(budget):
    """The oracle and the kernel engine from one spec, either tier of
    the kernel engine: one digest, one sample trajectory."""
    want = Session.open(spec_of(tapi), device="cpu")
    got = Session.open(spec_of(tapi, "stencil_pallas"), device="cpu",
                       resident_budget_bytes=budget)
    for s in (want, got):
        s.run(5)
    assert got.state_digest() == want.state_digest()
    plan = dict(n_measure=2, sweeps_between=2, thermalize=1)
    from repro_torch.analysis import MeasurementPlan
    a, b = (s.measure(MeasurementPlan(**plan)) for s in (want, got))
    assert all(np.array_equal(a[k], b[k]) for k in a)


def test_basic_equals_basic_philox():
    a = Session.open(spec_of(tapi, "basic"), device="cpu")
    b = Session.open(spec_of(tapi), device="cpu")
    for s in (a, b):
        s.run(6)
    assert torch.equal(a.full_lattice(), b.full_lattice())
    assert a.state_digest() == b.state_digest()


def test_basic_restore_continues_bit_for_bit(tmp_path):
    s = Session.open(spec_of(tapi, "basic"), device="cpu")
    s.run(3)
    s.save(str(tmp_path / "b.npz"))
    r = Session.restore(str(tmp_path / "b.npz"), device="cpu")
    s.run(4)
    r.run(4)
    assert s.state_digest() == r.state_digest()


@pytest.mark.parametrize("rule,temperature", [("metropolis", 2.2),
                                              ("metropolis", 1.5),
                                              ("heatbath", 2.2),
                                              ("heatbath", 1.0)])
@pytest.mark.parametrize("is_black", [True, False])
def test_update_color_equals_jax_on_jax_uniforms(rule, temperature,
                                                  is_black):
    """``metropolis.update_color`` with the port's table (each rule, the
    table entries the JAX package's ``exp``/``sigmoid`` of the same float32
    arguments) flips what the JAX function flips on the same uniforms."""
    beta = np.float32(1.0 / temperature)
    args = jnp.asarray(metropolis.acceptance_arguments(beta))
    jtable = np.asarray(jnp.exp(args) if rule == "metropolis"
                        else jax.nn.sigmoid(args))
    table = metropolis.acceptance_table(beta, rule=rule)
    assert np.array_equal(table.numpy(), jtable)
    rs = np.random.default_rng(7)
    target = np.where(rs.random((N, M // 2)) < 0.5, 1, -1).astype(np.int8)
    op = np.where(rs.random((N, M // 2)) < 0.6, 1, -1).astype(np.int8)
    u = rs.random((N, M // 2), dtype=np.float32)
    want = jmetro.update_color(jnp.asarray(target), jnp.asarray(op),
                               jnp.asarray(u), jnp.float32(beta), is_black,
                               rule=rule)
    got = metropolis.update_color(torch.from_numpy(target),
                                  torch.from_numpy(op), torch.from_numpy(u),
                                  table, is_black)
    assert np.array_equal(got.numpy(), np.asarray(want))


def test_heatbath_table_is_the_sigmoid():
    args = metropolis.acceptance_arguments(0.5).astype(np.float64)
    want = (1.0 / (1.0 + np.exp(-args))).astype(np.float32)
    got = metropolis.acceptance_table(0.5, rule="heatbath").numpy()
    assert np.array_equal(got, want)
    with pytest.raises(ValueError, match="rule"):
        metropolis.acceptance_table(0.5, rule="glauber")


def test_run_sweeps_is_run_sweeps_philox():
    """``basic``'s loop (``metropolis.run_sweeps``: whole planes drawn
    first, then the update) and the ``basic`` engine's sweeps (its draws
    through ``philox_fill``) give one trajectory."""
    full = torch.from_numpy(np.array(jlat.init_lattice(
        jax.random.PRNGKey(1), N, M)))
    from repro_torch.core import lattice as lat
    from repro_torch.core.sim import SimConfig
    b, w = lat.split_checkerboard(full)
    table = metropolis.acceptance_table(1 / 2.5)
    a = metropolis.run_sweeps(b, w, table, 3, SEED, start_offset=7)
    basic = engine.make_engine(SimConfig(n=N, m=M, temperature=2.5,
                                         seed=SEED, engine="basic"), "cpu")
    c = basic.sweep_fn((b, w), 1 / 2.5, SEED, 7, 3)
    assert all(torch.equal(x, y) for x, y in zip(a, c))


# -- philox_fill: the plain version, checks, the launch loop ---------------

def _reference_lanes(seed, offset, c1, index, c3):
    k0, k1 = rng.seed_keys(seed)
    bits = rng.philox4x32(offset, c1, torch.as_tensor(index,
                                                      dtype=torch.int64)
                          & rng.MASK32, c3, k0, k1)
    return torch.stack([rng.u32_to_uniform(b) for b in bits])


@pytest.mark.parametrize("c1,c3,offset", [(0, 0, 5), (2, 7, 2 ** 32 - 1),
                                          (3, 0, 0), (1, 3, 2 ** 31)])
@pytest.mark.parametrize("lanes", [1, 2])
def test_philox_fill_plain_is_philox(c1, c3, offset, lanes):
    seeds = [SEED, 7, 2 ** 32 - 1]
    got = draws.philox_fill(seeds, offset, shape=(5, 6), device="cpu",
                            c1=c1, c3=c3, lanes=lanes)
    assert got.shape == (lanes, 3, 5, 6) and got.dtype == torch.float32
    for b, seed in enumerate(seeds):
        want = _reference_lanes(seed, offset, c1, torch.arange(30), c3)
        assert torch.equal(got[:, b].reshape(lanes, -1), want[:lanes])


@pytest.mark.parametrize("lanes", [1, 2])
@pytest.mark.parametrize("dtype", [torch.int32, torch.int64])
def test_philox_fill_index_plane(dtype, lanes):
    idx = torch.tensor([[0, 7, 2 ** 31 + 5], [2 ** 32 - 1, 3, 9]],
                       dtype=torch.int64)
    index = idx if dtype == torch.int64 else draws._index_int32(idx)
    got = draws.philox_fill([SEED, 11], 9, index=index, c1=2, c3=4,
                            lanes=lanes)
    for b, seed in enumerate((SEED, 11)):
        want = _reference_lanes(seed, 9, 2, idx.reshape(-1), 4)[:lanes]
        assert torch.equal(got[:, b].reshape(lanes, -1), want)


def test_philox_fill_uniforms_match_the_sweep_draws():
    """Lane 0 at c1 = c3 = 0 is ``metropolis.philox_uniforms``, the
    draws of every Metropolis kernel."""
    got = draws.uniforms((7, 9), SEED, 123, "cpu")
    assert torch.equal(got, metropolis.philox_uniforms(7, 9, SEED, 123,
                                                       "cpu"))


@pytest.mark.parametrize("kwargs,match", [
    (dict(shape=(4, 4), lanes=5), "lanes"),
    (dict(shape=(4, 4), lanes=4), "lanes"),
    (dict(shape=(4, 4), lanes=3), "lanes"),
    (dict(shape=(4, 4), lanes=0), "lanes"),
    (dict(shape=(0, 4)), "non-empty"),
    (dict(index=torch.zeros(3, dtype=torch.float32)), "int32 or int64"),
])
def test_philox_fill_rejects_bad_arguments(kwargs, match):
    with pytest.raises(ValueError, match=match):
        draws.philox_fill([1], 0, device="cpu", **kwargs)
    with pytest.raises(ValueError, match="at least one"):
        draws.philox_fill([], 0, shape=(2, 2), device="cpu")


class _FillLike:
    """A stand-in for ``csrc/draws.cu``: ``philox_fill_launch`` runs the
    member loop of the card's grid (blockIdx.z = z < members), member z's
    keys from its record, writing lane l of element i at ``out + 4 (l
    lane_stride + z count + i)``; the draws are ``rng.philox4x32``'s."""

    def __init__(self, limit):
        self.limit = limit
        self.draws_max_members = lambda: limit

    def cuda_error_string(self, rc):
        return b"error"

    def philox_fill_launch(self, out, index, count, lane_stride, lanes,
                           members, keys, offset, c1, c3, stream):
        buf = np.ctypeslib.as_array(
            (ctypes.c_float * ((lanes - 1) * lane_stride + members * count))
            .from_address(out))
        if index is None:
            sites = torch.arange(count)
        else:
            sites = torch.from_numpy(np.ctypeslib.as_array(
                (ctypes.c_int32 * count).from_address(index)).copy())
        for z in range(members):
            k0, k1 = keys[2 * z], keys[2 * z + 1]
            bits = rng.philox4x32(offset, c1, sites.to(torch.int64)
                                  & rng.MASK32, c3, k0, k1)
            for lane in range(lanes):
                lo = lane * lane_stride + z * count
                buf[lo:lo + count] = rng.u32_to_uniform(bits[lane]).numpy()
        return 0


@pytest.mark.parametrize("limit,lanes,indexed", [(2, 1, False), (2, 2, True),
                                                 (5, 2, False),
                                                 (1, 1, True)])
def test_philox_fill_launch_loop_as_the_card_runs_it(monkeypatch, limit,
                                                     lanes, indexed):
    """The wrapper's launches: ceil(B / limit) of them, each at its first
    member's lane-0 plane with the buffer's lane stride, give the plain
    version's planes; each launch counted."""
    lib = _FillLike(limit)
    monkeypatch.setattr(draws, "library", lambda: lib)
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda device=None: types.SimpleNamespace(
                            cuda_stream=0))
    seeds = [SEED, 7, 2 ** 31 + 11, 2 ** 32 - 1, 5]
    shape = (3, 4)
    index = draws._index_int32(
        torch.arange(12, dtype=torch.int64).reshape(shape) * 977
        + 2 ** 31) if indexed else None
    out = torch.empty((lanes, len(seeds), *shape), dtype=torch.float32)
    before = draws.philox_fill.launches
    draws._launch_fill(out, index, seeds, 2 ** 32 - 2, 2, 3)
    assert draws.philox_fill.launches - before == -(-len(seeds) // limit)
    want = draws.philox_fill_plain(
        seeds, 2 ** 32 - 2, shape=shape if index is None else None,
        index=index, device="cpu", c1=2, c3=3, lanes=lanes)
    assert torch.equal(out, want)


def test_philox_fill_raises_on_other_devices():
    with pytest.raises(ValueError, match="unsupported device"):
        draws.philox_fill([1], 0, shape=(2, 2), device="xpu")
    # meta tensors take the plain version (shapes only, the dry-run's)
    before = draws.philox_fill.launches
    out = draws.philox_fill([1, 2], 0, shape=(2, 3), device="meta")
    assert out.device.type == "meta" and out.shape == (1, 2, 2, 3)
    assert draws.philox_fill.launches == before


# -- registry and front door -----------------------------------------------

def test_registry_holds_the_jax_packages_ten_engines():
    assert sorted(engine.ENGINES) == sorted(jengine.ENGINES)
    assert len(engine.ENGINES) == 10
    with pytest.raises(ValueError, match="not ported") as err:
        engine.engine_class("potts")
    for name in jengine.ENGINES:
        assert name in str(err.value)


@pytest.mark.parametrize("name", NEW_ENGINES)
def test_new_engines_flags_are_the_jax_packages(name):
    ours, theirs = engine.ENGINES[name], jengine.ENGINES[name]
    assert ours.counter_based == theirs.counter_based
    assert ours.dist_factory == theirs.dist_factory
    assert ours.param_fields == theirs.param_fields


@pytest.mark.parametrize("name", ["basic", "spinglass", "wolff"])
def test_key_based_engines_refuse_a_batch_and_a_mesh(name):
    with pytest.raises(ValueError, match="not counter-based"):
        spec_of(tapi, name, batch=BatchSpec((2.0, 2.5)))
    with pytest.raises(ValueError, match="no distributed step"):
        spec_of(tapi, name, mesh=MeshSpec((2, 2), ("data", "model")))


@pytest.mark.parametrize("name,mode", [(e, "single") for e in NEW_ENGINES]
                         + [("basic_philox", "ensemble"),
                            ("basic_philox", "mesh")])
def test_describe_of_the_new_engines_equals_jax(name, mode):
    kw = {}
    if mode == "ensemble":
        kw["batch"] = {"temperatures": [2.0, 2.2], "seeds": [3, 4],
                       "grid": False}
    if mode == "mesh":
        kw["mesh"] = {"shape": [2, 2], "axis_names": ["data", "model"]}
    params = {"p_ferro": 0.7} if name == "spinglass" else {}
    doc = {"lattice": {"n": 64, "m": 64, "init_p_up": 1.0},
           "engine": {"name": name, "params": params},
           "temperature": 2.2, "seed": 5, **kw}
    ours = describe(RunSpec.from_dict(doc))
    theirs = japi.describe(japi.RunSpec.from_dict(doc))
    assert ours.keys() == theirs.keys()
    for k in ours.keys() - {"dist"}:
        assert ours[k] == theirs[k], k
    assert ours["resident"] is None
    json.dumps(ours)


@pytest.mark.parametrize("value,ok", [(0.7, True), (1, True), (0.0, True),
                                      (1.5, False), (-0.1, False),
                                      (True, False), ("0.5", False)])
def test_p_ferro_is_validated_as_in_jax(value, ok):
    doc = {"engine": {"name": "spinglass", "params": {"p_ferro": value}}}
    if ok:
        assert RunSpec.from_dict(doc).engine.param_dict["p_ferro"] == \
            japi.RunSpec.from_dict(doc).engine.param_dict["p_ferro"]
    else:
        with pytest.raises(ValueError, match="p_ferro"):
            RunSpec.from_dict(doc)
    with pytest.raises(ValueError, match="takes no params"):
        RunSpec.from_dict({"engine": {"name": "wolff",
                                      "params": {"p_ferro": 0.5}}})


@pytest.mark.parametrize("name", NEW_ENGINES)
def test_cli_runs_each_new_engine(name, capsys, tmp_path):
    argv = ["run", "--device", "cpu", "--engine", name, "--n", "16",
            "--init-p-up", "1.0", "--temperature", "1.8", "--sweeps", "3",
            "--save", str(tmp_path / "ck.npz")]
    if name == "spinglass":
        argv += ["--p-ferro", "0.7"]
    assert cli.main(argv) == 0
    assert "ran 3 sweeps" in capsys.readouterr().out
    restored = Session.restore(str(tmp_path / "ck.npz"), device="cpu")
    assert restored.step_count == 3
    if name == "spinglass":
        assert restored.spec.engine.param_dict == {"p_ferro": 0.7}
        assert restored._runner.cfg.p_ferro == 0.7


def test_cli_p_ferro_reaches_the_couplings(tmp_path):
    """--p-ferro 1 gives all-ferromagnetic bonds, 0 all antiferromagnetic."""
    for p, sign in ((1.0, 1), (0.0, -1)):
        path = str(tmp_path / f"sg{p}.npz")
        assert cli.main(["run", "--device", "cpu", "--engine", "spinglass",
                         "--p-ferro", str(p), "--n", "16", "--sweeps", "1",
                         "--save", path]) == 0
        _, j_up, j_left = Session.restore(path, device="cpu").state
        assert bool((j_up == sign).all()) and bool((j_left == sign).all())


# -- the JAX-written checkpoint that chip_smoke.py continues on the card ---

DATA = Path(__file__).resolve().parent / "data" / "torch_port"


def test_committed_jax_checkpoint_is_the_jax_packages():
    """The file's record is what the JAX package computes now (its
    generator's run, saved and continued)."""
    import importlib.util
    spec = importlib.util.spec_from_file_location(
        "make_jax_checkpoint", DATA / "make_jax_checkpoint.py")
    gen = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(gen)
    record = json.loads((DATA / "basic_philox_512.json").read_text())
    s, fresh = gen.run()
    assert fresh["saved_digest"] == record["saved_digest"]
    assert japi.Session.restore(str(DATA / "basic_philox_512.npz")) \
        .state_digest() == record["saved_digest"]
    s.run(record["sweeps"])
    assert s.state_digest() == record["digest"]


def test_committed_jax_checkpoint_continues_in_the_port():
    record = json.loads((DATA / "basic_philox_512.json").read_text())
    s = Session.restore(str(DATA / "basic_philox_512.npz"), device="cpu")
    assert s.state_digest() == record["saved_digest"]
    s.run(record["sweeps"])
    assert s.state_digest() == record["digest"]
