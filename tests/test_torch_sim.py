"""The legacy entry points of the port on the CPU: ``Simulation`` (the
façade over ``Session``), the checkpoint layout before the spec,
``python -m repro_torch.launch.simulate`` and the retired
``repro_torch.launch.serve``.

Against the JAX package: the same ``SimConfig`` from an ordered start at
temperatures whose tables agree gives the same magnetization, energy
and trajectory; a ``Simulation`` checkpoint of either package restores
in the other with an equal ``.config`` and continues to the same digest;
a file that holds ``config_json`` and no spec restores in both."""
import json

import numpy as np
import pytest
import torch

from repro.api import Session as JaxSession
from repro.core import sim as jsim
from repro_torch.api import BatchSpec, RunSpec, Session, load_spec
from repro_torch.core.sim import SimConfig, Simulation
from repro_torch.launch import serve as serve_stub
from repro_torch.launch import simulate

#: engines whose JAX versions run without an interpreted kernel
ENGINES = ("multispin", "basic_philox", "bitplane")


def _config(engine, **kw):
    m = 32 if engine == "multispin" else 16
    kw = {"n": 16, "m": m, "temperature": 2.2, "seed": 13,
          "engine": engine, **kw}
    return kw


@pytest.mark.parametrize("engine", ENGINES)
def test_simulation_equals_the_jax_simulation(engine):
    cfg = _config(engine, init_p_up=1.0)
    mine = Simulation(SimConfig(**cfg), device="cpu")
    theirs = jsim.Simulation(jsim.SimConfig(**cfg))
    assert mine.config == SimConfig(**cfg)
    for sim in (mine, theirs):
        sim.run(3)
        sim.run(2)
    assert mine.step_count == theirs.step_count == 5
    assert mine.magnetization() == float(theirs.magnetization())
    assert mine.energy() == float(theirs.energy())
    np.testing.assert_array_equal(
        mine.full_lattice().numpy(), np.asarray(theirs.full_lattice()))
    np.testing.assert_array_equal(
        mine.trajectory(4, 2, thermalize=1),
        np.asarray(theirs.trajectory(4, 2, thermalize=1)))
    assert mine._session.state_digest() == theirs._session.state_digest()
    assert mine.engine.name == engine


@pytest.mark.parametrize("engine", ENGINES)
@pytest.mark.parametrize("first", ["jax", "port"])
def test_simulation_checkpoint_restores_in_the_other_package(
        tmp_path, engine, first):
    """From a hot start (the packages' fresh lattices differ): the saved
    state, its config and its continuation are the same in both."""
    cfg = _config(engine, tc_block=4, p_ferro=0.25)
    path = str(tmp_path / "sim.npz")
    if first == "jax":
        src = jsim.Simulation(jsim.SimConfig(**cfg))
    else:
        src = Simulation(SimConfig(**cfg), device="cpu")
    src.run(4)
    src.save(path)
    if first == "jax":
        dst = Simulation.restore(path, device="cpu")
        assert dst.config == SimConfig(**cfg)
    else:
        dst = jsim.Simulation.restore(path)
        assert dst.config == jsim.SimConfig(**cfg)
    assert dst.step_count == 4
    src.run(3)
    dst.run(3)
    assert src._session.state_digest() == dst._session.state_digest()


def _legacy_file(tmp_path, cfg):
    """A checkpoint of the layout before the spec: ``config_json``,
    ``step_count`` and the state arrays, written with numpy; and the
    session it was taken from."""
    s = Session.open(RunSpec.from_sim_config(SimConfig(**cfg)), "cpu")
    s.run(3)
    path = str(tmp_path / "legacy.npz")
    np.savez(path, config_json=json.dumps(cfg), step_count=s.step_count,
             **{f"state_{k}": v for k, v in s._runner.state_arrays().items()})
    with np.load(path) as z:
        assert "spec_json" not in z.files
    return path, s


@pytest.mark.parametrize("engine", ENGINES)
def test_config_layout_restores(tmp_path, engine):
    cfg = _config(engine, p_ferro=0.25)
    path, s = _legacy_file(tmp_path, cfg)
    spec = RunSpec.from_sim_config(SimConfig(**cfg))
    assert load_spec(path) == spec
    assert spec.engine.params == ()   # knobs the engine ignores are not
    restored = Session.restore(path, device="cpu")
    sim = Simulation.restore(path, device="cpu")
    jax_restored = JaxSession.restore(path)
    assert sim.config == SimConfig(**cfg)
    s.run(2)
    for r in (restored, sim._session, jax_restored):
        assert r.step_count == 3
        r.run(2)
        assert r.state_digest() == s.state_digest()


def test_from_sim_config_carries_the_declared_params():
    spec = RunSpec.from_sim_config(SimConfig(engine="tensorcore", n=32,
                                             m=32, tc_block=8,
                                             p_ferro=0.3))
    assert spec.engine.param_dict == {"tc_block": 8}
    spec = RunSpec.from_sim_config(SimConfig(engine="spinglass",
                                             p_ferro=0.3))
    assert spec.engine.param_dict == {"p_ferro": 0.3}
    assert spec.mode == "single"


def test_simulation_restore_refuses_an_ensemble_checkpoint(tmp_path):
    spec = RunSpec.from_sim_config(SimConfig(n=16, m=32),
                                   batch=BatchSpec(temperatures=(2.0,)))
    path = str(tmp_path / "e.npz")
    Session.open(spec, "cpu").save(path)
    with pytest.raises(ValueError, match="ensemble"):
        Simulation.restore(path, device="cpu")


def test_simulation_needs_a_card_or_a_device(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Simulation(SimConfig(n=16, m=32))


def _m_lines(out):
    return [line for line in out.splitlines() if line.startswith("sweep")]


@pytest.mark.parametrize("engine", ["multispin", "stencil_pallas"])
def test_simulate_restore_continues_the_uninterrupted_run(
        tmp_path, capsys, engine):
    args = ["--device", "cpu", "--size", "32", "--temp", "2.0",
            "--measure-every", "10", "--engine", engine, "--seed", "5"]
    assert simulate.main(args + ["--sweeps", "30"]) == 0
    whole = capsys.readouterr().out
    ck = str(tmp_path / "ck.npz")
    assert simulate.main(args + ["--sweeps", "20", "--ckpt", ck]) == 0
    first = capsys.readouterr().out
    assert simulate.main(args + ["--sweeps", "30", "--ckpt", ck,
                                 "--restore"]) == 0
    second = capsys.readouterr().out
    assert "restored at sweep 20" in second
    assert len(_m_lines(whole)) == 3
    assert _m_lines(first) + _m_lines(second) == _m_lines(whole)
    for out in (whole, first, second):
        assert out.splitlines()[-1].startswith("flips/ns=")
    assert Simulation.restore(ck, "cpu").step_count == 30


@pytest.mark.parametrize("engine,factory", [
    ("multispin", "make_packed_ising_step"),
    ("basic_philox", "make_ising_step")])
def test_simulate_distributed_on_one_cpu_shard(capsys, monkeypatch, engine,
                                               factory):
    """The distributed step over the mesh's one shard: its planes after
    the run are the single-device run's (the word step's start is in
    half-sweeps, the int8 step's in sweeps)."""
    from repro_torch.core import distributed as dist
    real, last = getattr(dist, factory), []

    def recorded(*args, **kwargs):
        step = real(*args, **kwargs)

        def run(*state_and_args):
            last[:] = step(*state_and_args)
            return tuple(last)
        return run

    monkeypatch.setattr(dist, factory, recorded)
    assert simulate.main(["--device", "cpu", "--size", "32", "--sweeps",
                          "25", "--measure-every", "10", "--engine",
                          engine, "--seed", "9", "--distributed"]) == 0
    assert capsys.readouterr().out.startswith("1 devices: flips/ns=")
    s = Session.open(RunSpec.from_sim_config(SimConfig(
        n=32, m=32, seed=9, engine=engine)), "cpu")
    s.run(25)
    (black,), (white,) = last
    assert torch.equal(black, s.state[0]) and torch.equal(white, s.state[1])


def test_retired_serve_stub_points_at_the_farm(capsys):
    assert serve_stub.main() == 2
    err = capsys.readouterr().err
    assert "python -m repro_torch serve DIR" in err
