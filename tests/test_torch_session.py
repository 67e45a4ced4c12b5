"""The port as a whole: a ``stencil_pallas``, ``multispin_pallas`` or
``bitplane_pallas`` run saved by the JAX package resumes in repro_torch
(CPU) with the same ``state_digest`` and samples after the same sweeps,
through either tier; a run saved by repro_torch resumes in the JAX
package; a fresh word-plane session packs the single-lattice init; the
entry points raise where no GPU exists and none was asked for; the
package imports neither ``jax`` nor ``repro``."""
import contextlib
import os
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import repro.api as japi
import repro.kernels.resident as jresident
from repro.analysis.measure import MeasurementPlan as JaxPlan
from repro.core import observables as jobs  # noqa: F401  (JAX on the CPU)
from repro_torch import __main__ as cli
from repro_torch.analysis import MeasurementPlan
from repro_torch.api import EngineSpec, LatticeSpec, RunSpec, Session
from repro_torch.core import metropolis

ROOT = Path(__file__).resolve().parent.parent
N, M = 16, 32
TEMPERATURE = 2.2
SEED = 2 ** 35 + 3
PRE = 3          # sweeps the JAX run makes before it saves
RUN = 4          # sweeps both packages make after the restore
PLAN = dict(n_measure=3, sweeps_between=2, thermalize=1)
TIERS = ("k-sweep", "half-sweep")


def jax_spec():
    return japi.RunSpec(lattice=japi.LatticeSpec(N, M),
                        engine=japi.EngineSpec("stencil_pallas"),
                        temperature=TEMPERATURE, seed=SEED)


@contextlib.contextmanager
def jax_tier(tier):
    """The JAX package's per-half-sweep tier, reached the way its own
    tests reach it: a VMEM budget nothing fits."""
    saved = jresident.VMEM_BUDGET_BYTES
    if tier == "half-sweep":
        jresident.VMEM_BUDGET_BYTES = 0
    try:
        yield
    finally:
        jresident.VMEM_BUDGET_BYTES = saved


def port_budget(tier):
    """The port's planner budget for a tier: 0 reaches the per-half-sweep
    tier, ``None`` leaves the card's budget."""
    return 0 if tier == "half-sweep" else None


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    """A JAX checkpoint at step PRE, and what the JAX package computes
    from it on each of its tiers."""
    path = str(tmp_path_factory.mktemp("reference") / "jax.npz")
    s = japi.Session.open(jax_spec())
    s.run(PRE)
    s.save(path)
    out = {"path": path, "digest": s.state_digest()}
    for tier in TIERS:
        with jax_tier(tier):
            r = japi.Session.restore(path)
            assert (r.engine.resident_plan is not None) == (tier == "k-sweep")
            r.run(RUN)
            out[tier, "run"] = r.state_digest()
            r = japi.Session.restore(path)
            traj = r.measure(JaxPlan(**PLAN))
            out[tier, "measure"] = (traj, r.state_digest())
    return out


def reference_table(beta):
    """The JAX package's accept values: jnp.exp of the same float32
    arguments."""
    import jax.numpy as jnp
    return np.asarray(jnp.exp(jnp.asarray(
        metropolis.acceptance_arguments(beta))))


def test_port_table_equals_reference_table_at_test_temperature():
    """The premise of the digest tests: at T = 2.2 the port's host table
    equals the table of jnp.exp over the same float32 arguments."""
    beta = 1.0 / TEMPERATURE
    np.testing.assert_array_equal(metropolis.acceptance_table(beta).numpy(),
                                  reference_table(beta))


#: temperatures at which the port's table decides every flip as
#: jnp.exp's does, so that a run follows the JAX trajectory bit for bit
#: (ROADMAP Queue 3 lists the others); 2.0 is the temperature of
#: chip_smoke.py's full-size run
PARITY_TEMPERATURES = (1.5, 1.8, 2.0, 2.1, 2.2, 2.269, 2.3, 2.5)


def flip_decisions(table):
    """The part of a table that decides flips: an entry above 1 accepts
    every uniform in [0, 1], whatever its value (at T = 2.0 the two
    tables differ by one ulp in exp(+4) only)."""
    return np.where(table > 1, np.inf, table)


@pytest.mark.parametrize("temperature", PARITY_TEMPERATURES)
def test_port_table_equals_reference_table_at_parity_temperatures(
        temperature):
    beta = 1.0 / temperature
    np.testing.assert_array_equal(
        flip_decisions(metropolis.acceptance_table(beta).numpy()),
        flip_decisions(reference_table(beta)))


def test_reference_checkpoint_restores_with_its_digest(reference):
    s = Session.restore(reference["path"], device="cpu")
    assert s.step_count == PRE and s.device.type == "cpu"
    assert s.state_digest() == reference["digest"]
    assert reference["k-sweep", "run"] == reference["half-sweep", "run"]


@pytest.mark.parametrize("tier", TIERS)
def test_resume_run_matches_reference(reference, tier):
    s = Session.restore(reference["path"], device="cpu",
                        resident_budget_bytes=port_budget(tier))
    assert (s.engine.resident_plan is not None) == (tier == "k-sweep")
    s.run(RUN)
    assert s.step_count == PRE + RUN
    assert s.state_digest() == reference[tier, "run"]


@pytest.mark.parametrize("tier", TIERS)
def test_resume_measure_matches_reference(reference, tier):
    s = Session.restore(reference["path"], device="cpu",
                        resident_budget_bytes=port_budget(tier))
    assert (s.engine.resident_plan is not None) == (tier == "k-sweep")
    traj = s.measure(MeasurementPlan(**PLAN))
    want, digest = reference[tier, "measure"]
    assert sorted(traj) == sorted(want)
    for k in want:
        assert traj[k].dtype == np.float32 and traj[k].shape == (3,)
        np.testing.assert_array_equal(traj[k], want[k])
    assert s.state_digest() == digest


def test_port_checkpoint_resumes_in_reference(reference, tmp_path):
    """Reverse direction, twice: a run the port started itself, and the
    JAX run continued by the port, both carry on in the JAX package."""
    path = str(tmp_path / "port.npz")
    s = Session.open(RunSpec.from_json(jax_spec().to_json()), device="cpu")
    s.run(PRE)
    s.save(path)
    j = japi.Session.restore(path)
    assert j.state_digest() == s.state_digest()
    j.run(2)
    s.run(2)
    assert j.state_digest() == s.state_digest()

    s = Session.restore(reference["path"], device="cpu")
    s.run(RUN)
    s.save(path)
    assert japi.Session.restore(path).state_digest() == \
        reference["k-sweep", "run"]


def test_restore_continue_equals_uninterrupted(tmp_path):
    spec = RunSpec(lattice=LatticeSpec(12, 20),
                   engine=EngineSpec("stencil_pallas"), temperature=1.9,
                   seed=2 ** 50 + 1)
    a = Session.open(spec, device="cpu")
    a.run(3)
    a.save(str(tmp_path / "a.npz"))
    b = Session.restore(str(tmp_path / "a.npz"), device="cpu")
    plan = MeasurementPlan(2, 3, thermalize=2)
    ta, tb = a.measure(plan), b.measure(plan)
    for k in ta:
        np.testing.assert_array_equal(ta[k], tb[k])
    assert a.state_digest() == b.state_digest()
    assert a.magnetization() == float(ta["m"][-1])
    assert a.energy() == float(ta["e"][-1])
    assert b.trajectory(2, 1).shape == (2,)


def test_fresh_session_is_a_function_of_the_seed():
    """The port's own init: seed-determined, and not the JAX package's
    ``jax.random`` lattice."""
    spec = RunSpec.from_json(jax_spec().to_json())
    a = Session.open(spec, device="cpu")
    b = Session.open(spec, device="cpu")
    assert a.state_digest() == b.state_digest()
    assert a.full_lattice().shape == (N, M)
    assert a.state_digest() != japi.Session.open(jax_spec()).state_digest()


WORD_ENGINES = ("multispin_pallas", "bitplane_pallas")


def jax_word_spec(engine):
    return japi.RunSpec(lattice=japi.LatticeSpec(N, M),
                        engine=japi.EngineSpec(engine),
                        temperature=TEMPERATURE, seed=SEED)


@pytest.fixture(scope="module", params=WORD_ENGINES)
def word_reference(request, tmp_path_factory):
    """A JAX checkpoint of a word-plane engine at step PRE, and what the
    JAX package computes from it."""
    engine = request.param
    path = str(tmp_path_factory.mktemp(engine) / "jax.npz")
    s = japi.Session.open(jax_word_spec(engine))
    s.run(PRE)
    s.save(path)
    out = {"engine": engine, "path": path, "digest": s.state_digest()}
    r = japi.Session.restore(path)
    r.run(RUN)
    out["run"] = r.state_digest()
    r = japi.Session.restore(path)
    out["measure"] = (r.measure(JaxPlan(**PLAN)), r.state_digest())
    return out


@pytest.mark.parametrize("tier", TIERS)
def test_word_engine_resume_run_matches_reference(word_reference, tier):
    s = Session.restore(word_reference["path"], device="cpu",
                        resident_budget_bytes=port_budget(tier))
    assert s.engine.name == word_reference["engine"]
    assert (s.engine.resident_plan is not None) == (tier == "k-sweep")
    assert s.state_digest() == word_reference["digest"]
    s.run(RUN)
    assert s.state_digest() == word_reference["run"]


@pytest.mark.parametrize("tier", TIERS)
def test_word_engine_resume_measure_matches_reference(word_reference, tier):
    s = Session.restore(word_reference["path"], device="cpu",
                        resident_budget_bytes=port_budget(tier))
    traj = s.measure(MeasurementPlan(**PLAN))
    want, digest = word_reference["measure"]
    shape = (3, 32) if word_reference["engine"] == "bitplane_pallas" else (3,)
    assert sorted(traj) == sorted(want)
    for k in want:
        assert traj[k].dtype == np.float32 and traj[k].shape == shape
        np.testing.assert_array_equal(traj[k], want[k])
    assert s.state_digest() == digest


def test_word_engine_port_checkpoint_resumes_in_reference(word_reference,
                                                          tmp_path):
    path = str(tmp_path / "port.npz")
    spec = jax_word_spec(word_reference["engine"])
    s = Session.open(RunSpec.from_json(spec.to_json()), device="cpu")
    s.run(PRE)
    s.save(path)
    j = japi.Session.restore(path)
    assert j.state_digest() == s.state_digest()
    j.run(2)
    s.run(2)
    assert j.state_digest() == s.state_digest()


@pytest.mark.parametrize("engine", ["multispin", "multispin_pallas",
                                    "bitplane", "bitplane_pallas",
                                    "tensorcore"])
def test_fresh_word_session_holds_the_single_lattice_init(engine):
    """The cross-engine init contract: a fresh session's ``full_lattice``
    (replica 0 for bitplane) is ``stencil_pallas``'s from the same spec."""
    lattice = LatticeSpec(N, M, init_p_up=0.4)
    # tensorcore's planes are (N/2, M/2): a block of 8 tiles them
    params = {"tc_block": 8} if engine == "tensorcore" else {}
    word = Session.open(RunSpec(lattice=lattice,
                                engine=EngineSpec(engine, params),
                                seed=SEED), device="cpu")
    plain = Session.open(RunSpec(lattice=lattice,
                                 engine=EngineSpec("stencil_pallas"),
                                 seed=SEED), device="cpu")
    assert torch.equal(word.full_lattice(), plain.full_lattice())


def test_unported_engine_checkpoint_raises(tmp_path):
    """Every JAX engine is ported: a ``wolff`` checkpoint restores (its
    lattice, its step count); a name that no package registers still
    raises."""
    spec = jax_spec().to_dict()
    spec["engine"]["name"] = "wolff"
    text = japi.RunSpec.from_dict(spec).to_json()
    lattice = np.where(np.arange(N * M).reshape(N, M) % 3, 1, -1) \
        .astype(np.int8)
    path = str(tmp_path / "wolff.npz")
    np.savez(path, spec_json=text, step_count=4, state_lattice=lattice)
    restored = Session.restore(path, device="cpu")
    assert restored.step_count == 4
    assert np.array_equal(restored.full_lattice().numpy(), lattice)
    path = str(tmp_path / "potts.npz")
    np.savez(path, spec_json=text.replace('"wolff"', '"potts"'),
             step_count=0, state_lattice=lattice)
    with pytest.raises(ValueError, match="not ported"):
        Session.restore(path, device="cpu")


def test_entry_points_raise_without_gpu(monkeypatch, reference):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    spec = RunSpec(lattice=LatticeSpec(8, 8),
                   engine=EngineSpec("stencil_pallas"))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Session.open(spec)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Session.restore(reference["path"])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cli.main(["run", "--n", "8", "--engine", "stencil_pallas",
                  "--sweeps", "1"])


def test_cli_runs_saves_and_restores_on_cpu(tmp_path, capsys):
    path = str(tmp_path / "cli.npz")
    assert cli.main(["run", "--device", "cpu", "--n", "16", "--m", "8",
                     "--engine", "stencil_pallas", "--init-p-up", "1.0",
                     "--temperature", "1.5",
                     "--seed", str(2 ** 33), "--n-measure", "2",
                     "--measure-every", "2", "--sweeps", "3",
                     "--save", path]) == 0
    out = capsys.readouterr().out
    assert "measured 2 samples" in out and "ran 3 sweeps" in out
    s = Session.restore(path, device="cpu")
    assert s.step_count == 7 and s.spec.lattice.m == 8
    assert cli.main(["run", "--device", "cpu", "--restore", path,
                     "--sweeps", "1"]) == 0
    assert cli.main(["run", "--device", "cpu", "--n", "16"]) == 2


_ISOLATED = r"""
import pkgutil, sys
sys.modules["jax"] = None
sys.modules["repro"] = None
import repro_torch
for info in pkgutil.walk_packages(repro_torch.__path__, "repro_torch."):
    __import__(info.name)
from repro_torch.api import EngineSpec, LatticeSpec, RunSpec, Session
s = Session.open(RunSpec(lattice=LatticeSpec(8, 8),
                         engine=EngineSpec("stencil_pallas"), seed=2 ** 40),
                 device="cpu")
s.run(2)
print(s.state_digest())
assert {"repro_torch.serve.server", "repro_torch.serve.smoke",
        "repro_torch.serve.client", "repro_torch.launch.simulate",
        "repro_torch.launch.serve", "repro_torch.launch.train",
        "repro_torch.train.compress", "repro_torch.train.sharding",
        "repro_torch.launch.dryrun"} <= set(sys.modules)
import tempfile
from repro_torch.serve import SweepFarm
with tempfile.TemporaryDirectory() as d:
    farm = SweepFarm(d, chunk=2, device="cpu")
    jid = farm.submit({"spec": s.spec.to_dict(), "sweeps": 2})
    assert farm.run_until_idle() == 1
    assert farm.job(jid)["digest"] == s.state_digest()
    farm.close()
# the LM stack: its registry imports every config module by string
import torch
from repro_torch.configs import ARCH_IDS, get_config, get_smoke_config
from repro_torch.models import forward, init_model
for arch in ARCH_IDS:
    get_config(arch)
    cfg = get_smoke_config(arch)
    if cfg.family == "dense":
        tokens = torch.zeros((1, 4), dtype=torch.int32)
        logits, _ = forward(cfg, init_model(cfg, 0, device="cpu"),
                            {"tokens": tokens})
        assert logits.shape == (1, 4, cfg.vocab)
leaked = [m for m, v in sys.modules.items() if v is not None and (
    m.split(".")[0] in ("jax", "jaxlib", "repro"))]
assert not leaked, leaked
"""


def test_package_runs_with_jax_and_repro_unimportable():
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-c", _ISOLATED], env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert re.fullmatch(r"[0-9a-f]{8}\n", out.stdout)


def test_no_jax_or_reference_imports_in_port_sources():
    pattern = re.compile(r"^\s*(import|from)\s+(jax|jaxlib|repro)\b(?!_)",
                         re.M)
    files = sorted((ROOT / "src" / "repro_torch").rglob("*.py"))
    files.append(ROOT / "chip_smoke.py")
    assert len(files) > 10
    names = {str(f.relative_to(ROOT / "src" / "repro_torch")) for f in files
             if f.name != "chip_smoke.py"}
    assert {"serve/server.py", "serve/journal.py", "serve/smoke.py",
            "launch/simulate.py", "launch/serve.py", "core/sim.py",
            "launch/roofline.py", "perf/gate.py", "kernels/stencil/ops.py",
            "kernels/multispin/ops.py", "kernels/bitplane/ops.py",
            "examples/quickstart.py", "examples/phase_transition.py",
            "examples/bitplane_replicas.py",
            "examples/multipod_sim.py", "configs/registry.py",
            "configs/base.py", "configs/internlm2_1p8b.py",
            "models/layers.py", "models/moe.py", "models/ssm.py",
            "models/model.py", "models/decode.py", "models/convert.py",
            "data/pipeline.py", "train/step.py", "train/optim.py",
            "train/compress.py", "launch/train.py",
            "examples/train_lm.py"} <= names
    for f in files:
        assert not pattern.search(f.read_text()), f
