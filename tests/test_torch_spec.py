"""RunSpec JSON round trips between the two packages, and the specs
either refuses."""
import json

import pytest

import repro.api as japi
from repro_torch.api import spec as tspec

FULL = {
    "version": 1,
    "lattice": {"n": 64, "m": 32, "init_p_up": 1.0},
    "engine": {"name": "stencil_pallas", "params": {}},
    "temperature": 2.269,
    "seed": 2 ** 40 + 3,
    "sweep": {"thermalize": 5, "measure_every": 2, "n_measure": 7,
              "fields": ["m", "e"]},
    "batch": None,
    "mesh": None,
}


@pytest.mark.parametrize("sweep", [None, FULL["sweep"]])
def test_reference_json_reads_in_port_and_back(sweep):
    ref = japi.RunSpec.from_dict(dict(FULL, sweep=sweep))
    port = tspec.RunSpec.from_json(ref.to_json())
    assert port.to_json() == ref.to_json()
    assert japi.RunSpec.from_json(port.to_json()) == ref


def test_port_json_reads_in_reference():
    port = tspec.RunSpec(lattice=tspec.LatticeSpec(16, 8, init_p_up=0.25),
                         engine=tspec.EngineSpec("stencil_pallas"),
                         temperature=1.5, seed=2 ** 63,
                         sweep=tspec.SweepSpec(thermalize=1, n_measure=3))
    ref = japi.RunSpec.from_json(port.to_json())
    assert ref.to_json() == port.to_json()
    assert json.loads(port.to_json(indent=1)) == port.to_dict()


def test_port_defaults_to_stencil_pallas():
    """Named for the port's first default engine; the default is now the
    JAX package's, ``multispin``, and ``stencil_pallas`` is asked for by
    name."""
    spec = tspec.RunSpec.from_dict({"lattice": {"n": 16, "m": 16}})
    assert spec.engine.name == "multispin"
    assert spec.sim_config().inv_temp == 1.0 / spec.temperature
    named = tspec.RunSpec.from_dict({"lattice": {"n": 8, "m": 8},
                                     "engine": {"name": "stencil_pallas"}})
    assert named.engine.name == "stencil_pallas"


@pytest.mark.parametrize("package", [japi, tspec], ids=["jax", "port"])
def test_spec_without_engine_opens_multispin(package):
    """A spec JSON without an ``engine`` key names one engine in both
    packages: the reference's default, ``multispin``."""
    doc = json.dumps({"lattice": {"n": 16, "m": 32}})
    spec = package.RunSpec.from_json(doc)
    assert spec.engine.name == "multispin"
    assert spec.sim_config().engine == "multispin"
    assert tspec.RunSpec.from_json(spec.to_json()).engine.name == \
        japi.RunSpec.from_json(spec.to_json()).engine.name


def test_sim_config_defaults_agree():
    from repro.core.sim import SimConfig as JaxSimConfig
    from repro_torch.core.sim import SimConfig
    assert SimConfig().engine == JaxSimConfig().engine == "multispin"


@pytest.mark.parametrize("cli", ["repro.__main__", "repro_torch.__main__"])
def test_cli_engine_default_is_multispin(cli, monkeypatch):
    """``run`` without ``--engine`` builds a ``multispin`` spec in both
    command lines."""
    import importlib
    mod = importlib.import_module(cli)
    built = []
    monkeypatch.setattr(mod, "cmd_run",
                        lambda args: built.append(mod._build_spec(args)) or 0)
    assert mod.main(["run", "--n", "16", "--sweeps", "1"]) == 0
    assert built[0].engine.name == "multispin"


@pytest.mark.parametrize("extra", [
    {"batch": {"temperatures": [2.0, 2.2], "seeds": [1, 2], "grid": False}},
    {"mesh": {"shape": [2, 1], "axis_names": ["data", "model"]}},
])
def test_batch_and_mesh_parse_then_raise(extra):
    """A batch spec and a mesh spec are ported: they read as an ensemble
    and as sharded, as in the JAX package, and together they raise in
    both packages."""
    doc = json.dumps(dict(FULL, **extra))
    ref = japi.RunSpec.from_json(doc)  # a valid reference spec
    port = tspec.RunSpec.from_json(doc)
    assert port.mode == ref.mode == ("ensemble" if "batch" in extra
                                     else "sharded")
    assert port.to_json() == ref.to_json()
    both = dict(FULL, batch={"temperatures": [2.0], "seeds": None,
                             "grid": False},
                mesh={"shape": [2, 1], "axis_names": ["data", "model"]})
    both = json.dumps(dict(both, **extra))
    for package in (japi, tspec):
        with pytest.raises(ValueError, match="batch \\+ mesh"):
            package.RunSpec.from_json(both)


def test_bad_batch_is_rejected_while_parsing():
    doc = json.dumps(dict(FULL, batch={"temperatures": [], "seeds": None,
                                       "grid": False}))
    with pytest.raises(ValueError, match="at least one temperature"):
        tspec.RunSpec.from_json(doc)


@pytest.mark.parametrize("doc,match", [
    (dict(FULL, engine={"name": "potts", "params": {}}), "not ported"),
    (dict(FULL, lattice={"n": 7, "m": 8}), "even"),
    (dict(FULL, temperature=0.0), "positive"),
    (dict(FULL, seed=2 ** 64), "uint64"),
    (dict(FULL, colour=1), "unknown key"),
    (dict(FULL, engine={"name": "stencil_pallas", "params": {"x": 1}}),
     "takes no params"),
])
def test_invalid_specs_raise(doc, match):
    with pytest.raises(ValueError, match=match):
        tspec.RunSpec.from_dict(doc)
