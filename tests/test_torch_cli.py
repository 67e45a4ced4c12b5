"""The port's front door against the JAX package's: ``describe`` (what
``--dry-run`` prints), ``load_spec``, spec files in both directions and
``--record``, all on the CPU (``--dry-run`` with no card and no
``--device``)."""
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import repro.api as japi
from repro.api.session import load_spec as jax_load_spec
from repro_torch import __main__ as cli
from repro_torch.api import RunSpec, Session, describe, load_spec
from repro_torch.perf import schema

ROOT = Path(__file__).resolve().parent.parent
ENGINES = ("stencil_pallas", "multispin", "multispin_pallas", "bitplane",
           "bitplane_pallas", "tensorcore")
COUNTER_BASED = ENGINES[:-1]
RESIDENT_KEYS = {"family", "fits_smem", "budget_bytes"}
PLAN_KEYS = {"k", "tile_rows", "tile_cols", "threads", "smem_bytes"}
DIST_KEYS = {"family", "grid", "sharded_resident", "budget_bytes"}


def spec_dict(engine, mode, n=64):
    d = {"lattice": {"n": n, "m": n, "init_p_up": 1.0},
         "engine": {"name": engine,
                    "params": {"tc_block": 16} if engine == "tensorcore"
                    else {}},
         "temperature": 2.2, "seed": 2 ** 33 + 5,
         "sweep": {"thermalize": 3, "measure_every": 2, "n_measure": 2,
                   "fields": ["m", "e"]}}
    if mode == "ensemble":
        d["batch"] = {"temperatures": [2.0, 2.2], "seeds": [3, 2 ** 32 - 1],
                      "grid": True}
    if mode == "mesh":
        d["mesh"] = {"shape": [2, 2], "axis_names": ["data", "model"]}
    return d


CASES = [(e, "single") for e in ENGINES] + \
        [(e, mode) for e in COUNTER_BASED for mode in ("ensemble", "mesh")]


@pytest.mark.parametrize("engine,mode", CASES)
def test_describe_equals_jax_but_for_the_planners(engine, mode):
    """Every key but the two planners' equals the JAX package's; those
    hold the port's k-sweep and shard planners' decisions (at 512^2,
    where a 2 x 2 mesh of shards has a shard plan)."""
    spec = RunSpec.from_dict(spec_dict(engine, mode, n=512))
    jspec = japi.RunSpec.from_json(spec.to_json())
    ours, theirs = describe(spec), japi.describe(jspec)
    assert ours.keys() == theirs.keys()
    for k in ours.keys() - {"resident", "dist"}:
        assert ours[k] == theirs[k], k
    resident = ours["resident"]
    if engine == "tensorcore":
        assert resident is None
    else:
        assert RESIDENT_KEYS <= resident.keys()
        assert resident["fits_smem"] and PLAN_KEYS <= resident.keys()
        assert resident["family"] == engine.split("_")[0]
    if mode == "mesh":
        assert DIST_KEYS <= ours["dist"].keys()
        assert ours["dist"]["grid"] == "2x2"
        sharded = engine.endswith("_pallas")
        assert ours["dist"]["sharded_resident"] == sharded
        assert ("reason" in ours["dist"]) != sharded
    else:
        assert ours["dist"] is None
    json.dumps(ours)                     # JSON scalars only


def test_describe_gives_a_reason_for_the_half_sweep_tier():
    from repro_torch.kernels.resident import decision_attrs
    attrs = decision_attrs("stencil", 64, 64, budget_bytes=0)
    assert not attrs["fits_smem"] and "per-half-sweep" in attrs["reason"]
    assert not PLAN_KEYS & attrs.keys()


def test_session_plan_is_describe():
    spec = RunSpec.from_dict(spec_dict("multispin", "ensemble", n=32))
    assert Session.open(spec, device="cpu").plan() == describe(spec)


def no_card(monkeypatch):
    """Fail any question to CUDA: a dry run asks none."""
    def refuse(*args, **kwargs):
        raise AssertionError("the dry run asked CUDA")
    monkeypatch.setattr(torch.cuda, "is_available", refuse)
    monkeypatch.setattr(torch.cuda, "device_count", refuse)


@pytest.mark.parametrize("mode", ["single", "ensemble", "mesh"])
def test_dry_run_does_no_device_work(tmp_path, mode, monkeypatch, capsys):
    """``--dry-run`` of a spec file, with no ``--device``, prints
    ``describe`` of the spec and never asks CUDA."""
    path = tmp_path / "spec.json"
    path.write_text(json.dumps(spec_dict("multispin_pallas", mode)))
    no_card(monkeypatch)
    assert cli.main(["run", str(path), "--dry-run"]) == 0
    out = capsys.readouterr()
    assert json.loads(out.out) == json.loads(json.dumps(describe(
        RunSpec.from_json(path.read_text()))))
    assert "dry run OK" in out.err


def test_dry_run_with_cuda_hidden(tmp_path):
    """``python -m repro_torch run spec.json --dry-run`` in a process that
    sees no card succeeds; the same run without ``--dry-run`` refuses
    to start on the CPU on its own."""
    path = tmp_path / "spec.json"
    path.write_text(json.dumps(spec_dict("multispin", "ensemble")))
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"),
               CUDA_VISIBLE_DEVICES="")
    code = ("import sys; from repro_torch.__main__ import main\n"
            "for argv in (sys.argv[1:], sys.argv[1:-1]):\n"
            "    try:\n"
            "        print('rc', main(['run', *argv]))\n"
            "    except RuntimeError as e:\n"
            "        print('raised', e)\n")
    out = subprocess.run([sys.executable, "-c", code, str(path),
                          "--dry-run"], env=env, capture_output=True,
                         text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert "rc 0" in out.stdout and "dry run OK" in out.stderr
    assert "raised no CUDA device" in out.stdout


def jax_checkpoint(tmp_path, mode):
    """A checkpoint of a fresh JAX session, and the session."""
    spec = japi.RunSpec.from_dict(spec_dict("multispin", mode, n=32))
    if mode == "mesh":
        spec = japi.RunSpec.from_dict(
            dict(spec.to_dict(), mesh={"shape": [1, 1],
                                       "axis_names": ["data", "model"]}))
    session = japi.Session.open(spec)
    path = str(tmp_path / f"jax_{mode}.npz")
    session.save(path)
    return path, session


@pytest.mark.parametrize("mode", ["single", "ensemble", "mesh"])
def test_load_spec_of_a_jax_checkpoint(tmp_path, mode, monkeypatch,
                                      capsys):
    """``load_spec`` of a JAX-written checkpoint is JAX's ``load_spec``,
    and ``--restore --dry-run`` prints the plan of that spec alone."""
    path, _ = jax_checkpoint(tmp_path, mode)
    ours = load_spec(path)
    assert ours.to_dict() == jax_load_spec(path).to_dict()
    no_card(monkeypatch)
    assert cli.main(["run", "--restore", path, "--dry-run"]) == 0
    assert json.loads(capsys.readouterr().out)["spec"] == json.loads(
        json.dumps(ours.to_dict()))


def test_load_spec_refuses_a_checkpoint_without_a_spec(tmp_path):
    """A file with neither a spec nor the config of the layout before the
    spec is refused; one with that config alone reads as JAX's
    ``load_spec`` reads it."""
    path = str(tmp_path / "nospec.npz")
    np.savez(path, step_count=0)
    with pytest.raises(ValueError, match="spec_json"):
        load_spec(path)
    legacy = str(tmp_path / "legacy.npz")
    np.savez(legacy, config_json="{}", step_count=0)
    assert load_spec(legacy).to_dict() == jax_load_spec(legacy).to_dict()


@pytest.mark.parametrize("mode", ["single", "ensemble"])
def test_out_spec_reads_back_in_jax(tmp_path, mode):
    """``--out-spec`` of a spec built from flags is a JAX ``RunSpec``
    equal to the one JAX's CLI builds from the same flags."""
    flags = ["--n", "32", "--init-p-up", "1.0", "--temperature", "2.2",
             "--seed", "5", "--n-measure", "4", "--measure-every", "3",
             "--thermalize", "2", "--fields", "m"]
    if mode == "ensemble":
        flags += ["--temps", "1.8,2.2", "--seeds", "3,4", "--grid"]
    path = tmp_path / "out.json"
    assert cli.main(["run", *flags, "--out-spec", str(path), "--dry-run"]) \
        == 0
    back = japi.RunSpec.from_json(path.read_text())
    from repro import __main__ as jcli
    jpath = tmp_path / "jax.json"
    assert jcli.main(["run", *flags, "--out-spec", str(jpath),
                      "--dry-run"]) == 0
    assert back == japi.RunSpec.from_json(jpath.read_text())
    assert back.sweep.fields == ("m",) and back.lattice.n == 32
    assert (back.batch is None) == (mode == "single")


@pytest.mark.parametrize("engine,mode", [("stencil_pallas", "single"),
                                         ("multispin", "single")])
def test_jax_spec_file_runs_to_the_jax_digest(tmp_path, engine, mode,
                                              capsys):
    """A spec file the JAX package wrote, run by the port's CLI on the CPU
    (its plan, then --sweeps 3), reaches the digest of the JAX session
    that runs the same; the checkpoint and the validated record hold the
    spec."""
    jspec = japi.RunSpec.from_dict(spec_dict(engine, mode, n=32))
    path = tmp_path / "spec.json"
    path.write_text(jspec.to_json(indent=1))
    ck, record = tmp_path / "ck.npz", tmp_path / "rec.json"
    assert cli.main(["run", str(path), "--device", "cpu", "--sweeps", "3",
                     "--save", str(ck), "--record", str(record)]) == 0
    capsys.readouterr()
    jax_session = japi.Session.open(jspec)
    jax_session.measure()
    jax_session.run(3)
    ours = Session.restore(str(ck), device="cpu")
    assert ours.step_count == jax_session.step_count == 10
    assert ours.state_digest() == jax_session.state_digest()
    rec = json.loads(record.read_text())
    schema.validate_record(rec)
    assert rec["meta"]["backend"] == "cpu"
    assert rec["meta"]["device_count"] == 1
    assert rec["meta"]["spec"] == json.loads(jspec.to_json())
    assert [r["name"] for r in rec["rows"]] == ["measure", "run"]
    assert japi.RunSpec.from_json(rec["rows"][0]["spec"]) == jspec


def test_record_to_a_directory(tmp_path, capsys):
    assert cli.main(["run", "--device", "cpu", "--n", "32", "--sweeps", "2",
                     "--record", str(tmp_path / "records")]) == 0
    (path,) = (tmp_path / "records").glob("BENCH_*.json")
    assert f"# wrote record {path}" in capsys.readouterr().out
    schema.validate_record(json.loads(path.read_text()))


def test_nothing_to_do_exits_2(capsys):
    assert cli.main(["run", "--device", "cpu", "--n", "32"]) == 2
    assert "nothing to do" in capsys.readouterr().err
