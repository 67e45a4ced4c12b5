"""The port's dry-run (``repro_torch.launch.dryrun``): the cases of
``tests/test_dryrun.py``, run in process on the meta device (no 512
forced devices: the port's mesh holds its shards on meta), one
full-width count held against 6ND, the Ising cells' shard plans, and
``main``'s skip, resume and error behaviour.  Counts, not times."""
import inspect
import json

import pytest

from repro.configs import ARCH_IDS, SHAPES, get_config
from repro.configs.base import shape_applicable as jax_applicable

from repro_torch.configs import get_config as tget_config
from repro_torch.configs.base import shape_applicable
from repro_torch.launch import dryrun, roofline
from repro_torch.models import init_model


@pytest.mark.parametrize("arch,shape", [("internlm2-1.8b", "train_4k"),
                                        ("xlstm-125m", "decode_32k")])
def test_dryrun_smoke_cell(tmp_path, arch, shape):
    out = tmp_path / "dr.json"
    assert dryrun.main(["--smoke", "--arch", arch, "--shape", shape,
                        "--mesh", "single", "--out", str(out)]) == 0
    cells = json.loads(out.read_text())
    assert len(cells) == 1
    rec = cells[0]
    assert rec["status"] == "ok", rec.get("error")
    assert rec["chips"] == 256
    assert rec["flops"] > 0 and rec["bytes"] > 0
    assert rec["dominant"] in ("compute", "memory", "collective")
    assert rec["cost_correction"] == "none: every layer counted"
    assert set(rec["collectives"]) == {"all-gather", "all-reduce",
                                       "reduce-scatter", "all-to-all",
                                       "collective-permute"}
    assert rec["memory"]["argument_size_in_bytes"] > 0


def test_production_mesh_shapes():
    """Mesh factory contract (no mesh built at import: functions, not
    constants)."""
    import repro_torch.launch.mesh as mesh_mod
    src = inspect.getsource(mesh_mod)
    assert "def make_production_mesh" in src
    assert "def make_debug_mesh" in src
    assert not any(line.strip().startswith("MESH") for line in
                   src.splitlines())


def test_full_width_train_count_against_6nd():
    """internlm2-1.8b train_4k on meta: the whole step's FLOPs over
    6 x active parameters x tokens is 4/3 (remat's second forward) plus
    attention and the unembedding: between 1.33 and 2.0."""
    rec = dryrun.run_cell("internlm2-1.8b", "train_4k", "single",
                          verbose=False)
    assert rec["status"] == "ok", rec.get("error")
    shape = SHAPES["train_4k"]
    active = roofline.count_params(
        init_model(tget_config("internlm2-1.8b"), device="meta"))["active"]
    ratio = rec["flops"] * rec["chips"] / roofline.model_flops(
        active, shape.global_batch * shape.seq_len, "train")
    assert 1.33 < ratio < 2.0, ratio
    assert rec["microbatches"] == 4 and rec["fsdp"] is False
    # no FSDP and sp: the residual reductions are all-gather plus
    # reduce-scatter of the same bytes; the gradients all-reduced
    coll = rec["collectives"]
    assert coll["all-gather"] == coll["reduce-scatter"] > 0
    assert coll["all-reduce"] > 0 and coll["all-to-all"] == 0


@pytest.mark.parametrize("engine,shape,mesh,shard", [
    ("multispin", "lat_256k", "multi", [8192, 1024]),
    ("bitplane", "lat_256k", "multi", [8192, 8192]),
    ("basic", "lat_256k", "multi", [8192, 8192]),
    ("multispin", "lat_1m", "single", [65536, 4096])])
def test_ising_cell(engine, shape, mesh, shard):
    rec = dryrun.run_cell(f"ising-{engine}", shape, mesh, verbose=False)
    assert rec["status"] == "ok", rec.get("error")
    n, m = dryrun.ISING_SHAPES[shape]
    assert rec["chips"] == (512 if mesh == "multi" else 256)
    assert rec["spins"] == float(n) * m
    if shape == "lat_256k":
        assert rec["spins"] == 2.0 ** 36
    assert rec["shard"] == shard
    cell = 4 if engine != "basic" else 1
    assert rec["state_bytes"] == 2 * shard[0] * shard[1] * cell
    assert rec["halo_bytes"] == 2 * cell * (
        (shard[0] + 2) * (shard[1] + 2) - shard[0] * shard[1])
    assert rec["collectives"]["collective-permute"] == rec["halo_bytes"]
    plan = rec["plan"]
    assert plan["family"] == dryrun.ISING_ENGINES[engine][3]
    assert plan["extended"] == [shard[0] + 2 * plan["halo"],
                                shard[1] + 2 * plan["halo"]]
    assert plan["halo"] == 2 * plan["k"]
    fc = roofline.flip_cost(engine)
    assert rec["model_bytes_per_flip"] == fc.bytes_per_flip
    assert rec["counted_bytes_per_flip"] == pytest.approx(
        rec["bytes"] * rec["chips"] / (rec["spins"] * fc.replicas))
    assert rec["peak_flips_per_ns_per_device"] == \
        roofline.roofline_flips_per_ns(engine, "cuda")
    assert rec["flops"] > 0 and rec["dominant"] in ("compute", "memory",
                                                    "collective")


@pytest.mark.parametrize("shape", list(SHAPES))
def test_skips_where_jax_skips(shape):
    for arch in ARCH_IDS:
        assert shape_applicable(tget_config(arch), SHAPES[shape]) == \
            jax_applicable(get_config(arch), SHAPES[shape])
        if not jax_applicable(get_config(arch), SHAPES[shape])[0]:
            rec = dryrun.run_cell(arch, shape, "single", verbose=False)
            assert rec["status"] == "skipped" and rec["skip_reason"]


def test_resume_default_out_and_errors(tmp_path, monkeypatch):
    """The default --out is results/dryrun_torch.json (never JAX's
    results/dryrun.json); a finished cell is not run again; an error
    cell makes the exit code 1."""
    monkeypatch.chdir(tmp_path)
    argv = ["--arch", "ising-basic", "--shape", "lat_256k", "--mesh",
            "single"]
    assert dryrun.main(argv) == 0
    out = tmp_path / "results" / "dryrun_torch.json"
    assert out.exists()
    assert not (tmp_path / "results" / "dryrun.json").exists()
    first = json.loads(out.read_text())

    def fail(*args, **kwargs):
        raise AssertionError("a finished cell ran again")
    monkeypatch.setattr(dryrun, "lower_ising_cell", fail)
    assert dryrun.main(argv) == 0
    assert json.loads(out.read_text()) == first
    assert dryrun.main(argv[:-1] + ["multi"]) == 1
    cells = json.loads(out.read_text())
    assert [c["status"] for c in cells] == ["ok", "error"]
    assert "a finished cell ran again" in cells[1]["error"]
