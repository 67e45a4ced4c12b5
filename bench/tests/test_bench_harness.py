"""The harness on the CPU at small sizes: its loader, its refusal to run
without a card, its imports, and ``correct`` under planted faults.
Run: ``python -m pytest -q bench/tests``."""
import ast
import copy
import json
import os
import shutil
import subprocess
import sys
import time
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[2]
BENCH = ROOT / "bench"
sys.path[:0] = [str(ROOT), str(ROOT / "src")]

from bench import harness  # noqa: E402

SEED = 2 ** 32 + 2 ** 31 + 5
FORBIDDEN = {"jax", "jaxlib", "flax", "repro"}


CELLS = [w["name"] for w in harness.load_benchmark()["workloads"]]
#: the harness's mesh path, which no cell of ``BENCHMARK.json`` drives
#: yet: the first ``Session.run`` cell's files on a (2, 2) mesh
MESH = "mesh-2x2.sweep"


def _small(name, n=64, mesh_n=512):
    """The cell at a size the CPU runs in a second: the same files, the
    lattice and the calls cut."""
    bench = harness.load_benchmark()
    if name == MESH:
        base = next(w["name"] for w in bench["workloads"]
                    if w["traffic"] == "sweep")
        cell = harness.Cell.load(bench, base)
        cell.config = copy.deepcopy(cell.config)
        cell.config["spec"]["mesh"] = {"shape": [2, 2],
                                       "axis_names": ["data", "model"]}
    else:
        cell = harness.Cell.load(bench, name)
        cell.config = copy.deepcopy(cell.config)
    side = mesh_n if cell.config["spec"].get("mesh") else n
    cell.config["spec"]["lattice"].update(n=side, m=side)
    t = dict(cell.traffic)
    if t["entry"] == "run":
        t["sweeps"] = 4
    else:
        t.update(n_measure=3, sweeps_between=2)
    cell.traffic = t
    return cell


def _run(cell, seconds=0.2):
    return harness.run_cell(cell, SEED, seconds, False, time.perf_counter(),
                            device="cpu")[0]


@pytest.mark.parametrize("name", CELLS + [MESH])
def test_sound_run_is_correct(name):
    cell = _small(name)
    result = _run(cell)
    assert result["correct"], result["checks"]
    assert list(result)[-1] == "checks"
    assert all(c["limit"] == 0 for c in result["checks"].values())
    # every end-to-end metric of the cell; no peak without a card
    assert set(result["metrics"]) == {m["name"] for m in cell.end_to_end
                                      } - {"peak_mem_gib"}


# -- faults planted under the timed path --------------------------------------

def _unchanged(monkeypatch):
    from repro_torch.core.engine import CounterEngine
    import repro_torch.dist as dist

    monkeypatch.setattr(CounterEngine, "sweep_fn_batched",
                        lambda self, states, *a, **k: states)
    real = dist.make_resident_step

    def make(*a, **k):
        real(*a, **k)
        return lambda black, white, *rest: (black, white)
    monkeypatch.setattr(dist, "make_resident_step", make)


def _half_left_out(monkeypatch):
    """Half of the lattice (the lower rows; on a mesh the second half of
    the shards) keeps its state through every call."""
    from repro_torch.core.engine import CounterEngine
    import repro_torch.dist as dist

    real_fn = CounterEngine.sweep_fn_batched

    def half(self, states, *a, **k):
        keep = [p.clone() for p in states]
        out = real_fn(self, states, *a, **k)
        rows = out[0].shape[-2] // 2
        for o, kp in zip(out, keep):
            o[..., rows:, :] = kp[..., rows:, :]
        return out
    monkeypatch.setattr(CounterEngine, "sweep_fn_batched", half)
    real = dist.make_resident_step

    def make(*a, **k):
        step = real(*a, **k)

        def run(black, white, *rest):
            nb, nw = step(black, white, *rest)
            cut = len(black) // 2
            return nb[:cut] + black[cut:], nw[:cut] + white[cut:]
        return run
    monkeypatch.setattr(dist, "make_resident_step", make)


def _no_exchange(monkeypatch):
    """Each shard's halo is its own edge: no shard receives from
    another."""
    import repro_torch.dist.driver as driver
    monkeypatch.setattr(driver, "ring_shift",
                        lambda xs, *a, **k: [x.clone() for x in xs])


def _answer_altered(monkeypatch):
    """A call's output is wrong in one place where it is produced: the
    origin's word of each plane after a sweep; a measurement's last
    sample of ``m``."""
    from repro_torch.core.engine import CounterEngine
    from repro_torch.api import session as ses
    import repro_torch.dist as dist

    real_fn = CounterEngine.sweep_fn_batched

    def flip(self, states, *a, **k):
        out = real_fn(self, states, *a, **k)
        for o in out:
            o[..., 0, 0] ^= 1
        return out
    monkeypatch.setattr(CounterEngine, "sweep_fn_batched", flip)
    real_measure = ses._SingleRunner.measure

    def measure(self, plan):
        traj = real_measure(self, plan)
        traj["m"][-1, 0] += 2.0 ** -20
        return traj
    monkeypatch.setattr(ses._SingleRunner, "measure", measure)
    real = dist.make_resident_step

    def make(*a, **k):
        step = real(*a, **k)

        def run(black, white, *rest):
            nb, nw = step(black, white, *rest)
            nb[0][0, 0] ^= 1
            return nb, nw
        return run
    monkeypatch.setattr(dist, "make_resident_step", make)


FAULTS = {"unchanged": _unchanged, "half_left_out": _half_left_out,
          "no_exchange": _no_exchange, "answer_altered": _answer_altered}


def _faults_of(name):
    cell = _small(name)
    out = ["unchanged", "half_left_out", "answer_altered"]
    if cell.config["spec"].get("mesh"):
        out.append("no_exchange")
    return out


@pytest.mark.parametrize("name, fault", [(n, f) for n in CELLS + [MESH]
                                         for f in _faults_of(n)])
def test_fault_is_not_correct(name, fault, monkeypatch):
    FAULTS[fault](monkeypatch)
    result = _run(_small(name))
    assert not result["correct"], (fault, result["checks"])


def test_tiles_cross_edges_and_block_seams():
    """The tiles of a check straddle the lattice's periodic corner, the
    middle of its edges and the k-sweep kernel's block seams."""
    from bench import check
    cell = harness.Cell.load(harness.load_benchmark(), CELLS[0])
    g = cell.geometry
    rows, words = cell.block
    per = g.width // g.words
    tiles = check.tiles(g, SEED, cell.sweeps_per_call, cell.block)
    assert len(tiles.corners) == 3 + check.SEAM_TILES + check.TILES_DRAWN

    def straddles(start, size, period, extent):
        return any((start + d) % extent % period == 0
                   for d in range(1, size))
    edges = tiles.corners[:3]
    assert all(straddles(r, tiles.rows, g.n, g.n) for r, _ in edges[:2])
    assert straddles(edges[2][1], tiles.cols, g.width, g.width)
    assert straddles(edges[0][1], tiles.cols, g.width, g.width)
    for r, c in tiles.corners[3:3 + check.SEAM_TILES]:
        assert straddles(r, tiles.rows, rows, g.n), (r, c)
        assert straddles(c, tiles.cols, words * per, g.width), (r, c)


# -- the command --------------------------------------------------------------

def _command(cwd, *args, env=None):
    return subprocess.run(
        [sys.executable, "bench/run.py", "--workload", CELLS[0],
         "--seed", str(SEED), "--seconds", "1", "--trace", "0", *args],
        cwd=cwd, capture_output=True, text=True, timeout=300, env=env)


def test_no_card_no_result():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    r = _command(ROOT)
    assert r.returncode != 0
    assert "{" not in r.stdout and "needs 1 CUDA card" in r.stderr


def test_bench_alone_fails(tmp_path):
    """A directory with only BENCHMARK.json and bench/ (no program)
    prints no result."""
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(BENCH, tmp_path / "bench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    r = _command(tmp_path, env=env)
    assert r.returncode != 0 and "{" not in r.stdout


def test_forbidden_modules_are_named(monkeypatch):
    monkeypatch.setitem(sys.modules, "repro.core", object())
    assert harness.forbidden_modules() == ["repro"]
    monkeypatch.delitem(sys.modules, "repro.core")
    assert "repro_torch" not in harness.forbidden_modules()


def _top_imports(path: Path) -> set:
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
    return names


def test_no_module_of_bench_imports_jax_or_the_jax_package():
    """Top-level names compared whole: ``repro_torch`` is the program,
    ``repro`` the JAX package; the reference imports neither."""
    files = sorted(BENCH.rglob("*.py"))
    assert files
    for path in files:
        found = _top_imports(path)
        assert not found & FORBIDDEN, (path, found & FORBIDDEN)
        if "reference" in path.parts:
            assert "repro_torch" not in found, path
        if "tests" not in path.parts:
            assert "benchmarks/" not in path.read_text(), path


def test_added_files_are_found_without_edits(tmp_path):
    """A new configuration, traffic mix and metric are new files and new
    entries of a copy of the benchmark; the copy's loader finds them and
    a run on the CPU reports the new metric."""
    root = tmp_path / "checkout"
    shutil.copytree(BENCH, root / "bench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    before = {p: p.read_bytes() for p in (root / "bench").rglob("*")
              if p.is_file()}
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    (root / "bench/configs/dummy-64.json").write_text(json.dumps({
        "name": "dummy-64", "layout": "bitplane", "family": "bitplane",
        "replicas": 32, "reduced": [],
        "spec": {"lattice": {"n": 64, "m": 64, "init_p_up": 0.5},
                 "engine": {"name": "bitplane_pallas", "params": {}},
                 "temperature": 1.9, "mesh": None}}))
    (root / "bench/traffic/short.json").write_text(json.dumps(
        {"entry": "run", "sweeps": 3}))
    (root / "bench/metrics/answer.py").write_text(
        "def read(ctx):\n    return 42.0 if ctx.entry == 'run' else None\n")
    bench["configs"].append({"name": "dummy-64", "source": "a test",
                             "file": "bench/configs/dummy-64.json",
                             "reduced": [], "why": "a test"})
    bench["workloads"].append({"name": "dummy-64.short",
                               "config": "dummy-64", "traffic": "short",
                               "chips": 1, "why": "a test"})
    bench["end_to_end"].append({"name": "answer", "unit": "1",
                                "better": "higher", "bound": 0.01,
                                "source": "host_clock",
                                "workloads": ["dummy-64.short"]})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    code = (
        "import sys, json, time\n"
        f"sys.path[:0] = [{str(root)!r}, {str(ROOT / 'src')!r}]\n"
        "from bench import harness\n"
        f"assert harness.ROOT == __import__('pathlib').Path({str(root)!r})\n"
        "cell = harness.Cell.load(harness.load_benchmark(), 'dummy-64.short')\n"
        "r, _ = harness.run_cell(cell, 9, 0.2, False, time.perf_counter(),"
        " device='cpu')\n"
        "print(json.dumps(r))\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300, env=env)
    assert out.returncode == 0, out.stderr[-2000:]
    result = json.loads(out.stdout.strip().splitlines()[-1])
    assert result["correct"]
    assert result["metrics"]["answer"] == {"value": 42.0, "unit": "1"}
    for path, data in before.items():
        assert path.read_bytes() == data
