"""The port's four Ising examples (``repro_torch.examples``) on the CPU:
each ``main`` completes with its assertions, held to the JAX scripts at
the physics level (the fresh init and the tables differ by design)."""
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from repro.core import observables as jobs
from repro_torch.api import RunSpec
from repro_torch.examples import (bitplane_replicas, multipod_sim,
                                  phase_transition, quickstart)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_quickstart(capsys):
    out = quickstart.main(["--device", "cpu"])
    text = capsys.readouterr().out
    assert text.rstrip().endswith("ok")
    assert set(out["engines"]) == set(quickstart.ENGINES)
    assert RunSpec.from_json(out["spec"].to_json()) == out["spec"]
    assert dict(out["spec"].engine.params) == {
        "tc_block": quickstart.TC_BLOCK}
    # the ordered kernel run stays ordered, near Onsager's 0.9569
    onsager = float(jobs.onsager_magnetization(quickstart.T))
    assert abs(out["kernel_m"] - onsager) < 0.03
    assert out["kernel_launches"] == 0             # the CPU launches none
    # the JAX script's block, which the card takes as well
    assert quickstart.TC_BLOCK == 8


def test_phase_transition_orders_at_low_t(capsys):
    results = phase_transition.main(["--device", "cpu"])
    text = capsys.readouterr().out
    assert text.splitlines()[0].startswith("T ")
    assert len(text.splitlines()) == len(phase_transition.TEMPS) + 2
    i = phase_transition.TEMPS.index(1.5)
    onsager = float(jobs.onsager_magnetization(1.5))
    assert round(onsager, 4) == 0.9865
    for L in phase_transition.SIZES:
        m, u = results[L]
        assert abs(m[i] - onsager) < 0.02
        # ordered below Tc (U_L -> 2/3), disordered at T = 3
        assert u[i] == pytest.approx(2 / 3, abs=0.01)
        assert m[phase_transition.TEMPS.index(3.0)] < 0.2


def test_bitplane_replicas(capsys):
    out = bitplane_replicas.main(["--device", "cpu"])
    assert out["traj"]["m"].shape == (120, 32)
    assert out["distinct_hot"] == 32
    assert out["err"] < out["err_single"]
    assert out["distinct_cold"] <= 4
    assert "distinct replica configs after 400 sweeps" in \
        capsys.readouterr().out


def test_multipod_sim_is_bit_exact_on_a_2x2_cpu_mesh(capsys):
    out = multipod_sim.main(["--device", "cpu"])
    assert out["same"] is True
    text = capsys.readouterr().out
    assert "mesh={'data': 2, 'model': 2}" in text
    assert "bit-exact vs single device: True" in text


def test_shard_grid_split_is_the_inverse_of_gather():
    from repro_torch.core import distributed as dist
    from repro_torch.launch.mesh import make_mesh
    mesh = make_mesh((2, 3), ("data", "model"), "cpu")
    grid = dist.ShardGrid.of(mesh, 8, 12)
    plane = torch.from_numpy(
        np.random.default_rng(0).integers(-9, 9, (8, 12)).astype(np.int8))
    before = plane.clone()
    shards = grid.split(plane)
    assert [tuple(s.shape) for s in shards] == [(4, 4)] * 6
    assert all(s.is_contiguous() for s in shards)
    assert torch.equal(grid.gather(shards), plane)
    for s in shards:                       # copies: the plane is untouched
        s.fill_(100)
    assert torch.equal(plane, before)


def test_examples_run_as_modules_and_want_a_card_by_default():
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"),
               CUDA_VISIBLE_DEVICES="")
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.examples.multipod_sim"],
        capture_output=True, text=True, env=env, timeout=300)
    assert proc.returncode != 0 and "no CUDA device" in proc.stderr
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.examples.multipod_sim",
         "--device", "cpu"], capture_output=True, text=True, env=env,
        timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert "bit-exact vs single device: True" in proc.stdout
