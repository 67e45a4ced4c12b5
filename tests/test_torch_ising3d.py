"""The 3D Ising model in the port (CPU): its functions on the JAX
package's lattices and uniforms give the JAX values; the slab-decomposed
mesh step is the JAX package's ``make_ising3d_step`` bit for bit, on a
1 x 1 mesh in process and on a (4, 2) mesh of 8 host devices in a
subprocess; the port's single-device run is its slab runs on any mesh;
and the JAX package's 3D gates (``tests/test_models_extended.py``)."""
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import ising3d as jising3d
from repro.launch.mesh import make_mesh as jax_make_mesh
from repro_torch.core import ising3d
from repro_torch.launch.mesh import make_mesh

ROOT = Path(__file__).resolve().parent.parent
#: temperatures whose 7-entry tables are the JAX package's ``jnp.exp``
#: entry for entry
TEMPS = (3.5, 2.2)


def assert_tables_agree(temperature):
    beta = np.float32(1.0 / temperature)
    args = jnp.asarray(ising3d.acceptance_arguments_3d(beta))
    assert np.array_equal(ising3d.acceptance_table_3d(beta).numpy(),
                          np.asarray(jnp.exp(args)))


def random_cube(seed, n=8, p_up=0.5):
    rs = np.random.default_rng(seed)
    return np.where(rs.random((n, n, n)) < p_up, 1, -1).astype(np.int8)


def test_neighbor_sums_3d():
    assert bool((ising3d.neighbor_sums_3d(
        torch.ones((4, 4, 4), dtype=torch.int8)) == 6).all())
    cube = random_cube(0, n=6)
    got = ising3d.neighbor_sums_3d(torch.from_numpy(cube))
    assert got.dtype == torch.int8
    assert np.array_equal(got.numpy().astype(np.int32),
                          np.asarray(jising3d.neighbor_sums_3d(cube)))


@pytest.mark.parametrize("temperature", TEMPS)
@pytest.mark.parametrize("color", [0, 1])
def test_update_color_3d_equals_jax_on_jax_uniforms(temperature, color):
    assert_tables_agree(temperature)
    beta = np.float32(1.0 / temperature)
    cube = random_cube(1, p_up=0.7)
    u = np.array(jax.random.uniform(jax.random.PRNGKey(2), cube.shape))
    want = jising3d.update_color_3d(cube, u, jnp.float32(beta), color)
    got = ising3d.update_color_3d(torch.from_numpy(cube),
                                  torch.from_numpy(u),
                                  ising3d.acceptance_table_3d(beta), color)
    assert np.array_equal(got.numpy(), np.asarray(want))
    assert float(ising3d.magnetization_3d(got)) == float(
        jising3d.magnetization_3d(want))


@pytest.mark.parametrize("temperature", TEMPS)
def test_mesh_step_equals_jax_on_one_device(temperature):
    """The JAX mesh step on a 1 x 1 mesh (its only device here) against
    the port's on 1 x 1, 2 x 2 and 4 x 1 meshes and its single-device
    run: one lattice, bit for bit."""
    assert_tables_agree(temperature)
    n, seed, sweeps = 8, 2 ** 33 + 3, 4
    cube = random_cube(3, n=n)
    jmesh = jax_make_mesh((1, 1), ("data", "model"))
    jstep, sharding = jising3d.make_ising3d_step(jmesh, n=n, seed=seed,
                                                 n_sweeps=sweeps)
    want = np.asarray(jstep(jax.device_put(jnp.asarray(cube), sharding),
                            jnp.float32(1.0 / temperature), jnp.uint32(6)))
    beta = np.float32(1.0 / temperature)
    single = ising3d.run_sweeps_3d(torch.from_numpy(cube),
                                   ising3d.acceptance_table_3d(beta), sweeps,
                                   seed, start_offset=6)
    assert np.array_equal(single.numpy(), want)
    for shape in ((1, 1), (2, 2), (4, 1)):
        mesh = make_mesh(shape, ("data", "model"), "cpu")
        step, split, gather = ising3d.make_ising3d_step(
            mesh, n=n, seed=seed, n_sweeps=sweeps)
        got = gather(step(split(torch.from_numpy(cube)), beta, 6))
        assert np.array_equal(got.numpy(), want), shape


def test_slab_runs_equal_the_single_device_run():
    """Slabs over all axes, over one axis (the other's shards hold
    copies), at an offset near 2^32."""
    n, seed = 8, 7
    cube = torch.from_numpy(random_cube(4, n=n))
    table = ising3d.acceptance_table_3d(1 / 3.5)
    want = ising3d.run_sweeps_3d(cube, table, 3, seed, 2 ** 32 - 3)
    mesh = make_mesh((2, 4), ("data", "model"), "cpu")
    for axes in (None, ("model",), ("data",), ("model", "data")):
        step, split, gather = ising3d.make_ising3d_step(
            mesh, n=n, seed=seed, n_sweeps=3, slab_axes=axes)
        shards = step(split(cube), 1 / 3.5, 2 ** 32 - 3)
        assert torch.equal(gather(shards), want), axes
        assert len(shards) == 8


def test_mesh_step_rejects_a_ring_that_does_not_divide():
    mesh = make_mesh((3, 1), ("data", "model"), "cpu")
    with pytest.raises(ValueError, match="slabs"):
        ising3d.make_ising3d_step(mesh, n=8)


def test_mesh_step_equals_jax_on_a_4x2_mesh(tmp_path):
    """The JAX package's own distributed case (8 host devices, a (4, 2)
    mesh, slabs over both axes), in a subprocess: its lattice is the
    port's (4, 2) slab run's and single-device run's."""
    out = tmp_path / "jax3d.npy"
    script = textwrap.dedent(f"""
        import os
        os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
        import jax, jax.numpy as jnp, numpy as np
        from repro.core import ising3d
        from repro.launch.mesh import make_mesh
        mesh = make_mesh((4, 2), ("data", "model"))
        step, sh = ising3d.make_ising3d_step(mesh, n=16, seed=3,
                                             n_sweeps=6)
        rs = np.random.default_rng(5)
        cube = np.where(rs.random((16, 16, 16)) < 0.8, 1, -1).astype(np.int8)
        full = jax.device_put(jnp.asarray(cube), sh)
        out = step(full, jnp.float32(1 / 3.5), jnp.uint32(0))
        np.save({str(out)!r}, np.asarray(out))
    """)
    env = dict(os.environ)
    env["PYTHONPATH"] = str(ROOT / "src")
    env.pop("XLA_FLAGS", None)
    proc = subprocess.run([sys.executable, "-c", script], env=env,
                          capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-2000:]
    want = np.load(out)
    rs = np.random.default_rng(5)
    cube = torch.from_numpy(
        np.where(rs.random((16, 16, 16)) < 0.8, 1, -1).astype(np.int8))
    mesh = make_mesh((4, 2), ("data", "model"), "cpu")
    step, split, gather = ising3d.make_ising3d_step(mesh, n=16, seed=3,
                                                    n_sweeps=6)
    assert np.array_equal(gather(step(split(cube), 1 / 3.5, 0)).numpy(),
                          want)
    single = ising3d.run_sweeps_3d(cube, ising3d.acceptance_table_3d(
        np.float32(1 / 3.5)), 6, 3)
    assert np.array_equal(single.numpy(), want)


def test_3d_orders_below_tc_disorders_above():
    full = torch.ones((16, 16, 16), dtype=torch.int8)
    cold = ising3d.run_sweeps_3d(full, ising3d.acceptance_table_3d(1 / 3.5),
                                 60, seed=4)
    assert abs(float(ising3d.magnetization_3d(cold))) > 0.85
    hot = ising3d.run_sweeps_3d(full, ising3d.acceptance_table_3d(1 / 8.0),
                                60, seed=4)
    assert abs(float(ising3d.magnetization_3d(hot))) < 0.2


def test_3d_critical_temperature_constant():
    assert ising3d.T_CRITICAL_3D == jising3d.T_CRITICAL_3D
