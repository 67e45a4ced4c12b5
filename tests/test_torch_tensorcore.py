"""The port's tensor-core engine (paper S3.2) against the JAX package, on
the CPU: the plane algebra of ``core/tensorcore.py``, the fused
``tensorcore_update`` (its plain version here) against JAX's Pallas
kernel in interpret mode and its oracle, the sweeps, and the slice as a
whole -- a JAX ``tensorcore`` checkpoint resumes in the port with the
same digest and then follows JAX's ``run_sweeps_tensorcore``, and back.

Every comparison is exact: the spins and K are exact in bf16, the sums in
float32, and at T = 2.0 and 2.2 the port's acceptance table decides flips
as ``jnp.exp`` does (asserted below)."""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.api as japi
from repro.core import observables as jobs
from repro.core import tensorcore as jtc
from repro.kernels.tensorcore import ops as jops
from repro.kernels.tensorcore.ref import tensorcore_update_ref as jref
from repro.kernels.tensorcore.tensorcore import \
    tensorcore_update as jtensorcore_update
from repro_torch import __main__ as cli
from repro_torch.api import EngineSpec, LatticeSpec, RunSpec, Session
from repro_torch.api import spec as tspec
from repro_torch.core import metropolis, observables, rng
from repro_torch.core import tensorcore as tc
from repro_torch.kernels.tensorcore import (run_sweeps_tensorcore,
                                            tensorcore_update,
                                            tensorcore_update_plain)

TEMPERATURE = 2.2
BETA = 1.0 / TEMPERATURE
SEEDS = (21, 2 ** 33 + 5)     # the second keys on (5, 0): low 32 bits
N, M, BLOCK = 32, 64, 8       # the Session tests' lattice and block
PRE = 3                       # sweeps the JAX run makes before it saves
RUN = 5                       # sweeps after the restore


def full_lattice(n, m, seed):
    r = np.random.default_rng(seed)
    return np.where(r.random((n, m)) < 0.5, 1, -1).astype(np.int8)


def jax_planes(full, dtype=jnp.bfloat16):
    return {k: v.astype(dtype) for k, v in jtc.decompose(
        jnp.asarray(full)).items()}


def port_planes(full, dtype=torch.int8):
    return {k: v.to(dtype) for k, v in tc.decompose(
        torch.from_numpy(full)).items()}


def as_int8(x):
    """A plane of either package as an int8 numpy array."""
    if isinstance(x, torch.Tensor):
        return x.to(torch.int8).numpy()
    return np.asarray(jnp.asarray(x, jnp.float32)).astype(np.int8)


def assert_planes_equal(got, want):
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_array_equal(as_int8(got[k]), as_int8(want[k]),
                                      err_msg=k)


def reference_table(beta):
    return np.asarray(jnp.exp(jnp.asarray(
        metropolis.acceptance_arguments(beta))))


@pytest.mark.parametrize("temperature", [2.0, 2.2])
def test_table_decides_flips_as_jnp_exp(temperature):
    """The premise of the exact comparisons: below 1 the port's table is
    jnp.exp's (an entry above 1 accepts every uniform)."""
    beta = 1.0 / temperature
    ours = metropolis.acceptance_table(beta).numpy()
    theirs = reference_table(beta)
    np.testing.assert_array_equal(np.where(ours > 1, np.inf, ours),
                                  np.where(theirs > 1, np.inf, theirs))


@pytest.mark.parametrize("block", [8, 16, 128])
def test_kernel_matrix_matches_reference(block):
    np.testing.assert_array_equal(
        tc.make_kernel_matrix(block).to(torch.float32).numpy(),
        np.asarray(jtc.make_kernel_matrix(block), np.float32))


@pytest.mark.parametrize("n,m", [(16, 32), (32, 16), (64, 64)])
def test_decompose_and_recompose_match_reference(n, m):
    full = full_lattice(n, m, n + m)
    ours = tc.decompose(torch.from_numpy(full))
    assert_planes_equal(ours, jtc.decompose(jnp.asarray(full)))
    assert all(p.is_contiguous() for p in ours.values())
    np.testing.assert_array_equal(tc.recompose(ours).numpy(), full)


@pytest.mark.parametrize("fn", ["local_nn_sums", "boundary_corrections",
                                "neighbor_sums_tc"])
@pytest.mark.parametrize("n,block", [(32, 8), (64, 16), (64, 32)])
def test_plane_sums_match_reference(fn, n, block):
    full = full_lattice(n, 2 * n, block)
    ours = getattr(tc, fn)(port_planes(full), block)
    theirs = getattr(jtc, fn)(jax_planes(full), block)
    assert sorted(ours) == sorted(theirs)
    for k in theirs:
        assert ours[k].dtype == torch.float32
        np.testing.assert_array_equal(ours[k].numpy(),
                                      np.asarray(theirs[k], np.float32))


def test_plane_sums_of_some_planes_equal_those_of_all():
    full = full_lattice(32, 32, 3)
    planes = port_planes(full)
    every = tc.neighbor_sums_tc(planes, 8)
    some = tc.neighbor_sums_tc(planes, 8, ("10", "01"))
    assert sorted(some) == ["01", "10"]
    for k in some:
        assert torch.equal(some[k], every[k])


@pytest.mark.parametrize("color", ["black", "white"])
def test_update_color_tc_matches_reference_with_its_uniforms(color):
    """JAX draws from jax.random keys; fed those uniforms, the port's
    update is JAX's."""
    full = full_lattice(32, 64, 5)
    key = jax.random.PRNGKey(9)
    want = jtc.update_color_tc(jax_planes(full, jnp.int8), color,
                               jnp.float32(BETA), key, 8)
    # JAX pairs its split keys with ('00', '11') and ('01', '10')
    jax_order = {"black": ("00", "11"), "white": ("01", "10")}[color]
    u = {k: torch.from_numpy(np.array(jax.random.uniform(sub, (16, 32))))
         for k, sub in zip(jax_order, jax.random.split(key, 2))}
    got = tc.update_color_tc(port_planes(full), color,
                             [u[k] for k in tc.COLOR_PLANES[color]],
                             metropolis.acceptance_table(BETA), 8)
    assert_planes_equal(got, want)
    assert got["00"].dtype == torch.int8


@functools.lru_cache(maxsize=None)
def jax_fused(n, block, color, seed):
    """JAX's Pallas kernel (interpret mode) and its oracle on the bf16
    planes of one lattice: the two must agree, and are returned once."""
    planes = jax_planes(full_lattice(n, n, n + block))
    kernel = jtensorcore_update(planes, color, jnp.float32(BETA), seed=seed,
                                offset=7, block=block, interpret=True)
    ref = jref(planes, color, jnp.float32(BETA), seed=seed, offset=7,
               block=block)
    assert_planes_equal(kernel, ref)
    return kernel


@pytest.mark.parametrize("n,block", [(32, 8), (64, 16), (128, 32)])
@pytest.mark.parametrize("color", ["black", "white"])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.int8])
@pytest.mark.parametrize("seed", SEEDS)
def test_tensorcore_update_matches_pallas_kernel(n, block, color, dtype,
                                                 seed):
    planes = port_planes(full_lattice(n, n, n + block), dtype)
    before = {k: v.clone() for k, v in planes.items()}
    plain = tensorcore_update_plain(planes, color, BETA, seed=seed,
                                    offset=7, block=block)
    for k in planes:                      # the plain version is pure
        assert torch.equal(planes[k], before[k])
    out = tensorcore_update(planes, color, BETA, seed=seed, offset=7,
                            block=block)
    assert out is planes                  # updated in place
    for k in planes:
        assert planes[k].dtype == dtype
        assert torch.equal(planes[k], plain[k])
    assert_planes_equal(planes, jax_fused(n, block, color, seed))


def test_seed_keys_on_its_low_32_bits():
    full = full_lattice(32, 32, 1)
    a = tensorcore_update_plain(port_planes(full), "black", BETA,
                                seed=2 ** 33 + 5, offset=3, block=8)
    b = tensorcore_update_plain(port_planes(full), "black", BETA, seed=5,
                                offset=3, block=8)
    c = tensorcore_update_plain(port_planes(full), "black", BETA, seed=6,
                                offset=3, block=8)
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert not all(torch.equal(a[k], c[k]) for k in a)


@pytest.mark.parametrize("dtype", [torch.int8, torch.bfloat16])
def test_run_sweeps_matches_reference(dtype):
    full = full_lattice(64, 64, 11)
    want = jops.run_sweeps_tensorcore(jax_planes(full), jnp.float32(BETA), 3,
                                      seed=SEEDS[1], start_offset=6,
                                      block=16, interpret=True)
    got = run_sweeps_tensorcore(port_planes(full, dtype), BETA, 3,
                                seed=SEEDS[1], start_offset=6, block=16)
    assert_planes_equal(got, want)


@pytest.mark.parametrize("temperature", [0.02, 0.05, 0.5, 2.0, 2.2, 3.0,
                                         100.0])
def test_draw_bounds_decide_as_the_float_compare(temperature):
    """The CUDA kernel flips iff draw < bound; the plain version iff
    float32(draw) 2^-32 < p.  Every draw at and beside each bound, the
    draws that round to 1.0, and random draws decide alike; at 0.02 and
    0.05 the table holds exact zeros, which no draw is below."""
    table = metropolis.acceptance_table(1.0 / temperature).numpy()
    bounds = metropolis.draw_bounds(table).astype(np.int64)
    near = np.concatenate([bounds + d for d in (-2, -1, 0, 1, 2)]
                          + [[0, 1, 2 ** 32 - 129, 2 ** 32 - 128,
                              2 ** 32 - 1]])
    draws = np.concatenate([near[(near >= 0) & (near < 2 ** 32)],
                            np.random.default_rng(7).integers(
                                0, 2 ** 32, 20000)])
    u = rng.u32_to_uniform(torch.from_numpy(draws)).numpy()
    for bound, p in zip(bounds, table):
        np.testing.assert_array_equal(draws < bound, u < p)
    assert bounds[7] == 2 ** 32 - 128    # p = 1: draws that round to 1.0
    np.testing.assert_array_equal(bounds[table == 0], 0)
    np.testing.assert_array_equal(bounds[table > 1], 2 ** 32)
    assert (table == 0).any() == (temperature < 0.077)


def test_wrapper_validates_planes():
    planes = port_planes(full_lattice(32, 32, 2))
    with pytest.raises(ValueError, match="tile"):
        tensorcore_update(planes, "black", BETA, block=12)
    with pytest.raises(ValueError, match="color"):
        tensorcore_update(planes, "red", BETA, block=8)
    with pytest.raises(ValueError, match="int8 or bf16"):
        tensorcore_update(dict(planes, **{"01": planes["01"].to(torch.int32)}),
                          "black", BETA, block=8)
    with pytest.raises(ValueError, match="differ"):
        tensorcore_update(dict(planes, **{"10": planes["10"][:8]}), "black",
                          BETA, block=8)
    with pytest.raises(ValueError, match="lack"):
        tensorcore_update({"00": planes["00"]}, "black", BETA, block=8)


def test_plane_observables_match_full_lattice_reference():
    full = full_lattice(32, 64, 13)
    planes = port_planes(full)
    assert observables.magnetization_planes(planes).item() == \
        float(jobs.magnetization_full(jnp.asarray(full)))
    assert observables.energy_per_spin_planes(planes).item() == \
        float(jobs.energy_per_spin_full(jnp.asarray(full)))


# -- the slice as a whole -----------------------------------------------------

def jax_spec(temperature=TEMPERATURE):
    return japi.RunSpec(lattice=japi.LatticeSpec(N, M),
                        engine=japi.EngineSpec("tensorcore",
                                               {"tc_block": BLOCK}),
                        temperature=temperature, seed=SEEDS[1])


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    """A JAX ``tensorcore`` checkpoint after PRE sweeps (its jax.random
    stream), and its planes."""
    path = str(tmp_path_factory.mktemp("tensorcore") / "jax.npz")
    s = japi.Session.open(jax_spec())
    s.run(PRE)
    s.save(path)
    return {"path": path, "digest": s.state_digest(), "state": s.state}


def test_reference_checkpoint_resumes_on_the_fused_stream(reference):
    s = Session.restore(reference["path"], device="cpu")
    assert s.engine.name == "tensorcore" and s.engine.block == BLOCK
    assert s.step_count == PRE
    assert s.state_digest() == reference["digest"]
    s.run(RUN)
    planes = {k: v.astype(jnp.bfloat16)
              for k, v in reference["state"].items()}
    want = jops.run_sweeps_tensorcore(planes, jnp.float32(BETA), RUN,
                                      seed=SEEDS[1], start_offset=2 * PRE,
                                      block=BLOCK, interpret=True)
    assert_planes_equal(s.state, want)


def test_port_checkpoint_restores_in_reference(reference, tmp_path):
    s = Session.restore(reference["path"], device="cpu")
    s.run(2)
    path = str(tmp_path / "port.npz")
    s.save(path)
    j = japi.Session.restore(path)
    assert j.step_count == PRE + 2
    assert j.state_digest() == s.state_digest()
    assert j.state["00"].dtype == jnp.int8


def test_restore_continue_equals_uninterrupted(tmp_path):
    spec = RunSpec.from_json(jax_spec().to_json())
    s = Session.open(spec, device="cpu")
    s.run(4)
    path = str(tmp_path / "ck.npz")
    s.save(path)
    r = Session.restore(path, device="cpu")
    plan = tspec.SweepSpec(measure_every=2, n_measure=3).plan()
    s.run(3)
    r.run(3)
    traj, traj_r = s.measure(plan), r.measure(plan)
    assert r.state_digest() == s.state_digest()
    for k in traj:
        np.testing.assert_array_equal(traj[k], traj_r[k])


def test_measure_matches_observables_of_the_reference_lattice():
    spec = RunSpec.from_json(jax_spec().to_json())
    s = Session.open(spec, device="cpu")
    traj = s.measure(tspec.SweepSpec(measure_every=1, n_measure=2).plan())
    full = jnp.asarray(s.full_lattice().numpy())
    assert traj["m"][-1] == float(jobs.magnetization_full(full))
    assert traj["e"][-1] == float(jobs.energy_per_spin_full(full))


def test_tc_block_is_validated_like_the_reference():
    doc = jax_spec().to_dict()
    assert tspec.RunSpec.from_dict(doc).to_json() == jax_spec().to_json()
    assert tspec.RunSpec.from_dict(doc).sim_config().tc_block == BLOCK
    for bad in (0, -8, 8.0, True):
        with pytest.raises(ValueError, match="tc_block"):
            EngineSpec("tensorcore", {"tc_block": bad})
    with pytest.raises(ValueError, match="must divide"):
        RunSpec(lattice=LatticeSpec(32, 32),
                engine=EngineSpec("tensorcore", {"tc_block": 32}))
    # the default block, 128, needs planes of multiples of 128
    with pytest.raises(ValueError, match="tc_block 128"):
        RunSpec(lattice=LatticeSpec(64, 64), engine=EngineSpec("tensorcore"))


def test_cli_runs_tensorcore_on_cpu(tmp_path, capsys):
    path = str(tmp_path / "cli.npz")
    assert cli.main(["run", "--device", "cpu", "--engine", "tensorcore",
                     "--tc-block", "16", "--n", "64", "--init-p-up", "1.0",
                     "--temperature", "2.0", "--sweeps", "3",
                     "--save", path]) == 0
    assert "ran 3 sweeps" in capsys.readouterr().out
    s = Session.restore(path, device="cpu")
    assert s.spec.engine.param_dict == {"tc_block": 16}
    assert s.step_count == 3
