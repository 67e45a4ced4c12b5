"""The 2D +-J spin glass in the port (CPU): its functions on the JAX
package's couplings, lattices and uniforms give the JAX values exactly;
checkpoints carry the couplings both ways; at ``p_ferro = 1`` a run is
``basic_philox``'s; and the JAX package's two physics gates at 32^2
(``tests/test_models_extended.py``) hold for the port's engine."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.api as japi
import repro_torch.api as tapi
from repro.core import lattice as jlat
from repro.core import spinglass as jsg
from repro_torch.api import Session
from repro_torch.core import lattice as lat
from repro_torch.core import metropolis, spinglass

N, M = 16, 24
SEED = 2 ** 33 + 9


def jax_disorder(key_seed, n=N, m=M, p_ferro=0.5):
    """A JAX lattice and its couplings, as host int8 arrays."""
    key = jax.random.PRNGKey(key_seed)
    j_up, j_left = jsg.init_couplings(key, n, m, p_ferro=p_ferro)
    full = jlat.init_lattice(jax.random.fold_in(key, 1), n, m)
    return tuple(np.array(a) for a in (full, j_up, j_left))


def torch_of(*arrays):
    return tuple(torch.from_numpy(a) for a in arrays)


@pytest.mark.parametrize("key_seed,p_ferro", [(0, 0.5), (1, 0.2), (2, 1.0)])
def test_weighted_sums_and_energy_equal_jax(key_seed, p_ferro):
    full, j_up, j_left = jax_disorder(key_seed, p_ferro=p_ferro)
    want = np.asarray(jsg.weighted_neighbor_sums(full, j_up, j_left))
    got = spinglass.weighted_neighbor_sums(*torch_of(full, j_up, j_left))
    assert got.dtype == torch.int8
    assert np.array_equal(got.numpy().astype(np.int32), want)
    e = spinglass.energy_per_spin(*torch_of(full, j_up, j_left))
    assert e.dtype == torch.float32
    assert e.item() == float(jsg.energy_per_spin(full, j_up, j_left))


@pytest.mark.parametrize("temperature", [0.5, 2.2])
@pytest.mark.parametrize("color", [0, 1])
def test_update_color_equals_jax_on_jax_uniforms(temperature, color):
    """A half-sweep on JAX's couplings and (n, m) uniforms flips what the
    JAX function flips (at temperatures where its ``jnp.exp`` gives the
    port's table entry for entry)."""
    beta = np.float32(1.0 / temperature)
    table = metropolis.acceptance_table(beta)
    args = jnp.asarray(metropolis.acceptance_arguments(beta))
    assert np.array_equal(table.numpy(), np.asarray(jnp.exp(args)))
    full, j_up, j_left = jax_disorder(3)
    u = np.array(jax.random.uniform(jax.random.PRNGKey(4), (N, M)))
    want = jsg.update_color(full, j_up, j_left, u, jnp.float32(beta), color)
    got = spinglass.update_color(*torch_of(full, j_up, j_left, u), table,
                                 color)
    assert np.array_equal(got.numpy(), np.asarray(want))
    assert not np.array_equal(got.numpy(), full)


def test_ferromagnetic_limit_is_the_ising_sum():
    """J = +1 everywhere: the weighted sum of a black site is its
    four-neighbour sum of the white plane."""
    full = torch.from_numpy(np.array(jlat.init_lattice(
        jax.random.PRNGKey(0), 16, 16)))
    ones = torch.ones((16, 16), dtype=torch.int8)
    nn = spinglass.weighted_neighbor_sums(full, ones, ones)
    b, w = lat.split_checkerboard(full)
    nn_b, _ = lat.split_checkerboard(nn)
    assert torch.equal(nn_b, metropolis.neighbor_sums(w, is_black=True))


def test_bond_symmetry():
    """sum_i s_i (sum_j J_ij s_j) = 2 sum_<ij> J_ij s_i s_j = -2 N e."""
    full = lat.merge_checkerboard(*lat.init_planes(8, 8, 0.5, 3, "cpu"))
    j_up, j_left = spinglass.init_couplings(8, 8, 0.5, 3, "cpu")
    nn = spinglass.weighted_neighbor_sums(full, j_up, j_left)
    lhs = int((full.to(torch.int64) * nn.to(torch.int64)).sum())
    e = spinglass.energy_per_spin(full, j_up, j_left).item() * full.numel()
    assert lhs == pytest.approx(-2.0 * e)


def test_couplings_are_lanes_0_and_1_of_their_stream():
    from repro_torch.core import rng
    j_up, j_left = spinglass.init_couplings(4, 6, 0.3, SEED, "cpu")
    k0, k1 = rng.seed_keys(SEED)
    bits = rng.philox4x32(0, rng.COUPLING_LANE, torch.arange(24), 0, k0, k1)
    for plane, lane in ((j_up, 0), (j_left, 1)):
        u = rng.u32_to_uniform(bits[lane]).reshape(4, 6)
        want = torch.where(u < torch.tensor(0.3, dtype=torch.float32), 1, -1)
        assert torch.equal(plane, want.to(torch.int8))
    # p_ferro 0.5: about half of each; a pure function of the seed
    a = spinglass.init_couplings(64, 64, 0.5, SEED, "cpu")
    b = spinglass.init_couplings(64, 64, 0.5, SEED, "cpu")
    assert all(torch.equal(x, y) for x, y in zip(a, b))
    assert 0.4 < float((a[0] == 1).float().mean()) < 0.6


def spec_of(package, p_ferro=0.5, **kw):
    kw.setdefault("temperature", 2.2)
    return package.RunSpec(
        lattice=package.LatticeSpec(N, M),
        engine=package.EngineSpec("spinglass", {"p_ferro": p_ferro}),
        seed=SEED, **kw)


def test_jax_checkpoint_restores_with_its_couplings(tmp_path):
    s = japi.Session.open(spec_of(japi, p_ferro=0.4))
    s.run(2)
    path = str(tmp_path / "jax.npz")
    s.save(path)
    r = Session.restore(path, device="cpu")
    assert r.state_digest() == s.state_digest()
    jarrays = s._runner.engine.state_arrays(s.state)
    for k, v in r._runner.state_arrays().items():
        assert np.array_equal(v, jarrays[k]), k
    r.run(3)
    after = r._runner.state_arrays()
    assert np.array_equal(after["j_up"], jarrays["j_up"])
    assert np.array_equal(after["j_left"], jarrays["j_left"])
    assert r._runner.cfg.p_ferro == 0.4


def test_port_checkpoint_restores_in_jax(tmp_path):
    s = Session.open(spec_of(tapi, p_ferro=0.6), device="cpu")
    s.run(3)
    path = str(tmp_path / "port.npz")
    s.save(path)
    r = japi.Session.restore(path)
    assert r.state_digest() == s.state_digest()
    arrays = r._runner.engine.state_arrays(r.state)
    for k, v in s._runner.state_arrays().items():
        assert np.array_equal(arrays[k], v), k
    assert r.spec.engine.param_dict == {"p_ferro": 0.6}


def test_p_ferro_one_is_basic_philox():
    glass = Session.open(spec_of(tapi, p_ferro=1.0), device="cpu")
    basic = Session.open(tapi.RunSpec(
        lattice=tapi.LatticeSpec(N, M), engine=tapi.EngineSpec(
            "basic_philox"), temperature=2.2, seed=SEED), device="cpu")
    assert torch.equal(glass.full_lattice(), basic.full_lattice())
    for s in (glass, basic):
        s.run(7)
    assert torch.equal(glass.full_lattice(), basic.full_lattice())
    assert glass.energy() == basic.energy()


def test_spinglass_restore_continues_bit_for_bit(tmp_path):
    s = Session.open(spec_of(tapi), device="cpu")
    s.run(2)
    s.save(str(tmp_path / "s.npz"))
    r = Session.restore(str(tmp_path / "s.npz"), device="cpu")
    for x in (s, r):
        x.run(3)
    assert s.state_digest() == r.state_digest()


def glass_session(seed):
    """The JAX gates' cell: 32^2, hot start, inverse temperature 2."""
    spec = tapi.RunSpec(lattice=tapi.LatticeSpec(32, 32),
                        engine=tapi.EngineSpec("spinglass"),
                        temperature=0.5, seed=seed)
    return Session.open(spec, device="cpu")


def test_quench_lowers_energy():
    s = glass_session(2)
    e0 = s.energy()
    s.run(200)
    assert s.energy() < e0 - 0.3


def test_frustration_keeps_m_small():
    s = glass_session(3)
    s.run(300)
    assert abs(s.magnetization()) < 0.25
