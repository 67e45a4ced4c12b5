"""Wolff cluster updates in the port (CPU): ``grow_cluster`` fed the seed
site and the uniforms that the JAX package's ``wolff_step`` draws (its
``split``s replayed here) gives the JAX lattice and cluster size; the
JAX package's three gates (``tests/test_extensions.py``) hold for the
port's own stream; the engine's checkpoints and its stream."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.api as japi
import repro_torch.api as tapi
from repro.core import lattice as jlat
from repro.core import wolff as jwolff
from repro_torch.api import Session
from repro_torch.core import lattice as lat
from repro_torch.core import rng, wolff


def jax_replay(key, lattice):
    """The seed site and the ``draw(depth)`` of JAX's ``wolff_step(key,
    lattice, T)``: its ``split``s replayed."""
    n, m = lattice.shape
    k_seed, k_loop = jax.random.split(key)
    site = int(jax.random.randint(k_seed, (), 0, n * m))
    state = {"key": k_loop, "depth": 0}

    def draw(depth):
        assert depth == state["depth"]
        state["key"], kd = jax.random.split(state["key"])
        state["depth"] += 1
        return torch.from_numpy(np.array(jax.random.uniform(kd, (n, m))))
    return site, draw


@pytest.mark.parametrize("temperature", [1.5, 2.269, 3.0])
@pytest.mark.parametrize("check_every", [1, 16])
@pytest.mark.parametrize("key_seed", [0, 1, 2])
def test_grow_cluster_on_jax_draws_is_jax_wolff_step(temperature,
                                                      check_every, key_seed):
    """The float32 ``p_add`` is the JAX package's at these temperatures;
    testing the frontier every 16 depths changes nothing."""
    p = wolff.p_add(temperature)
    assert np.float32(p) == np.float32(
        1.0 - jnp.exp(-2.0 / jnp.float32(temperature)))
    key = jax.random.PRNGKey(key_seed)
    full = jlat.init_lattice(jax.random.fold_in(key, 9), 16, 24)
    step_key = jax.random.fold_in(key, 1)
    want, size = jwolff.wolff_step(step_key, full, jnp.float32(temperature))
    site, draw = jax_replay(step_key, full)
    lattice = torch.from_numpy(np.array(full))
    cluster = wolff.grow_cluster(lattice, site, p, draw,
                                 check_every=check_every)
    got, got_size = wolff.flip_cluster(lattice, cluster)
    assert np.array_equal(got.numpy(), np.asarray(want))
    assert int(got_size) == int(size)


def test_cluster_properties():
    full = lat.merge_checkerboard(*lat.init_planes(16, 16, 0.5, 1, "cpu"))
    new, size = wolff.wolff_step(full, 2.0, seed=1, cluster=1)
    assert 1 <= int(size) <= 16 * 16
    diff = new != full
    assert int(diff.sum()) == int(size)       # exactly the cluster flipped
    # every flipped site had the same spin
    assert len(set(full[diff].tolist())) == 1


def test_cluster_size_grows_at_low_temperature():
    full = torch.ones((24, 24), dtype=torch.int8)
    _, size_cold = wolff.run_wolff(full, 1.0, 20, seed=2)
    _, size_hot = wolff.run_wolff(full, 10.0, 20, seed=2)
    assert float(size_cold) > 10 * float(size_hot)


def test_wolff_preserves_equilibrium():
    """At T = 1.8 an ordered lattice stays at the spontaneous value."""
    out, _ = wolff.run_wolff(torch.ones((32, 32), dtype=torch.int8), 1.8,
                             60, seed=3)
    assert abs(float(out.to(torch.float32).mean())) > 0.80


def test_seed_site_is_lane_0_of_its_counter():
    k0, k1 = rng.seed_keys(2 ** 40 + 7)
    for cluster in (0, 5, 2 ** 32 + 3):
        bits = int(rng.philox4x32(cluster & rng.MASK32, 2, 0, 0, k0, k1)[0])
        site = wolff.seed_site(30, 50, 2 ** 40 + 7, cluster)
        assert site == (bits * 1500) >> 32 and 0 <= site < 1500


def test_bond_draws_are_their_counters():
    draw = wolff.bond_draws(4, 6, 11, 7, "cpu")
    k0, k1 = rng.seed_keys(11)
    bits = rng.philox4x32(7, rng.WOLFF_LANE, torch.arange(24), 3, k0, k1)[0]
    assert torch.equal(draw(2), rng.u32_to_uniform(bits).reshape(4, 6))


def spec_of(package, **kw):
    return package.RunSpec(lattice=package.LatticeSpec(16, 16,
                                                       init_p_up=1.0),
                           engine=package.EngineSpec("wolff"),
                           temperature=2.0, seed=5, **kw)


def test_engine_sweep_is_one_cluster_of_the_step_count():
    """``run(3)`` from step 2 flips clusters 2, 3 and 4."""
    s = Session.open(spec_of(tapi), device="cpu")
    s.step_count = 2
    start = s.full_lattice().clone()
    s.run(3)
    want = start
    for c in (2, 3, 4):
        want, _ = wolff.wolff_step(want, 2.0, 5, c)
    assert torch.equal(s.full_lattice(), want)
    assert s.step_count == 5


def test_wolff_checkpoints_restore_both_ways(tmp_path):
    jax_session = japi.Session.open(spec_of(japi))
    jax_session.run(2)
    path = str(tmp_path / "jax.npz")
    jax_session.save(path)
    s = Session.restore(path, device="cpu")
    assert s.state_digest() == jax_session.state_digest()
    s.run(3)
    s.save(str(tmp_path / "port.npz"))
    back = japi.Session.restore(str(tmp_path / "port.npz"))
    assert back.state_digest() == s.state_digest()
    r = Session.restore(str(tmp_path / "port.npz"), device="cpu")
    for x in (s, r):
        x.run(2)
    assert s.state_digest() == r.state_digest()


def test_measure_takes_the_loop():
    from repro_torch.analysis import MeasurementPlan
    s = Session.open(spec_of(tapi), device="cpu")
    traj = s.measure(MeasurementPlan(3, 2, thermalize=1))
    assert traj["m"].shape == (3,) and traj["e"].shape == (3,)
    assert s.step_count == 7
