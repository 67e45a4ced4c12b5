"""repro_torch lattice layout, observables and CRC32C against the JAX
package, bit-exact (float32 observables are exact below 2^24 spins)."""
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import lattice as jlat
from repro.core import observables as jobs
from repro.resilience import integrity as jintegrity
from repro_torch.core import lattice as lat
from repro_torch.core import observables as obs
from repro_torch.resilience import integrity

SHAPES = [(8, 12), (16, 32), (6, 10), (2, 2)]


def _lattice(n, m, seed=0, p_up=0.5):
    r = np.random.default_rng(seed)
    return np.where(r.random((n, m)) < p_up, 1, -1).astype(np.int8)


@pytest.mark.parametrize("n,m", SHAPES)
def test_split_merge_match_reference(n, m):
    full = _lattice(n, m)
    jb, jw = jlat.split_checkerboard(jnp.asarray(full))
    b, w = lat.split_checkerboard(torch.from_numpy(full))
    np.testing.assert_array_equal(np.asarray(jb), b.numpy())
    np.testing.assert_array_equal(np.asarray(jw), w.numpy())
    np.testing.assert_array_equal(lat.merge_checkerboard(b, w).numpy(), full)


@pytest.mark.parametrize("n,m", SHAPES)
@pytest.mark.parametrize("is_black", [True, False])
def test_side_shift_matches_reference(n, m, is_black):
    plane = _lattice(n, m // 2, seed=1)
    want = jlat.side_shift(jnp.asarray(plane), is_black)
    got = lat.side_shift(torch.from_numpy(plane), is_black)
    np.testing.assert_array_equal(np.asarray(want), got.numpy())


@pytest.mark.parametrize("n,m", SHAPES)
@pytest.mark.parametrize("p_up", [0.5, 0.9])
def test_observables_match_reference(n, m, p_up):
    full = _lattice(n, m, seed=2, p_up=p_up)
    jb, jw = jlat.split_checkerboard(jnp.asarray(full))
    b, w = lat.split_checkerboard(torch.from_numpy(full))
    tfull = torch.from_numpy(full)
    pairs = [
        (jobs.magnetization(jb, jw), obs.magnetization(b, w)),
        (jobs.magnetization_full(jnp.asarray(full)),
         obs.magnetization_full(tfull)),
        (jobs.energy_per_spin_full(jnp.asarray(full)),
         obs.energy_per_spin_full(tfull)),
        (jobs.energy_per_spin(jb, jw), obs.energy_per_spin(b, w)),
    ]
    for want, got in pairs:
        assert got.dtype == torch.float32
        assert np.float32(want) == got.numpy(), (want, got)


@pytest.mark.parametrize("t", [1.0, 1.8, 2.0, 2.2, 2.5])
def test_onsager_matches_reference(t):
    want = float(jobs.onsager_magnetization(t))
    assert obs.onsager_magnetization(t) == pytest.approx(want, rel=1e-6,
                                                         abs=1e-7)
    assert obs.T_CRITICAL == jobs.T_CRITICAL


def test_init_planes_ordered_and_hot():
    b, w = lat.init_planes(32, 16, 1.0, 5, "cpu")
    assert b.dtype == torch.int8 and b.shape == (32, 8)
    assert bool((b == 1).all() and (w == 1).all())
    b, w = lat.init_planes(32, 16, 0.0, 5, "cpu")
    assert bool((b == -1).all() and (w == -1).all())
    b, w = lat.init_planes(64, 64, 0.5, 2 ** 40 + 3, "cpu")
    assert abs(float(obs.magnetization(b, w))) < 0.1


def test_init_planes_is_chunk_invariant(monkeypatch):
    """The lattice depends on the seed alone, not on the chunking."""
    whole = lat.init_planes(12, 20, 0.5, 99, "cpu")
    monkeypatch.setattr(lat, "_INIT_CHUNK_SITES", 40)
    chunked = lat.init_planes(12, 20, 0.5, 99, "cpu")
    for a, b in zip(whole, chunked):
        assert torch.equal(a, b)


@pytest.mark.parametrize("size", [0, 1, 7, 8, 100, 2047, 2048, 4099, 70000])
def test_crc32c_matches_reference(size):
    data = np.random.default_rng(size).integers(
        0, 256, size, dtype=np.uint8).tobytes()
    assert integrity.crc32c(data) == jintegrity.crc32c(data)
    assert integrity.crc32c(data, 0x1234) == jintegrity.crc32c(data, 0x1234)


def test_crc32c_check_vector_and_chaining():
    assert integrity.crc32c_hex(b"123456789") == "e3069283"
    a, b = os.urandom(3000), os.urandom(50)
    assert integrity.crc32c(b, integrity.crc32c(a)) == integrity.crc32c(a + b)


def test_observable_sums_are_chunk_invariant(monkeypatch):
    b, w = lat.split_checkerboard(torch.from_numpy(_lattice(10, 12, 4)))
    whole = (obs.magnetization(b, w), obs.energy_per_spin(b, w))
    monkeypatch.setattr(obs, "_SUM_CHUNK", 7)  # one row per chunk
    assert (obs.magnetization(b, w), obs.energy_per_spin(b, w)) == whole
