"""repro_torch.core.rng against repro.core.rng: Philox4x32-10 bits, the
64-bit seed split, half-sweep offsets and the uint32 -> float32 cast,
all bit-exact."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import rng as jrng
from repro_torch.core import rng


def _jax_bits(values):
    return [jnp.asarray(v.astype(np.uint32)) for v in values]


def _torch_bits(values):
    return [torch.from_numpy(v.astype(np.int64)) for v in values]


@pytest.mark.parametrize("seed", [0, 1, 7])
def test_philox_matches_reference_on_random_counters_and_keys(seed):
    r = np.random.default_rng(seed)
    values = r.integers(0, 2 ** 32, size=(6, 2048), dtype=np.uint64)
    want = jrng.philox4x32(*_jax_bits(values))
    got = rng.philox4x32(*_torch_bits(values))
    for w, g in zip(want, got):
        np.testing.assert_array_equal(np.asarray(w).astype(np.int64),
                                      g.numpy())


def test_philox_known_answer_zero():
    out = rng.philox4x32(0, 0, 0, 0, 0, 0)
    assert [int(x) for x in out] == [0x6627E8D5, 0xE169C58D, 0xBC57AC4C,
                                     0x9B00DBD8]


def test_philox_extreme_limbs():
    ones = np.full(4, 2 ** 32 - 1, dtype=np.uint64)
    values = [ones, np.zeros(4, np.uint64), ones, ones, ones,
              np.array([0, 1, 2 ** 31, 2 ** 32 - 1], np.uint64)]
    want = jrng.philox4x32(*_jax_bits(values))
    got = rng.philox4x32(*_torch_bits(values))
    for w, g in zip(want, got):
        np.testing.assert_array_equal(np.asarray(w).astype(np.int64),
                                      g.numpy())


@pytest.mark.parametrize("a,b", [(0, 0), (2 ** 32 - 1, 2 ** 32 - 1),
                                 (0xD2511F53, 0x12345678), (65535, 65536)])
def test_mulhilo_matches_python_ints(a, b):
    hi, lo = rng._mulhilo32(torch.tensor(a), torch.tensor(b))
    assert int(hi) == (a * b) >> 32 and int(lo) == (a * b) & 0xFFFFFFFF


@pytest.mark.parametrize("seed", [0, 5, 2 ** 32 - 1, 2 ** 32, 2 ** 40 + 11,
                                  2 ** 64 - 1])
def test_seed_keys_match_reference(seed):
    want = tuple(int(k) for k in jrng.seed_keys(seed))
    assert rng.seed_keys(seed) == want


@pytest.mark.parametrize("start,sweep,color", [(0, 0, 0), (6, 3, 1),
                                               (2 ** 32 - 1, 0, 1),
                                               (2 ** 32 - 3, 5, 0)])
def test_half_sweep_offset_wraps_like_reference(start, sweep, color):
    want = int(jrng.half_sweep_offset(start, sweep, color))
    assert rng.half_sweep_offset(start, sweep, color) == want


def test_u32_to_uniform_rounds_like_reference():
    r = np.random.default_rng(3)
    bits = np.concatenate([
        r.integers(0, 2 ** 32, 4096, dtype=np.uint64),
        np.array([0, 1, 2 ** 24 + 1, 2 ** 25 + 3, 0xFFFFFF7F, 0xFFFFFF80,
                  0xFFFFFFFF], np.uint64)])
    want = np.asarray(jrng.u32_to_uniform(jnp.asarray(bits.astype(np.uint32))))
    got = rng.u32_to_uniform(torch.from_numpy(bits.astype(np.int64)))
    np.testing.assert_array_equal(want, got.numpy())
    assert float(got[-1]) == 1.0
