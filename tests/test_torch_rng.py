"""repro_torch.core.rng against repro.core.rng: Philox4x32-10 bits, the
64-bit seed split, half-sweep offsets and the uint32 -> float32 cast,
all bit-exact."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import rng as jrng
from repro_torch.core import multispin as ms
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


# -- the hoisted Philox of csrc/philox_lane0.cuh -----------------------------

M0, M1, W0, W1 = 0xD2511F53, 0xCD9E8D57, 0x9E3779B9, 0xBB67AE85
MASK = 0xFFFFFFFF


def _mulhilo(a, b):
    p = np.asarray(a, np.uint64) * np.uint64(b)
    return p >> np.uint64(32), p & np.uint64(MASK)


class HoistedPhiloxModel:
    """numpy model of ``HoistedPhilox`` (``csrc/philox_lane0.cuh``):
    Philox4x32-10 at counter ``(offset, 0, site, 0)``, what depends on the
    offset and the key alone computed once (the key schedule, round 0's
    product of the offset, round 1's product of the lane that round 0
    leaves the same for every site), then per site one product in rounds
    0 and 1, two in rounds 2 to 8, and round 9's products of the lanes
    asked for.  :meth:`pair` models ``HoistedPhiloxPair``: the calls at
    ``offset`` and ``offset + 1`` with rounds 0 and 1's site products
    made once for both."""

    def __init__(self, offset, key0, key1):
        self.offset = offset
        self.k0 = [np.uint64((key0 + r * W0) & MASK) for r in range(10)]
        self.k1 = [np.uint64((key1 + r * W1) & MASK) for r in range(10)]
        self.x2_xor, self.z2_xor, self.x3_xor = self._offset_terms(offset)
        self.products = 0      # per-site products, counted as they run

    def _offset_terms(self, offset):
        hi, lo = _mulhilo(offset, M0)
        z1, w1 = hi ^ self.k1[0], lo
        hi, lo = _mulhilo(z1, M1)
        return hi ^ self.k0[1], w1 ^ self.k1[1], lo ^ self.k0[2]

    def _mul(self, a, m):
        self.products += 1
        return _mulhilo(a, m)

    def _rounds01(self, site):
        """Round 0's and round 1's site products: x1's product and y1."""
        hi1, lo1 = self._mul(site, M1)
        x1, y1 = hi1 ^ self.k0[0], lo1
        return self._mul(x1, M0), y1

    def _rounds(self, site, terms=None):
        x2_xor, z2_xor, x3_xor = terms or (self.x2_xor, self.z2_xor,
                                           self.x3_xor)
        (hi0, lo0), y1 = self._rounds01(site)
        return self._rounds2to8(y1 ^ x2_xor, hi0 ^ z2_xor, lo0, x3_xor)

    def _rounds2to8(self, x, z, w, x3_xor):
        hi0, lo0 = self._mul(x, M0)
        hi1, lo1 = self._mul(z, M1)
        x, y, z, w = hi1 ^ x3_xor, lo1, hi0 ^ w ^ self.k1[2], lo0
        for r in range(3, 9):
            hi0, lo0 = self._mul(x, M0)
            hi1, lo1 = self._mul(z, M1)
            x, y, z, w = hi1 ^ y ^ self.k0[r], lo1, hi0 ^ w ^ self.k1[r], lo0
        return x, y, z, w

    def _round9(self, x, y, z, w):
        hi0, lo0 = self._mul(x, M0)
        hi1, lo1 = self._mul(z, M1)
        return hi1 ^ y ^ self.k0[9], lo1, hi0 ^ w ^ self.k1[9], lo0

    def lanes01(self, site):
        x, y, z, w = self._rounds(site)
        hi, lo = self._mul(z, M1)
        return hi ^ y ^ self.k0[9], lo

    def lanes(self, site):
        return self._round9(*self._rounds(site))

    def pair(self, site):
        """The 8 lanes of the calls at ``offset`` and ``offset + 1``
        (mod 2^32): round 0's product of the site and round 1's of x1
        made once, then 16 products a call."""
        (hi0, lo0), y1 = self._rounds01(site)
        out = []
        for terms in ((self.x2_xor, self.z2_xor, self.x3_xor),
                      self._offset_terms((self.offset + 1) & MASK)):
            x2_xor, z2_xor, x3_xor = terms
            out += self._round9(*self._rounds2to8(
                y1 ^ x2_xor, hi0 ^ z2_xor, lo0, x3_xor))
        return out


def _sites(seed):
    r = np.random.default_rng(seed)
    return np.concatenate([r.integers(0, 2 ** 32, 4096, dtype=np.uint64),
                           np.array([0, 1, 2 ** 31, MASK], np.uint64)])


@pytest.mark.parametrize("seed", [5, 2 ** 32 + 7, 2 ** 33 + 5, 2 ** 64 - 1])
@pytest.mark.parametrize("offset", [0, 3, 2 ** 31, MASK])
def test_hoisted_two_lane_philox_equals_philox_and_jax_pair(seed, offset):
    """Lanes 0 and 1 as ``tensorcore_update`` draws them, key (seed mod
    2^32, 0): 17 products a site; the same bits as ``philox4x32`` and,
    as uniforms, as the JAX kernel's ``_philox_uniform_pair``."""
    from repro.kernels.tensorcore.tensorcore import _philox_uniform_pair
    sites = _sites(seed % 1000 + offset % 7)
    key = seed & MASK
    model = HoistedPhiloxModel(offset, key, 0)
    x, y = model.lanes01(sites)
    assert model.products == 17
    want = rng.philox4x32(offset, 0, torch.from_numpy(sites.astype(np.int64)),
                          0, key, 0)
    np.testing.assert_array_equal(x.astype(np.int64), want[0].numpy())
    np.testing.assert_array_equal(y.astype(np.int64), want[1].numpy())
    u1, u2 = _philox_uniform_pair(jnp.uint32(key), jnp.uint32(offset),
                                  jnp.asarray(sites.astype(np.uint32)))
    for got, theirs in ((x, u1), (y, u2)):
        np.testing.assert_array_equal(
            rng.u32_to_uniform(torch.from_numpy(got.astype(np.int64))).numpy(),
            np.asarray(theirs))


@pytest.mark.parametrize("seed", [5, 2 ** 32 + 7, 2 ** 40 + 11, 2 ** 64 - 1])
@pytest.mark.parametrize("offset", [0, 2 ** 31 - 1, 2 ** 32 - 3, MASK])
def test_hoisted_four_lane_philox_equals_philox(seed, offset):
    """All four lanes as the bitplane shard kernel draws an aligned group,
    key ``seed_keys(seed)``: 18 products a site, the bits of the JAX
    package's ``philox4x32`` and of the port's."""
    sites = _sites(seed % 1000 + offset % 7)
    k0, k1 = rng.seed_keys(seed)
    model = HoistedPhiloxModel(offset, k0, k1)
    got = model.lanes(sites)
    assert model.products == 18
    theirs = jrng.philox4x32(*_jax_bits([
        np.full_like(sites, offset), np.zeros_like(sites), sites,
        np.zeros_like(sites), np.full_like(sites, k0),
        np.full_like(sites, k1)]))
    ours = rng.philox4x32(offset, 0, torch.from_numpy(sites.astype(np.int64)),
                          0, k0, k1)
    for g, t, o in zip(got, theirs, ours):
        np.testing.assert_array_equal(g.astype(np.int64),
                                      np.asarray(t).astype(np.int64))
        np.testing.assert_array_equal(g.astype(np.int64), o.numpy())


@pytest.mark.parametrize("seed", [2 ** 32 + 7, 2 ** 33 + 5, 2 ** 40 + 11,
                                  2 ** 64 - 1])
@pytest.mark.parametrize("offset", [0, 2 ** 31 - 1, 2 ** 31, 2 ** 32 - 1])
def test_hoisted_philox_pair_equals_word_randoms(seed, offset):
    """The two calls of a multispin word as ``HoistedPhiloxPair`` draws
    them, counters 2 offset and 2 offset + 1 (2 offset wraps modulo 2^32),
    key ``seed_keys(seed)`` with both lanes non-zero: 34 products a word,
    the bits of the JAX package's ``philox4x32`` and of the port's
    ``word_randoms``."""
    words = _sites(seed % 1000 + offset % 7)
    k0, k1 = rng.seed_keys(seed)
    assert k0 and k1
    counter = (2 * offset) & MASK
    model = HoistedPhiloxModel(counter, k0, k1)
    got = model.pair(words)
    assert model.products == 34
    ours = ms.word_randoms(seed, torch.from_numpy(words.astype(np.int64)),
                           offset)
    theirs = [np.asarray(t).astype(np.int64) for c in (counter, counter + 1)
              for t in jrng.philox4x32(*_jax_bits([
                  np.full_like(words, c), np.zeros_like(words), words,
                  np.zeros_like(words), np.full_like(words, k0),
                  np.full_like(words, k1)]))]
    for g, o, t in zip(got, ours, theirs):
        np.testing.assert_array_equal(g.astype(np.int64), o.numpy())
        np.testing.assert_array_equal(g.astype(np.int64), t)
