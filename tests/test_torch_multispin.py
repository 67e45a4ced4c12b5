"""The multispin kernel pair's modules on the CPU: nibble packing, packed
neighbour sums, thresholds, draws and the packed half-sweep
(``repro_torch.core.multispin``) bit for bit against the JAX package;
the CPU wrappers against its Pallas kernels (interpret mode); the tiled
k-sweep algorithm of the CUDA kernel, emulated in PyTorch; the
multispin planner; and the engines."""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import lattice as jlat
from repro.core import multispin as jms
from repro.kernels.multispin.multispin import \
    multispin_update as jax_update
from repro.kernels.multispin.resident import \
    multispin_sweeps_resident as jax_resident
from repro_torch.api import EngineSpec, LatticeSpec, RunSpec, Session
from repro_torch.core import lattice as lat
from repro_torch.core import metropolis
from repro_torch.core import multispin as ms
from repro_torch.core import rng
from repro_torch.kernels import resident
from repro_torch.kernels.multispin import (multispin_sweeps_resident,
                                           multispin_update)
from repro_torch.kernels._words import key_table, thresholds_arg

BETA = 1 / 2.2
SMALL_SEED = 2 ** 30 + 19           # one key lane: the Pallas half-sweep's
BIG_SEED = 2 ** 40 + 7              # both key lanes
OFFSETS = (0, 2 ** 31 - 1, 2 ** 31, 2 ** 32 - 1)
SHAPES = ((16, 32), (8, 64))


def pm1_planes(n, m, seed=0):
    r = np.random.default_rng(seed)
    return tuple(np.where(r.random((n, m // 2)) < 0.5, 1, -1).astype(np.int8)
                 for _ in range(2))


def jax_words(n, m, seed=0):
    return jms.pack_lattice(*(jnp.asarray(p) for p in pm1_planes(n, m, seed)))


def to_port(words):
    """uint32 numpy/JAX words -> the port's int32 word tensor."""
    return torch.from_numpy(np.asarray(words).view(np.int32).copy())


def as_u32(words: torch.Tensor) -> np.ndarray:
    return words.numpy().view(np.uint32)


def jax_thresholds(beta):
    return jms.acceptance_thresholds(jnp.float32(beta))


def port_thresholds(jthr):
    return torch.from_numpy(np.asarray(jthr).astype(np.int64))


@pytest.mark.parametrize("n,m", SHAPES)
def test_nibble_packing_matches_reference(n, m):
    b, w = pm1_planes(n, m, seed=n)
    np.testing.assert_array_equal(
        lat.to_binary(torch.tensor(b)).numpy(),
        np.asarray(jlat.to_binary(jnp.asarray(b))))
    words = jlat.pack_nibbles(jlat.to_binary(jnp.asarray(b)))
    got = lat.pack_nibbles(lat.to_binary(torch.tensor(b)))
    np.testing.assert_array_equal(got.numpy(), np.asarray(words))
    np.testing.assert_array_equal(
        lat.unpack_nibbles(to_port(words)).numpy(),
        np.asarray(jlat.unpack_nibbles(words)))
    jb, jw = jms.pack_lattice(jnp.asarray(b), jnp.asarray(w))
    tb, tw = ms.pack_lattice(torch.tensor(b), torch.tensor(w))
    assert tb.dtype == torch.int32
    np.testing.assert_array_equal(as_u32(tb), np.asarray(jb))
    np.testing.assert_array_equal(as_u32(tw), np.asarray(jw))
    ub, uw = ms.unpack_lattice(tb, tw)
    np.testing.assert_array_equal(ub.numpy(), b)
    np.testing.assert_array_equal(uw.numpy(), w)


@pytest.mark.parametrize("n,m", SHAPES)
@pytest.mark.parametrize("is_black", [True, False])
def test_packed_neighbor_sums_match_reference(n, m, is_black):
    jb, _ = jax_words(n, m, seed=m)
    np.testing.assert_array_equal(
        lat.align_side_word(lat.words_to_u32(to_port(jb)), is_black).numpy(),
        np.asarray(jlat.align_side_word(jb, is_black)))
    np.testing.assert_array_equal(
        lat.packed_neighbor_sums(to_port(jb), is_black).numpy(),
        np.asarray(jlat.packed_neighbor_sums(jb, is_black)))


def test_funnel_shift_wraps_at_32_bits():
    """A top nibble shifted toward k-1 leaves the word; the next word's
    nibble 0 enters at the top toward k+1."""
    words = torch.tensor([[0xF0000001, 0x00000002]], dtype=torch.int64)
    minus = lat.align_side_word(words, is_black=True)    # row 0: k-1
    plus = lat.align_side_word(words, is_black=False)    # row 0: k+1
    assert minus.tolist() == [[0x00000010, 0x0000002F]]
    assert plus.tolist() == [[0x2F000000, 0x10000000]]


@pytest.mark.parametrize("temperature", [2.2, 1.5, 2.269, 3.0])
def test_thresholds_match_reference(temperature):
    got = ms.acceptance_thresholds(1 / temperature)
    assert got.dtype == torch.int64 and got.shape == (10,)
    np.testing.assert_array_equal(
        got.numpy(), np.asarray(jax_thresholds(1 / temperature)))
    # classes with p >= 1 map to 0xFFFFFFFF
    assert int(got[2]) == rng.MASK32 == int(got[7])


@pytest.mark.parametrize("offset", OFFSETS)
def test_word_randoms_match_reference(offset):
    widx = np.arange(40, dtype=np.uint32).reshape(5, 8)
    want = jms.word_randoms(BIG_SEED, jnp.asarray(widx), jnp.uint32(offset))
    got = ms.word_randoms(BIG_SEED, torch.from_numpy(widx.astype(np.int64)),
                          offset)
    assert len(got) == 8
    for a, b in zip(want, got):
        np.testing.assert_array_equal(np.asarray(a), b.numpy())


@pytest.mark.parametrize("n,m", SHAPES)
@pytest.mark.parametrize("is_black", [True, False])
@pytest.mark.parametrize("offset", OFFSETS)
def test_update_color_packed_matches_reference(n, m, is_black, offset):
    jb, jw = jax_words(n, m, seed=offset % 89)
    t, o = (jb, jw) if is_black else (jw, jb)
    want = jms.update_color_packed(t, o, jnp.float32(BETA), is_black,
                                   BIG_SEED, jnp.uint32(offset))
    got = ms.update_color_packed(to_port(t), to_port(o),
                                 ms.acceptance_thresholds(BETA), is_black,
                                 BIG_SEED, offset)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(as_u32(got), np.asarray(want))


def test_reference_thresholds_passed_in_reproduce_reference():
    """At a temperature where the two tables may differ, the port fed the
    JAX package's thresholds gives its trajectory."""
    beta = 1 / 2.63
    jb, jw = jax_words(16, 32, seed=3)
    got = ms.run_sweeps_packed(to_port(jb), to_port(jw),
                               port_thresholds(jax_thresholds(beta)), 3,
                               BIG_SEED, 5)
    # the JAX sweeps donate their inputs: they run after the port's
    want = jms.run_sweeps_packed(jb, jw, jnp.float32(beta), 3, seed=BIG_SEED,
                                 start_offset=5)
    for a, b in zip(want, got):
        np.testing.assert_array_equal(np.asarray(a), as_u32(b))


@pytest.mark.parametrize("k", [1, 3])
@pytest.mark.parametrize("start", [0, 2 ** 32 - 3])
def test_run_sweeps_packed_matches_reference(k, start):
    jb, jw = jax_words(16, 32, seed=k)
    got = ms.run_sweeps_packed(to_port(jb), to_port(jw),
                               ms.acceptance_thresholds(BETA), k, BIG_SEED,
                               start)
    want = jms.run_sweeps_packed(jb, jw, jnp.float32(BETA), k, seed=BIG_SEED,
                                 start_offset=jnp.uint32(start))
    for a, b in zip(want, got):
        np.testing.assert_array_equal(np.asarray(a), as_u32(b))


@pytest.mark.parametrize("is_black,offset", [(True, 3), (False, 2 ** 31),
                                             (True, 2 ** 32 - 1)])
def test_update_wrapper_matches_pallas_kernel(is_black, offset):
    """The Pallas half-sweep keys Philox on the seed's low 32 bits, so
    the comparison takes a seed below 2^32."""
    jb, jw = jax_words(16, 32, seed=4)
    t, o = (jb, jw) if is_black else (jw, jb)
    want = jax_update(t, o, jnp.float32(BETA), is_black=is_black,
                      seed=SMALL_SEED, offset=jnp.uint32(offset), block_rows=8,
                      interpret=True)
    target = to_port(t)
    before = multispin_update.launches
    got = multispin_update(target, to_port(o), ms.acceptance_thresholds(BETA),
                           is_black=is_black, seed=SMALL_SEED, offset=offset)
    assert got is target  # in place, as on the card
    assert multispin_update.launches == before  # the CPU launches nothing
    np.testing.assert_array_equal(as_u32(got), np.asarray(want))


@pytest.mark.parametrize("k", [1, 3])
def test_resident_wrapper_matches_pallas_kernel(k):
    jb, jw = jax_words(16, 32, seed=5)
    want = jax_resident(jb, jw, jnp.float32(BETA), n_sweeps=k, seed=BIG_SEED,
                        start_offset=4, interpret=True)
    plan = resident.plan_resident("multispin", 16, 32)
    tb, tw = to_port(jb), to_port(jw)
    before = multispin_sweeps_resident.launches
    got = multispin_sweeps_resident(tb, tw, ms.acceptance_thresholds(BETA),
                                    n_sweeps=k, seed=BIG_SEED, start_offset=4,
                                    plan=plan)
    assert multispin_sweeps_resident.launches == before
    np.testing.assert_array_equal(as_u32(tb), np.asarray(jb))  # untouched
    for a, b in zip(want, got):
        np.testing.assert_array_equal(np.asarray(a), as_u32(b))


def tiled_sweeps(black, white, thr, k, seed, start, tile_r, tile_c):
    """PyTorch emulation of ``multispin_sweeps_kernel`` (the k-sweep
    kernel of ``csrc/multispin.cu``): every tile of words plus a halo of
    2k word rows and, on each side, 2k word columns rounded up to 4, the
    extended row rounded up to 4 words (all wrapped modulo the plane; a
    tile at a ragged edge extends only its own rows and words), runs 2k
    half-sweeps on its own, the side word by global row parity, draws
    keyed on the global word index, the accept a lookup of the key nibble
    s * 8 + c in ``key_table``; half-sweep h (from 0) updates only the
    words at distance >= h + 1 from the extended tile's edge, and only
    the tile is written back."""
    n, w = black.shape
    halo = 2 * k
    left = -(-halo // 4) * 4
    table = torch.tensor(key_table(thr), dtype=torch.int64)
    b64, w64 = lat.words_to_u32(black), lat.words_to_u32(white)
    out_b, out_w = torch.empty_like(black), torch.empty_like(white)
    for r0 in range(0, n, tile_r):
        for c0 in range(0, w, tile_c):
            n_rows, n_cols = min(tile_r, n - r0), min(tile_c, w - c0)
            ew = -(-(n_cols + 2 * left) // 4) * 4
            rows = torch.arange(r0 - halo, r0 + n_rows + halo) % n
            cols = torch.arange(c0 - left, c0 - left + ew) % w
            ext = [b64[rows][:, cols].clone(), w64[rows][:, cols].clone()]
            widx = (rows[:, None] * w + cols[None, :]) & rng.MASK32
            er = len(rows)
            for s in range(k):
                for color in (0, 1):
                    margin = 2 * s + color + 1
                    region = torch.zeros((er, ew), dtype=torch.bool)
                    region[margin:er - margin, margin:ew - margin] = True
                    tgt, op = ext[color], ext[1 - color]
                    plus = ((rows % 2 == 1) == (color == 0))[:, None]
                    nxt, prv = torch.roll(op, -1, 1), torch.roll(op, 1, 1)
                    side = torch.where(
                        plus, (op >> 4) | ((nxt << 28) & rng.MASK32),
                        ((op << 4) & rng.MASK32) | (prv >> 28))
                    key = ((torch.roll(op, 1, 0) + torch.roll(op, -1, 0) + op
                            + side) | ((tgt & 0x11111111) << 3))
                    draws = ms.word_randoms(
                        seed, widx, rng.half_sweep_offset(start, s, color))
                    flip = torch.zeros_like(tgt)
                    for nib in range(8):
                        entry = table[(key >> (4 * nib)) & 0xF]
                        flip |= (draws[nib] < entry).to(torch.int64) << (
                            4 * nib)
                    ext[color] = torch.where(region, tgt ^ flip, tgt)
            rr = slice(halo, halo + n_rows)
            cc = slice(left, left + n_cols)
            out_b[r0:r0 + n_rows, c0:c0 + n_cols] = lat.u32_to_words(
                ext[0][rr, cc])
            out_w[r0:r0 + n_rows, c0:c0 + n_cols] = lat.u32_to_words(
                ext[1][rr, cc])
    return out_b, out_w


@pytest.mark.parametrize("n,m,tile_r,tile_c,k", [
    (16, 64, 8, 2, 1),      # tiles divide the plane
    (12, 80, 5, 3, 2),      # ragged tiles, odd tile rows
    (8, 32, 8, 1, 3),       # halo wider than the plane: multiple wraps
])
def test_tiled_k_sweeps_equal_whole_plane_sweeps(n, m, tile_r, tile_c, k):
    """The halo argument the CUDA k-sweep kernel rests on."""
    b, w = ms.pack_lattice(*(torch.tensor(p)
                             for p in pm1_planes(n, m, seed=n + k)))
    thr = ms.acceptance_thresholds(BETA)
    want = ms.run_sweeps_packed(b, w, thr, k, BIG_SEED, 2)
    got = tiled_sweeps(b, w, thr, k, BIG_SEED, 2, tile_r, tile_c)
    assert torch.equal(want[0], got[0]) and torch.equal(want[1], got[1])


@pytest.mark.parametrize("w,tile_r,tile_c,k,n_sweeps", [
    (1, 5, 1, 1, 2),        # one word a row: every side word wraps
    (3, 8, 3, 2, 3),
    (31, 8, 12, 2, 2),      # ragged last tile of 7 words
    (33, 5, 33, 1, 1),
    (9, 7, 4, 3, 3),        # halo wider than the plane
])
def test_tiled_k_sweeps_at_ragged_word_widths(w, tile_r, tile_c, k,
                                              n_sweeps):
    """The kernel's geometry at word widths that are not multiples of 4
    or of a warp, from offsets near 2^32 with a seed of both key lanes:
    ceil(n_sweeps / k) launches of the tile emulation equal whole-plane
    sweeps."""
    n = 12
    b, wp = ms.pack_lattice(*(torch.tensor(p) for p in pm1_planes(
        n, 16 * w, seed=w + k)))
    thr = ms.acceptance_thresholds(BETA)
    start = 2 ** 32 - 3
    want = ms.run_sweeps_packed(b, wp, thr, n_sweeps, BIG_SEED, start)
    got = (b, wp)
    for first in range(0, n_sweeps, k):
        got = tiled_sweeps(*got, thr, min(k, n_sweeps - first), BIG_SEED,
                           rng.half_sweep_offset(start, first, 0), tile_r,
                           tile_c)
    assert torch.equal(want[0], got[0]) and torch.equal(want[1], got[1])


@pytest.mark.parametrize("temperature", [0.05, 1.0, 2.2, 3.5])
def test_key_table_decides_as_thresholds_and_jax_select_chain(temperature):
    """The 16-entry table of the k-sweep and shard kernels, indexed by
    the key nibble s * 8 + c, flips every (s, c, draw) as the 10
    thresholds do at s * 5 + c and as the JAX resident kernel's select
    chain does (``repro/kernels/multispin/resident.py``): draws at 0, 1,
    each threshold and its neighbours, 2^32 - 2, 2^32 - 1 and random."""
    beta = 1 / temperature
    thr = ms.acceptance_thresholds(beta)
    jthr = jax_thresholds(beta)
    np.testing.assert_array_equal(thr.numpy(), np.asarray(jthr))
    assert int(thr.max()) == rng.MASK32     # classes with p >= 1
    table = key_table(thr)
    assert len(table) == 16 and table[5:8] == [0] * 3 == table[13:16]
    r = np.random.default_rng(int(temperature * 100))
    for s in (0, 1):
        for c in range(5):
            t = int(thr[s * 5 + c])
            draws = np.unique(np.clip(np.concatenate([
                [0, 1, t - 1, t, t + 1, rng.MASK32 - 1, rng.MASK32],
                r.integers(0, 2 ** 32, 64)]), 0, rng.MASK32)).astype(
                    np.uint32)
            want = draws < np.uint32(t)
            key_flip = draws < np.uint32(table[s * 8 + c])
            idx = jnp.full(draws.shape, s * 5 + c, jnp.uint32)
            chain = jnp.zeros_like(idx)
            for e in range(10):
                chain = jnp.where(idx == np.uint32(e), jthr[e], chain)
            jax_flip = np.asarray(jnp.asarray(draws) < chain)
            np.testing.assert_array_equal(key_flip, want)
            np.testing.assert_array_equal(jax_flip, want)
    with pytest.raises(ValueError, match="10 entries"):
        key_table(thr[:9])


def test_planner_multispin_geometry_and_boundary():
    g = resident.GEOMETRY["multispin"]
    plan = resident.plan_resident("multispin", 32768, 32768)
    assert (plan.tile_rows, plan.tile_cols, plan.k) == (g.tile_rows,
                                                        g.tile_cols, g.max_k)
    assert plan.smem_bytes == resident.smem_bytes(
        g.tile_rows, g.tile_cols, g.max_k, "multispin")
    assert plan.smem_bytes <= resident.SMEM_BUDGET_BYTES
    # stencil's tile in uint32 words does not fit one block
    assert resident.smem_bytes(resident.TILE_ROWS, resident.TILE_COLS, 1,
                               "multispin") > resident.SMEM_BUDGET_BYTES
    small = resident.plan_resident("multispin", 16, 48)
    assert (small.tile_rows, small.tile_cols) == (16, 3)
    # the 256 threshold pairs, then rows of 3 + 2 x 4 words rounded up
    # to 12
    need1 = resident.smem_bytes(16, 3, 1, "multispin")
    assert need1 == 2048 + 8 * 20 * 12
    assert resident.plan_resident("multispin", 16, 48, need1).k == 1
    assert resident.plan_resident("multispin", 16, 48, need1 - 1) is None


def test_engine_validates_width_and_reports_state():
    with pytest.raises(ValueError, match="multiple of 8"):
        RunSpec(lattice=LatticeSpec(16, 24), engine=EngineSpec("multispin"))
    spec = RunSpec(lattice=LatticeSpec(16, 32, init_p_up=0.4),
                   engine=EngineSpec("multispin_pallas"), seed=BIG_SEED)
    s = Session.open(spec, device="cpu")
    b, w = s.state
    assert b.dtype == torch.int32 and tuple(b.shape) == (16, 2)
    arrays = s.engine.state_arrays(s.state)
    assert sorted(arrays) == ["black_words", "white_words"]
    assert arrays["black_words"].dtype == np.uint32
    with pytest.raises(ValueError, match="lattice needs"):
        s.engine.from_arrays({k: v[:, :1] for k, v in arrays.items()})


def test_fresh_state_observables_are_the_unpacked_planes():
    spec = RunSpec(lattice=LatticeSpec(16, 32, init_p_up=0.3),
                   engine=EngineSpec("multispin"), seed=BIG_SEED)
    word = Session.open(spec, device="cpu")
    plain = Session.open(RunSpec(lattice=spec.lattice,
                                 engine=EngineSpec("stencil_pallas"),
                                 seed=BIG_SEED), device="cpu")
    assert word.magnetization() == plain.magnetization()
    assert word.energy() == plain.energy()


def test_wrappers_validate_planes():
    b, w = ms.pack_lattice(*(torch.tensor(p) for p in pm1_planes(8, 32)))
    thr = ms.acceptance_thresholds(BETA)
    with pytest.raises(ValueError, match="int32"):
        multispin_update(b.to(torch.int64), w, thr, is_black=True, seed=1,
                         offset=0)
    with pytest.raises(ValueError, match="differ"):
        multispin_update(b, w[:4], thr, is_black=True, seed=1, offset=0)
    with pytest.raises(ValueError, match="10 entries"):
        thresholds_arg(thr[:9])
    plan = resident.plan_resident("multispin", 16, 32)
    with pytest.raises(ValueError, match="plan is for"):
        multispin_sweeps_resident(b, w, thr, n_sweeps=1, seed=1,
                                  start_offset=0, plan=plan)
    plan8 = dataclasses.replace(plan, n=8)
    with pytest.raises(ValueError, match="n_sweeps"):
        multispin_sweeps_resident(b, w, thr, n_sweeps=0, seed=1,
                                  start_offset=0, plan=plan8)


def test_thresholds_differ_only_where_the_tables_decide_flips_apart():
    """The uint32 thresholds inherit the acceptance table's reference
    behaviour (``ROADMAP.md`` Queue 3): over 400 temperatures in
    [0.5, 5] they differ from the JAX package's only where a
    flip-deciding entry of the float32 tables differs (``jnp.exp`` is
    not correctly rounded); where p < 2^-9 one ulp of p can truncate to
    the same threshold, so the converse does not hold."""
    def decisions(table):
        return np.where(table > 1, np.inf, table)

    tables_apart, thresholds_apart = set(), set()
    for temperature in np.linspace(0.5, 5.0, 400):
        beta = 1.0 / temperature
        args = jnp.asarray(metropolis.acceptance_arguments(beta))
        if (decisions(metropolis.acceptance_table(beta).numpy())
                != decisions(np.asarray(jnp.exp(args)))).any():
            tables_apart.add(temperature)
        if (ms.acceptance_thresholds(beta).numpy()
                != np.asarray(jax_thresholds(beta))).any():
            thresholds_apart.add(temperature)
    assert thresholds_apart <= tables_apart
