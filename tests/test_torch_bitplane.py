"""The bitplane kernel pair's modules on the CPU: replica packing, the
carry-save neighbour count, the shared site draws, the 10-class accept,
the half-sweep and the per-replica observables
(``repro_torch.core.bitplane``) bit for bit against the JAX package; the
CPU wrappers against its Pallas kernels (interpret mode); the tiled
k-sweep algorithm of the CUDA kernel, emulated in PyTorch; the bitplane
planner; and the engines."""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import bitplane as jbp
from repro.core import multispin as jms
from repro.kernels.bitplane.bitplane import bitplane_update as jax_update
from repro.kernels.bitplane.resident import \
    bitplane_sweeps_resident as jax_resident
from repro_torch.api import EngineSpec, LatticeSpec, RunSpec, Session
from repro_torch.core import bitplane as bp
from repro_torch.core import multispin as ms
from repro_torch.core import rng
from repro_torch.kernels import _words, resident
from repro_torch.kernels.bitplane import (bitplane_sweeps_resident,
                                          bitplane_update)
from repro_torch.kernels.bitplane import counts as bp_counts

BETA = 1 / 2.2
SEED = 2 ** 36 + 5
OFFSETS = (0, 2 ** 31 - 1, 2 ** 31, 2 ** 32 - 1)
SHAPES = ((16, 32), (8, 64))


def replica_stack(n, m, seed=0):
    r = np.random.default_rng(seed)
    return np.where(r.random((bp.N_REPLICAS, n, m)) < 0.5, 1,
                    -1).astype(np.int8)


def jax_words(n, m, seed=0):
    return jbp.pack_lattices(jnp.asarray(replica_stack(n, m, seed)))


def to_port(words):
    return torch.from_numpy(np.asarray(words).view(np.int32).copy())


def as_u32(words: torch.Tensor) -> np.ndarray:
    return words.numpy().view(np.uint32)


@pytest.mark.parametrize("n,m", SHAPES)
def test_replica_packing_matches_reference(n, m):
    fulls = replica_stack(n, m, seed=n)
    jb, jw = jbp.pack_lattices(jnp.asarray(fulls))
    tb, tw = bp.pack_lattices(torch.tensor(fulls))
    assert tb.dtype == torch.int32 and tuple(tb.shape) == (n, m // 2)
    np.testing.assert_array_equal(as_u32(tb), np.asarray(jb))
    np.testing.assert_array_equal(as_u32(tw), np.asarray(jw))
    np.testing.assert_array_equal(bp.unpack_replicas(tb).numpy(),
                                  np.asarray(jbp.unpack_replicas(jb)))
    np.testing.assert_array_equal(bp.unpack_lattices(tb, tw).numpy(), fulls)
    for r in (0, 17, 31):
        np.testing.assert_array_equal(
            bp.replica_lattice(tb, tw, r).numpy(),
            np.asarray(jbp.replica_lattice(jb, jw, r)))


def test_bit_count_neighbors_over_all_16_inputs():
    """Bit b of the four input words spells the combination b of
    (up, down, center, side); bits 16-31 repeat it."""
    combos = np.arange(32) % 16
    words = [np.uint32(sum(int((c >> i) & 1) << b
                           for b, c in enumerate(combos))) for i in range(4)]
    want = jbp.bit_count_neighbors(*(jnp.asarray([w]) for w in words))
    got = bp.bit_count_neighbors(*(to_port(np.array([w], np.uint32))
                                   for w in words))
    for a, g in zip(want, got):
        np.testing.assert_array_equal(as_u32(g), np.asarray(a))
    n0, n1, n2 = (int(as_u32(g)[0]) for g in got)
    for b, c in enumerate(combos):
        count = ((n0 >> b) & 1) + 2 * ((n1 >> b) & 1) + 4 * ((n2 >> b) & 1)
        assert count == bin(int(c)).count("1")


@pytest.mark.parametrize("n,m", SHAPES)
@pytest.mark.parametrize("is_black", [True, False])
def test_neighbor_counts_match_reference(n, m, is_black):
    jb, _ = jax_words(n, m, seed=m)
    for a, g in zip(jbp.neighbor_counts(jb, is_black),
                    bp.neighbor_counts(to_port(jb), is_black)):
        np.testing.assert_array_equal(as_u32(g), np.asarray(a))


@pytest.mark.parametrize("offset", OFFSETS)
def test_site_randoms_match_reference(offset):
    want = jbp.site_randoms(SEED, 6, 8, jnp.uint32(offset))
    got = bp.site_randoms(SEED, 6, 8, offset, "cpu")
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    # rows from the middle of the plane: the same draws
    np.testing.assert_array_equal(
        bp.site_randoms(SEED, 2, 8, offset, "cpu", first_row=3).numpy(),
        np.asarray(want)[3:5])


def test_flip_word_from_classes_matches_reference():
    jb, jw = jax_words(16, 32, seed=9)
    counts = jbp.neighbor_counts(jw, True)
    draws = jbp.site_randoms(SEED, 16, 16, jnp.uint32(4))
    thr = jms.acceptance_thresholds(jnp.float32(BETA))
    want = jbp.flip_word_from_classes(jb, counts, draws, thr)
    got = bp.flip_word_from_classes(
        to_port(jb), tuple(to_port(c) for c in counts),
        torch.from_numpy(np.asarray(draws).astype(np.int64)),
        ms.acceptance_thresholds(BETA))
    np.testing.assert_array_equal(as_u32(got), np.asarray(want))


@pytest.mark.parametrize("n,m", SHAPES)
@pytest.mark.parametrize("is_black", [True, False])
@pytest.mark.parametrize("offset", OFFSETS)
def test_update_color_bitplane_matches_reference(n, m, is_black, offset):
    jb, jw = jax_words(n, m, seed=offset % 83)
    t, o = (jb, jw) if is_black else (jw, jb)
    want = jbp.update_color_bitplane(t, o, jnp.float32(BETA), is_black, SEED,
                                     jnp.uint32(offset))
    got = bp.update_color_bitplane(to_port(t), to_port(o),
                                   ms.acceptance_thresholds(BETA), is_black,
                                   SEED, offset)
    np.testing.assert_array_equal(as_u32(got), np.asarray(want))


@pytest.mark.parametrize("beta,thresholds", [
    (BETA, "port"), (1 / 2.63, "reference")])
def test_run_sweeps_bitplane_matches_reference(beta, thresholds):
    """At T = 2.2 with the port's thresholds; at a temperature where the
    two tables may differ, with the JAX package's passed in."""
    jb, jw = jax_words(16, 32, seed=2)
    thr = (ms.acceptance_thresholds(beta) if thresholds == "port" else
           torch.from_numpy(np.asarray(jms.acceptance_thresholds(
               jnp.float32(beta))).astype(np.int64)))
    got = bp.run_sweeps_bitplane(to_port(jb), to_port(jw), thr, 3, SEED,
                                 2 ** 32 - 3)
    # the JAX sweeps donate their inputs: they run after the port's
    want = jbp.run_sweeps_bitplane(jb, jw, jnp.float32(beta), 3, seed=SEED,
                                   start_offset=jnp.uint32(2 ** 32 - 3))
    for a, g in zip(want, got):
        np.testing.assert_array_equal(as_u32(g), np.asarray(a))


@pytest.mark.parametrize("is_black,offset", [(True, 3), (False, 2 ** 31),
                                             (True, 2 ** 32 - 1)])
def test_update_wrapper_matches_pallas_kernel(is_black, offset):
    jb, jw = jax_words(16, 32, seed=4)
    t, o = (jb, jw) if is_black else (jw, jb)
    want = jax_update(t, o, jnp.float32(BETA), is_black=is_black, seed=SEED,
                      offset=jnp.uint32(offset), block_rows=8,
                      interpret=True)
    target = to_port(t)
    before = bitplane_update.launches
    got = bitplane_update(target, to_port(o), ms.acceptance_thresholds(BETA),
                          is_black=is_black, seed=SEED, offset=offset)
    assert got is target  # in place, as on the card
    assert bitplane_update.launches == before  # the CPU launches nothing
    np.testing.assert_array_equal(as_u32(got), np.asarray(want))


@pytest.mark.parametrize("k", [1, 3])
def test_resident_wrapper_matches_pallas_kernel(k):
    jb, jw = jax_words(16, 32, seed=5)
    want = jax_resident(jb, jw, jnp.float32(BETA), n_sweeps=k, seed=SEED,
                        start_offset=6, interpret=True)
    plan = resident.plan_resident("bitplane", 16, 32)
    tb, tw = to_port(jb), to_port(jw)
    before = bitplane_sweeps_resident.launches
    got = bitplane_sweeps_resident(tb, tw, ms.acceptance_thresholds(BETA),
                                   n_sweeps=k, seed=SEED, start_offset=6,
                                   plan=plan)
    assert bitplane_sweeps_resident.launches == before
    np.testing.assert_array_equal(as_u32(tb), np.asarray(jb))  # untouched
    for a, g in zip(want, got):
        np.testing.assert_array_equal(as_u32(g), np.asarray(a))


@pytest.mark.parametrize("n,m", SHAPES)
def test_replica_observables_match_reference(n, m):
    jb, jw = jax_words(n, m, seed=n + m)
    want = jbp.replica_observables(jb, jw)
    got = bp.replica_observables(to_port(jb), to_port(jw))
    for k in ("m", "e"):
        assert got[k].dtype == torch.float32 and got[k].shape == (32,)
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]))


@pytest.mark.parametrize("members", [None, 3])
@pytest.mark.parametrize("n,m", SHAPES + ((2, 8), (6, 24)))
def test_counts_wrapper_observables_match_reference(n, m, members):
    """The counts wrapper's CPU path (the plain counts), formed into m
    and e as the engine forms them, gives the JAX package's per-replica
    m and e bit for bit, for one plane pair and for ``(B, n, w)`` planes
    (member i: seed i)."""
    seeds = [n * m] if members is None else range(n * m, n * m + members)
    pairs = [jax_words(n, m, seed=s) for s in seeds]
    black = torch.stack([to_port(jb) for jb, _ in pairs])
    white = torch.stack([to_port(jw) for _, jw in pairs])
    if members is None:
        black, white = black[0], white[0]
    before = bp_counts.bitplane_counts.launches
    counts = bp_counts.bitplane_counts(black, white)
    assert bp_counts.bitplane_counts.launches == before
    got = bp.observables_of(counts, bp.replica_sites(black))
    assert counts.dtype == torch.int64
    assert counts.shape == black.shape[:-2] + (2, bp.N_REPLICAS)
    for k in ("m", "e"):
        want = np.stack([np.asarray(jbp.replica_observables(jb, jw)[k])
                         for jb, jw in pairs])
        assert got[k].dtype == torch.float32
        np.testing.assert_array_equal(got[k].numpy(),
                                      want if members else want[0])


def _csa(a, b, c):
    """Carry-save add of three uint32 word arrays: ``(high, low)``."""
    u = a ^ b
    return (a & b) | (u & c), u ^ c


def _tree(v, x):
    """Harley-Seal: ``len(x)`` (8 or 16) words of weight 1 into levels
    ``v[0]``, ``v[1]``, ... in place; returns the carry word of weight
    ``len(x)``."""
    if len(x) == 2:
        high, v[0] = _csa(v[0], x[0], x[1])
        return high
    k = len(x).bit_length() - 2          # the level this tree adds into
    a, b = _tree(v, x[:len(x) // 2]), _tree(v, x[len(x) // 2:])
    high, v[k] = _csa(v[k], a, b)
    return high


def _warp_count(levels):
    """The butterfly of ``csrc/counts.cu``'s ``warp_count``: the 32
    lanes' counters added bit-sliced, lane r reading bit r of each
    level; the levels zeroed."""
    s = [v.copy() for v in levels] + [None] * 5
    for step in range(5):
        other, carry = np.arange(32) ^ (16 >> step), np.zeros(32, np.uint32)
        for j in range(len(levels) + step):
            a = s[j]
            u = a ^ a[other]
            s[j], carry = u ^ carry, (a & a[other]) | (u & carry)
        s[len(levels) + step] = carry
    for v in levels:
        v[:] = 0
    lane = np.arange(32, dtype=np.uint32)
    return sum(((s[j] >> lane) & 1).astype(np.int64) << j
               for j in range(len(s)))


def emulated_counts(black, white, rows, ripple_levels=8):
    """numpy emulation of ``bitplane_counts_kernel`` on one ``(n, w)``
    uint32 plane pair, its 32 lanes a vector axis: a warp a run of
    ``rows`` rows of a 128-word strip, the row above kept, the side tap
    by shuffle and an edge lane's load, Harley-Seal trees into ripple
    counters flushed by the butterfly before they overflow.  Returns the
    ``(2, 32)`` counts."""
    n, w = black.shape
    groups, lane = w // 4, np.arange(32)
    total = np.zeros((2, 32), np.int64)
    for unit in range(-(-groups // 32) * -(-n // rows)):
        strips = -(-groups // 32)
        g = (unit % strips) * 32 + lane
        valid = g < groups
        col = np.where(valid, 4 * g, 0)
        edge = {True: valid & ((lane == 31) | (g == groups - 1)),
                False: valid & (lane == 0)}
        edge_col = {True: (col + 4) % w, False: (col - 1) % w}

        def load(i):
            odd = bool(i % 2)
            cols = col[None] + np.arange(4)[:, None]
            return (np.where(valid, black[i][cols], 0).astype(np.uint32),
                    np.where(valid, white[i][cols], 0).astype(np.uint32),
                    np.where(edge[odd], white[i][edge_col[odd]],
                             0).astype(np.uint32))

        up = [np.zeros(32, np.uint32) for _ in range(3 + ripple_levels)]
        bond = [np.zeros(32, np.uint32) for _ in range(4 + ripple_levels)]
        r0 = (unit // strips) * rows
        above, counted = load((r0 - 1) % n), 0
        for i in range(r0, min(n, r0 + rows)):
            # the kernel takes rows in pairs, flushing before a pair that
            # could overflow a ripple counter
            if i % 2 == 0 and counted + 2 > (1 << ripple_levels) - 1:
                total += [_warp_count(up), _warp_count(bond)]
                counted = 0
            counted += 1
            (b, wh, e), (ab, aw, _) = load(i), above
            odd = bool(i % 2)
            shuffled = (np.append(wh[0][1:], wh[0][31]) if odd
                        else np.insert(wh[3][:-1], 0, wh[3][0]))
            tap = np.where(edge[odd], e, np.where(valid, shuffled, 0))
            side = ([wh[1], wh[2], wh[3], tap] if odd
                    else [tap, wh[0], wh[1], wh[2]])
            words = ([b[j] ^ aw[j] for j in range(4)]
                     + [ab[j] ^ wh[j] for j in range(4)]
                     + [b[j] ^ wh[j] for j in range(4)]
                     + [b[j] ^ side[j] for j in range(4)])
            for levels, tree, x in ((bond, 4, words),
                                    (up, 3, list(b) + list(wh))):
                carry = _tree(levels, x)
                for j in range(tree, len(levels)):
                    levels[j], carry = levels[j] ^ carry, levels[j] & carry
                assert not carry.any()
            above = (b, wh, e)
        total += [_warp_count(up), _warp_count(bond)]
    return total


@pytest.mark.parametrize("n,w,rows,pattern", [
    (2, 4, 16, "random"), (17, 200, 16, "random"), (30, 132, 4, "random"),
    (30, 132, 16, "edges-black"), (30, 132, 16, "edges-white"),
    (64, 4, 16, "edges-white"), (40, 8, 40, "random")])
def test_counting_kernel_algorithm_equals_plain(n, w, rows, pattern):
    """The algorithm of ``csrc/counts.cu``, emulated, gives the plain
    counts: strips that end inside a warp, an odd row count, runs of 4
    and 16 rows, and ripple counters of 3 levels flushed 6 times a run
    of 40 rows."""
    r = np.random.default_rng(n * w + rows)
    if pattern == "random":
        black, white = (r.integers(0, 2 ** 32, (n, w), dtype=np.uint64)
                        .astype(np.uint32) for _ in range(2))
    else:
        black, white = np.zeros((n, w), np.uint32), np.zeros((n, w),
                                                             np.uint32)
        edged = black if pattern == "edges-black" else white
        edged[0] = edged[-1] = edged[:, 0] = edged[:, -1] = 0xFFFFFFFF
    levels = 3 if rows == 40 else 8
    got = emulated_counts(black, white, rows, ripple_levels=levels)
    want = bp_counts.bitplane_counts_plain(
        *(torch.from_numpy(p.view(np.int32).copy()) for p in (black, white)))
    np.testing.assert_array_equal(got, want.numpy())


def _count_planes(case):
    """Planes (of (8, 16) words unless the case changes them) that the
    counts wrapper refuses, and what its error says."""
    b = torch.zeros((8, 16), dtype=torch.int32)
    if case == "dtype":
        return b.to(torch.int64), b.to(torch.int64), "int32"
    if case == "shapes":
        return b, b[:4].clone(), "one shape"
    if case == "batch-shapes":
        return b[None].repeat(3, 1, 1), b[None].repeat(2, 1, 1), "one shape"
    if case == "dims":
        return b[None, None], b[None, None], "one shape"
    if case == "empty":
        return b[:0], b[:0], "non-empty"
    if case == "contiguous":
        wide = torch.zeros((8, 32), dtype=torch.int32)
        return wide[:, ::2], b, "contiguous"
    if case == "batch-contiguous":
        wide = torch.zeros((3, 8, 32), dtype=torch.int32)
        return wide[..., :16], b[None].repeat(3, 1, 1), "contiguous"
    if case == "width":
        return b[:, :6].clone(), b[:, :6].clone(), "multiple-of-4 width"
    raise AssertionError(case)


@pytest.mark.parametrize("case", ["dtype", "shapes", "batch-shapes", "dims",
                                  "empty", "contiguous", "batch-contiguous",
                                  "width"])
def test_counts_wrapper_refuses_planes(case):
    black, white, says = _count_planes(case)
    with pytest.raises(ValueError, match=says):
        bp_counts.bitplane_counts(black, white)


def tiled_sweeps(black, white, thr, k, seed, start, tile_r, tile_c):
    """PyTorch emulation of ``bitplane_sweeps_kernel<false, ...>``: every
    tile plus a halo of 2k rows and of 2k columns rounded up to a whole
    4-site group (wrapped modulo the plane), cut to the plane at a ragged
    edge, runs 2k half-sweeps on its own, the side tap by global row
    parity and, at the extended tile's edge, the next or previous word of
    its row-major layout (as stale as a wrapped one), one draw per global
    group and lane; half-sweep h (from 0) updates the rows at distance
    >= h + 1 from the extended tile's edge and the 4-site groups that
    hold a column at that distance; only the tile is written back."""
    n, h = black.shape
    halo_r, halo_c = 2 * k, resident.col_halo(k, "bitplane")
    k0, k1 = rng.seed_keys(seed)
    out_b, out_w = torch.empty_like(black), torch.empty_like(white)
    for r0 in range(0, n, tile_r):
        for c0 in range(0, h, tile_c):
            n_rows, n_cols = min(tile_r, n - r0), min(tile_c, h - c0)
            ec = -(-n_cols // 4) * 4 + 2 * halo_c
            rows = torch.arange(r0 - halo_r, r0 + n_rows + halo_r) % n
            cols = torch.arange(c0 - halo_c, c0 - halo_c + ec) % h
            ext = [black[rows][:, cols].clone(), white[rows][:, cols].clone()]
            group = (rows[:, None] * (h // 4) + cols[None, :] // 4)
            lane = (cols % 4)[None, :].expand_as(group)
            er = len(rows)
            for s in range(k):
                for color in (0, 1):
                    margin = 2 * s + color + 1
                    region = torch.zeros((er, ec), dtype=torch.bool)
                    region[margin:er - margin,
                           margin // 4 * 4:-(-(ec - margin) // 4) * 4] = True
                    tgt, op = ext[color], ext[1 - color]
                    plus = ((rows % 2 == 1) == (color == 0))[:, None]
                    flat = op.reshape(-1)
                    side = torch.where(plus,
                                       torch.roll(flat, -1).view(er, ec),
                                       torch.roll(flat, 1).view(er, ec))
                    counts = bp.bit_count_neighbors(
                        torch.roll(op, 1, 0), torch.roll(op, -1, 0), op, side)
                    lanes = torch.stack(rng.philox4x32(
                        rng.half_sweep_offset(start, s, color), 0, group, 0,
                        k0, k1), dim=-1)
                    draws = lanes.gather(-1, lane[..., None])[..., 0]
                    ext[color] = torch.where(
                        region,
                        tgt ^ bp.flip_word_from_classes(tgt, counts, draws,
                                                        thr), tgt)
            rr = slice(halo_r, halo_r + n_rows)
            cc = slice(halo_c, halo_c + n_cols)
            out_b[r0:r0 + n_rows, c0:c0 + n_cols] = ext[0][rr, cc]
            out_w[r0:r0 + n_rows, c0:c0 + n_cols] = ext[1][rr, cc]
    return out_b, out_w


@pytest.mark.parametrize("n,m,tile_r,tile_c,k", [
    (16, 64, 8, 16, 1),     # tiles divide the plane
    (12, 40, 5, 8, 2),      # ragged tiles, odd tile rows, 4-aligned groups
    (8, 16, 8, 4, 3),       # halo wider than the plane: multiple wraps
    (18, 48, 7, 12, 2),     # ragged both ways: the region cut to the plane
    (10, 8, 3, 4, 3),       # one group wide, halo wider than the plane
    (20, 240, 8, 56, 1),    # rows of 16 groups with the halo
])
def test_tiled_k_sweeps_equal_whole_plane_sweeps(n, m, tile_r, tile_c, k):
    """The halo argument the CUDA k-sweep kernel rests on."""
    b, w = bp.pack_lattices(torch.tensor(replica_stack(n, m, seed=n + k)))
    thr = ms.acceptance_thresholds(BETA)
    want = bp.run_sweeps_bitplane(b, w, thr, k, SEED, 2)
    got = tiled_sweeps(b, w, thr, k, SEED, 2, tile_r, tile_c)
    assert torch.equal(want[0], got[0]) and torch.equal(want[1], got[1])


def test_planner_bitplane_geometry_and_boundary():
    g = resident.GEOMETRY["bitplane"]
    assert g.tile_cols % 4 == 0
    assert [resident.col_halo(k, "bitplane") for k in (1, 2, 3)] == [4, 4, 8]
    assert [resident.col_halo(k) for k in (1, 2, 3)] == [2, 4, 6]
    plan = resident.plan_resident("bitplane", 16384, 16384)
    assert (plan.tile_rows, plan.tile_cols, plan.k) == (g.tile_rows,
                                                        g.tile_cols, g.max_k)
    assert plan.smem_bytes <= resident.SMEM_BUDGET_BYTES
    small = resident.plan_resident("bitplane", 16, 24)
    assert (small.tile_rows, small.tile_cols) == (16, 12)
    need1 = resident.smem_bytes(16, 12, 1, "bitplane")
    # two (20 x 20) uint32 planes, no index tables
    assert need1 == 8 * 20 * 20
    assert resident.plan_resident("bitplane", 16, 24, need1).k == 1
    assert resident.plan_resident("bitplane", 16, 24, need1 - 1) is None


def test_engine_validates_width_and_reports_state():
    with pytest.raises(ValueError, match="multiple of 4"):
        RunSpec(lattice=LatticeSpec(16, 12), engine=EngineSpec("bitplane"))
    spec = RunSpec(lattice=LatticeSpec(16, 24),
                   engine=EngineSpec("bitplane_pallas"), seed=SEED)
    s = Session.open(spec, device="cpu")
    b, w = s.state
    assert b.dtype == torch.int32 and tuple(b.shape) == (16, 12)
    arrays = s.engine.state_arrays(s.state)
    assert sorted(arrays) == ["black_bits", "white_bits"]
    assert arrays["white_bits"].dtype == np.uint32
    obs = s.engine.observables(s.state, s.engine.cfg.inv_temp)
    assert obs["m"].shape == (32,) and obs["e"].shape == (32,)
    assert s.magnetization() == float(obs["m"].double().mean().float())
    assert s.energy() == float(obs["e"].double().mean().float())


@pytest.mark.parametrize("engine", ["bitplane", "bitplane_pallas"])
def test_hot_start_gives_32_distinct_replicas(engine):
    word = Session.open(RunSpec(lattice=LatticeSpec(16, 32, init_p_up=0.5),
                                engine=EngineSpec(engine), seed=SEED),
                        device="cpu")
    fulls = bp.unpack_lattices(*word.state).reshape(32, -1)
    assert len({tuple(f.tolist()) for f in fulls}) == 32


def test_ordered_start_replicas_stay_equal():
    """Shared draws: replicas that start equal never separate."""
    spec = RunSpec(lattice=LatticeSpec(8, 16, init_p_up=1.0),
                   engine=EngineSpec("bitplane"), temperature=3.0, seed=SEED)
    s = Session.open(spec, device="cpu")
    s.run(3)
    b, w = s.state
    assert set(as_u32(b).ravel()) <= {0, 0xFFFFFFFF}
    assert set(as_u32(w).ravel()) <= {0, 0xFFFFFFFF}


def test_wrappers_validate_planes():
    b, w = bp.pack_lattices(torch.tensor(replica_stack(8, 16)))
    thr = ms.acceptance_thresholds(BETA)
    with pytest.raises(ValueError, match="multiple-of-4 width"):
        bitplane_update(b[:, :6].contiguous(), w[:, :6].contiguous(), thr,
                        is_black=True, seed=1, offset=0)
    plan = resident.plan_resident("bitplane", 8, 16)
    with pytest.raises(ValueError, match="multiple-of-4 width"):
        bitplane_sweeps_resident(b, w, thr, n_sweeps=1, seed=1,
                                 start_offset=0,
                                 plan=dataclasses.replace(plan, tile_cols=3))
    with pytest.raises(ValueError, match="plan is for"):
        bitplane_sweeps_resident(b, w, thr, n_sweeps=1, seed=1,
                                 start_offset=0,
                                 plan=dataclasses.replace(plan, n=16))



#: the parity temperatures of the Session tests, the main path's 3.0 and
#: 0.05, where t4 and t8 underflow to 0
LAYOUT_TEMPERATURES = (1.5, 1.8, 2.0, 2.1, 2.2, 2.269, 2.3, 2.5, 3.0, 0.05)


def reference_thresholds(temperature):
    return torch.from_numpy(np.asarray(jms.acceptance_thresholds(
        jnp.float32(1 / temperature))).astype(np.int64))


@pytest.mark.parametrize("source", ["port", "reference"])
@pytest.mark.parametrize("temperature", LAYOUT_TEMPERATURES)
def test_thresholds_have_the_three_value_layout(temperature, source):
    """The port's and the JAX package's thresholds take three values in
    the layout of the bitplane kernels' three-threshold accept, and the
    host passes it t4 and t8."""
    thr = (ms.acceptance_thresholds(1 / temperature) if source == "port"
           else reference_thresholds(temperature))
    values = [int(v) for v in thr.tolist()]
    assert {values[i] for i in _words.ALWAYS} == {rng.MASK32}
    t4, t8 = values[8], values[9]
    assert (values[1], values[0]) == (t4, t8)
    assert t8 <= t4 < rng.MASK32
    assert (t4 == t8 == 0) == (temperature == 0.05)
    assert _words.three_thresholds(thr) == (t4, t8)
    array, count = _words.accept_arg(thr)
    assert count == 2 and list(array) == [t4, t8]


def random_words(r, *shape):
    return torch.from_numpy(r.integers(0, 2 ** 32, shape, dtype=np.uint64)
                            .astype(np.uint32).view(np.int32))


@pytest.mark.parametrize("seed", range(4))
@pytest.mark.parametrize("temperature", [1.5, 2.269, 3.0, 0.05])
def test_flip_word_three_equals_the_class_accept(temperature, seed):
    """The three-threshold flip word against the 10-class one on random
    target words, counts of random neighbour words and draws that take
    0, t8, t4, 0xFFFFFFFF and their neighbours exactly."""
    r = np.random.default_rng(seed)
    thr = ms.acceptance_thresholds(1 / temperature)
    t4, t8 = _words.three_thresholds(thr)
    target = random_words(r, 64, 24)
    counts = bp.bit_count_neighbors(*(random_words(r, 64, 24)
                                      for _ in range(4)))
    special = [0, 1, t8 - 1, t8, t8 + 1, t4 - 1, t4, t4 + 1,
               rng.MASK32 - 1, rng.MASK32]
    draws = torch.from_numpy(r.integers(0, 2 ** 32, (64, 24),
                                        dtype=np.uint64).astype(np.int64))
    draws[: len(special)] = torch.tensor(
        [min(max(v, 0), rng.MASK32) for v in special])[:, None]
    want = bp.flip_word_from_classes(target, counts, draws, thr)
    got = bp.flip_word_three(target, counts, draws, t4, t8)
    assert torch.equal(got, want)


#: tables of another layout: a shuffle, t4's or t8's pair split, a
#: class that never flips where it should always flip
OTHER_LAYOUTS = {
    "shuffled": lambda v: [v[i] for i in (3, 8, 1, 0, 9, 5, 7, 2, 4, 6)],
    "t4 pair split": lambda v: v[:1] + [v[1] - 1] + v[2:],
    "t8 pair split": lambda v: v[:9] + [v[9] + 1],
    "always class 0": lambda v: v[:4] + [0] + v[5:],
    "t4 and t8 swapped at s = 1": lambda v: v[:8] + [v[9], v[8]],
}


@pytest.mark.parametrize("layout", sorted(OTHER_LAYOUTS))
@pytest.mark.parametrize("temperature", [2.2, 3.0])
def test_layout_check_picks_the_general_accept(layout, temperature):
    """A table of another layout goes to the kernels' general accept with
    all 10 thresholds, and its launches count as general ones."""
    values = [int(v) for v in
              ms.acceptance_thresholds(1 / temperature).tolist()]
    other = torch.tensor(OTHER_LAYOUTS[layout](values), dtype=torch.int64)
    assert _words.three_thresholds(other) is None
    array, count = _words.accept_arg(other)
    assert count == _words.N_CLASSES and list(array) == other.tolist()
    wrapper = type("Launches", (), {"launches": 0, "general_launches": 0})
    _words.count_launch(wrapper, (array, count))
    _words.count_launch(wrapper, _words.accept_arg(
        ms.acceptance_thresholds(1 / temperature)))
    assert (wrapper.launches, wrapper.general_launches) == (2, 1)


@pytest.mark.parametrize("temperature", [1.0, 2.0, 3.0, 5.0])
def test_onsager_energy_matches_elliptic_integral(temperature):
    """The exact energy the bitplane smoke run is held to: the AGM form of
    K against scipy's ``ellipk`` (parameter m = k^2)."""
    from scipy.special import ellipk
    from repro_torch.core.observables import onsager_energy
    b2 = 2.0 / temperature
    k = 2.0 * np.sinh(b2) / np.cosh(b2) ** 2
    want = -1 / np.tanh(b2) * (1 + 2 / np.pi * (2 * np.tanh(b2) ** 2 - 1)
                               * ellipk(k * k))
    assert onsager_energy(temperature) == pytest.approx(want, rel=1e-12)
    assert -2.0 < onsager_energy(temperature) < 0.0


@pytest.mark.parametrize("shape", [(1,), (3, 7), (5, 1 << 18), (2, 40, 12)])
def test_bit_counts_count_every_bit(shape):
    """The per-replica counts against the count of each bit of the uint32
    words, across chunks; a view that is not contiguous counts as its
    copy."""
    r = np.random.default_rng(sum(shape))
    u = r.integers(0, 2 ** 32, shape, dtype=np.uint64)
    words = torch.tensor(u.astype(np.uint32).view(np.int32))
    want = [int(((u >> k) & 1).sum()) for k in range(32)]
    assert bp.bit_counts(words).tolist() == want
    if words.dim() > 1 and words.shape[-1] > 1:
        view = words[..., ::2]
        want = [int(((u[..., ::2] >> k) & 1).sum()) for k in range(32)]
        assert bp.bit_counts(view).tolist() == want
