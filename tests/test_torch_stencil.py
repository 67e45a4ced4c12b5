"""The stencil kernel pair's modules on the CPU: the plain versions
(``repro_torch.core.metropolis``) and the wrappers against the JAX
package's Pallas kernels (interpret mode) and its oracle, bit-exact with
the acceptance table JAX computes; the tiled k-sweep algorithm of the
CUDA kernel and ``stencil_update``'s word update, emulated in PyTorch;
and the Hopper planner."""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import metropolis as jmetro
from repro.kernels.stencil.resident import \
    stencil_sweeps_resident as jax_resident
from repro.kernels.stencil.stencil import stencil_update as jax_update
from repro_torch.api import EngineSpec, LatticeSpec, RunSpec, Session
from repro_torch.core import metropolis, rng
from repro_torch.kernels import resident
from repro_torch.kernels.stencil import (stencil_sweeps_resident,
                                         stencil_update)
from repro_torch.kernels.stencil.stencil import bounds_arg, device_bounds

BETA = 1 / 1.7
SEED = 2 ** 40 + 7


def jax_table(beta):
    """The table of ``jnp.exp`` over the exact float32 arguments -- the
    values JAX's fused ``exp(-2 beta nn s)`` takes at every site."""
    args = jnp.asarray(metropolis.acceptance_arguments(beta))
    return torch.from_numpy(np.array(jnp.exp(args)))


def planes(n, m, seed=0):
    r = np.random.default_rng(seed)
    return tuple(np.where(r.random((n, m // 2)) < 0.5, 1, -1).astype(np.int8)
                 for _ in range(2))


def t(a):
    return torch.tensor(a)


def test_acceptance_arguments_are_exact_products():
    a = metropolis.acceptance_arguments(BETA)
    assert a.dtype == np.float32 and a.shape == (metropolis.TABLE_SIZE,)
    b = np.float32(-2.0) * np.float32(BETA)
    assert a[0] == b * -4 * -1 and a[9] == b * 4 and a[2] == 0 == a[7]
    table = metropolis.acceptance_table(BETA)
    assert table.dtype == torch.float32 and float(table[2]) == 1.0


@pytest.mark.parametrize("n,m", [(16, 32), (8, 12)])
@pytest.mark.parametrize("is_black,offset", [(True, 0), (False, 5),
                                             (True, 2 ** 32 - 1)])
def test_update_color_philox_matches_reference(n, m, is_black, offset):
    b, w = planes(n, m, seed=offset % 97)
    want = jmetro.update_color_philox(jnp.asarray(b), jnp.asarray(w),
                                      jnp.float32(BETA), is_black, SEED,
                                      jnp.uint32(offset))
    got = metropolis.update_color_philox(t(b), t(w), jax_table(BETA),
                                         is_black, SEED, offset)
    np.testing.assert_array_equal(np.asarray(want), got.numpy())


@pytest.mark.parametrize("k", [1, 3])
@pytest.mark.parametrize("start", [0, 6, 2 ** 32 - 3])
def test_run_sweeps_philox_matches_reference(k, start):
    b, w = planes(16, 32, seed=k)
    want = jmetro.run_sweeps_philox(jnp.asarray(b), jnp.asarray(w),
                                    jnp.float32(BETA), k, seed=SEED,
                                    start_offset=jnp.uint32(start))
    got = metropolis.run_sweeps_philox(t(b), t(w), jax_table(BETA), k, SEED,
                                       start)
    for x, y in zip(want, got):
        np.testing.assert_array_equal(np.asarray(x), y.numpy())


@pytest.mark.parametrize("is_black,offset", [(True, 3), (False, 2 ** 32 - 2)])
def test_stencil_update_wrapper_matches_pallas_kernel(is_black, offset):
    b, w = planes(16, 32, seed=4)
    want = jax_update(jnp.asarray(b), jnp.asarray(w), jnp.float32(BETA),
                      is_black=is_black, seed=SEED, offset=offset,
                      block_rows=8, interpret=True)
    target = t(b)
    before = stencil_update.launches
    got = stencil_update(target, t(w), jax_table(BETA), is_black=is_black,
                         seed=SEED, offset=offset)
    assert got is target  # in place, as on the card
    assert stencil_update.launches == before  # the CPU launches nothing
    np.testing.assert_array_equal(np.asarray(want), got.numpy())


@pytest.mark.parametrize("k", [1, 3])
def test_resident_wrapper_matches_pallas_kernel(k):
    b, w = planes(16, 32, seed=5)
    want = jax_resident(jnp.asarray(b), jnp.asarray(w), jnp.float32(BETA),
                        n_sweeps=k, seed=SEED, start_offset=4,
                        interpret=True)
    plan = resident.plan_resident("stencil", 16, 32)
    tb, tw = t(b), t(w)
    before = stencil_sweeps_resident.launches
    got = stencil_sweeps_resident(tb, tw, jax_table(BETA), n_sweeps=k,
                                  seed=SEED, start_offset=4, plan=plan)
    assert stencil_sweeps_resident.launches == before
    np.testing.assert_array_equal(tb.numpy(), b)  # inputs untouched
    for x, y in zip(want, got):
        np.testing.assert_array_equal(np.asarray(x), y.numpy())


@pytest.mark.parametrize("budget_k", [4, 2, 1, None])
@pytest.mark.parametrize("n_sweeps", [1, 3])
def test_resident_equals_half_sweeps_both_sides_of_planner(budget_k,
                                                           n_sweeps):
    """The k-sweep wrapper, at each plan the budget allows (k capped at
    MAX_SWEEPS_PER_LAUNCH; the per-half-sweep tier below the boundary),
    equals n_sweeps x two half-sweep wrapper calls."""
    n, m = 12, 20
    budget = (resident.smem_bytes(n, m // 2, 1) - 1 if budget_k is None
              else resident.smem_bytes(n, m // 2, budget_k))
    plan = resident.plan_resident("stencil", n, m, budget_bytes=budget)
    b, w = planes(n, m, seed=6)
    table = metropolis.acceptance_table(BETA)
    rb, rw = t(b), t(w)
    for i in range(n_sweeps):
        stencil_update(rb, rw, table, is_black=True, seed=SEED,
                       offset=rng.half_sweep_offset(9, i, 0))
        stencil_update(rw, rb, table, is_black=False, seed=SEED,
                       offset=rng.half_sweep_offset(9, i, 1))
    if budget_k is None:
        assert plan is None
        return
    assert plan.k == min(budget_k, resident.MAX_SWEEPS_PER_LAUNCH)
    got = stencil_sweeps_resident(t(b), t(w), table, n_sweeps=n_sweeps,
                                  seed=SEED, start_offset=9, plan=plan)
    assert torch.equal(got[0], rb) and torch.equal(got[1], rw)


def tiled_sweeps(black, white, table, k, seed, start, tile_r, tile_c,
                 gidx=None):
    """PyTorch emulation of ``stencil_sweeps_kernel`` (``csrc/
    stencil.cu``): every tile plus a halo (2k rows above and below; 2k
    columns rounded up to a 4-cell word on the left, and the row rounded
    up to whole words), indices wrapped modulo n and h, runs 2k
    half-sweeps on its own; half-sweep q updates the rows at distance >=
    q + 1 from the extended tile's edge and the whole words holding the
    columns at that distance; a cell flips iff its raw draw is below its
    entry of ``draw_bounds``; only the tile is written back.  Draws are
    keyed on global (row, col), or on ``gidx`` (the shard kernel, whose
    extended plane is the lattice here).  The extended tile's edge cells
    see wrong neighbours, as in the kernel."""
    n, h = black.shape
    halo = 2 * k
    left = -(-halo // 4) * 4
    er, ec = tile_r + 2 * halo, -(-(tile_c + 2 * left) // 4) * 4
    k0, k1 = rng.seed_keys(seed)
    bounds = torch.from_numpy(
        metropolis.draw_bounds(table.numpy()).astype(np.int64))
    out_b, out_w = torch.empty_like(black), torch.empty_like(white)
    for r0 in range(0, n, tile_r):
        for c0 in range(0, h, tile_c):
            rows = torch.arange(r0 - halo, r0 - halo + er) % n
            cols = torch.arange(c0 - left, c0 - left + ec) % h
            ext = [black[rows][:, cols].clone(), white[rows][:, cols].clone()]
            site = (rows[:, None] * h + cols[None, :] if gidx is None
                    else gidx.to(torch.int64)[rows][:, cols] & rng.MASK32)
            for s in range(k):
                for color in (0, 1):
                    m = 2 * s + color + 1
                    region = torch.zeros((er, ec), dtype=torch.bool)
                    region[m:er - m, 4 * (m // 4):4 * ((ec - m + 3) // 4)] = 1
                    tgt, op = ext[color], ext[1 - color]
                    plus = ((rows % 2 == 1) == (color == 0))[:, None]
                    side = torch.where(plus, torch.roll(op, -1, 1),
                                       torch.roll(op, 1, 1))
                    nn = (torch.roll(op, 1, 0) + torch.roll(op, -1, 0) + op
                          + side).to(torch.int64)
                    bits = rng.philox4x32(
                        rng.half_sweep_offset(start, s, color), 0, site, 0,
                        k0, k1)[0]
                    bound = bounds[(tgt > 0).to(torch.int64) * 5
                                   + (nn + 4) // 2]
                    ext[color] = torch.where(region & (bits < bound), -tgt,
                                             tgt)
            rr = slice(halo, halo + min(tile_r, n - r0))
            cc = slice(left, left + min(tile_c, h - c0))
            out_b[r0:r0 + tile_r, c0:c0 + tile_c] = ext[0][rr, cc]
            out_w[r0:r0 + tile_r, c0:c0 + tile_c] = ext[1][rr, cc]
    return out_b, out_w


@pytest.mark.parametrize("n,m,tile_r,tile_c,k", [
    (16, 32, 8, 16, 1),     # tiles divide the plane
    (12, 20, 5, 3, 2),      # ragged tiles, odd tile rows
    (8, 8, 8, 4, 3),        # halo wider than the plane: multiple wraps
    (12, 26, 5, 6, 2),      # plane width 13, not a multiple of 4
    (10, 6, 4, 3, 1),       # plane width 3, narrower than a word
    (8, 260, 4, 13, 3),     # width 130; a tile row of 13 + 2 x 8 cells
])
def test_tiled_k_sweeps_equal_whole_lattice_sweeps(n, m, tile_r, tile_c, k):
    """The halo argument the CUDA k-sweep kernel rests on, with its
    schedule: a region one ring smaller each half-sweep, in whole words,
    and the accept on integer draw bounds."""
    b, w = planes(n, m, seed=n + k)
    table = metropolis.acceptance_table(BETA)
    want = metropolis.run_sweeps_philox(t(b), t(w), table, k, SEED, 2)
    got = tiled_sweeps(t(b), t(w), table, k, SEED, 2, tile_r, tile_c)
    assert torch.equal(want[0], got[0]) and torch.equal(want[1], got[1])


@pytest.mark.parametrize("temperature", [0.05, 1.0, 2.0, 2.2, 3.0, 5.0])
def test_stencil_draw_bounds_decide_as_the_float_compare(temperature):
    """The bounds the stencil k-sweep wrappers hand their kernels
    (``bounds_arg``, ``metropolis.draw_bounds``): for each entry, the
    draw just below its bound flips and the bound itself does not under
    ``u32_to_uniform(draw) < p``, where those draws exist; random draws
    decide alike; p = 0, 1 and > 1 give 0, 2^32 - 128 and 2^32."""
    table = metropolis.acceptance_table(1.0 / temperature)
    p = table.numpy()
    bounds = np.array(list(bounds_arg(table)), dtype=np.int64)
    np.testing.assert_array_equal(bounds, metropolis.draw_bounds(p))

    def accepts(draws, entry):
        u = rng.u32_to_uniform(torch.tensor(draws, dtype=torch.int64))
        return (u < float(p[entry])).numpy()

    for entry, bound in enumerate(bounds):
        if bound >= 1:
            assert accepts([bound - 1], entry).all()
        if bound < 2 ** 32:
            assert not accepts([bound], entry).any()
    draws = np.random.default_rng(int(temperature * 100)).integers(
        0, 2 ** 32, 10 ** 5)
    for entry, bound in enumerate(bounds):
        np.testing.assert_array_equal(draws < bound, accepts(draws, entry))
    np.testing.assert_array_equal(bounds[p == 0], 0)
    np.testing.assert_array_equal(bounds[p == 1], 2 ** 32 - 128)
    np.testing.assert_array_equal(bounds[p > 1], 2 ** 32)
    assert (p == 0).any() == (temperature < 0.077)
    assert (p == 1).any() and (p > 1).any()


def test_planner_default_and_boundary():
    plan = resident.plan_resident("stencil", 32768, 32768)
    assert plan.k == resident.MAX_SWEEPS_PER_LAUNCH
    assert (plan.tile_rows, plan.tile_cols) == (resident.TILE_ROWS,
                                                resident.TILE_COLS)
    assert plan.smem_bytes == resident.smem_bytes(
        resident.TILE_ROWS, resident.TILE_COLS, plan.k)
    assert plan.smem_bytes <= resident.SMEM_BUDGET_BYTES
    small = resident.plan_resident("stencil", 16, 12)
    assert (small.tile_rows, small.tile_cols) == (16, 6)
    need1 = resident.smem_bytes(16, 6, 1)
    assert resident.plan_resident("stencil", 16, 12, need1).k == 1
    assert resident.plan_resident("stencil", 16, 12, need1 - 1) is None


def test_planner_reads_budget_at_call_time():
    """The budget given when an engine is built decides its tier; the
    default is the card's."""
    spec = RunSpec(lattice=LatticeSpec(64, 64),
                   engine=EngineSpec("stencil_pallas"), seed=3)
    assert Session.open(spec, device="cpu").engine.resident_plan.k == \
        resident.MAX_SWEEPS_PER_LAUNCH
    s = Session.open(spec, device="cpu", resident_budget_bytes=0)
    assert s.engine.resident_plan is None
    assert resident.plan_resident("stencil", 64, 64, budget_bytes=0) is None


def word_update(target, op, table, is_black, seed, offset):
    """numpy emulation of ``stencil_update_kernel``: a row as words of 4
    int8 cells (the last one padded with 0 cells past the row's end), the
    side word a byte permute of the centre and the word beside it (built
    cell by cell where the width is not a multiple of 4), per byte twice
    the count of -1 neighbours summed without carries, the byte offset 8
    x (5 (t > 0) + (nn + 4) / 2) of the cell's draw bound, and lane 0 of
    Philox at the cell's site compared with that bound."""
    n, h = target.shape
    nw = -(-h // 4)

    def words(cells):
        padded = np.zeros((n, 4 * nw), np.uint8)
        padded[:, :h] = cells.view(np.uint8)
        return padded.view("<u4").astype(np.int64)

    plus = ((np.arange(n) % 2 == 1) == is_black)[:, None]
    centre = words(op)
    if h % 4 == 0:
        after, before = np.roll(centre, -1, 1), np.roll(centre, 1, 1)
        side = np.where(plus, (centre >> 8) | ((after << 24) & 0xFFFFFFFF),
                        ((centre << 8) & 0xFFFFFFFF) | (before >> 24))
    else:
        side = words(np.where(plus, np.roll(op, -1, 1), np.roll(op, 1, 1)))
    t_words = words(target)
    k_down = 0x02020202
    down2 = sum(w & k_down for w in (np.roll(centre, 1, 0),
                                     np.roll(centre, -1, 0), centre, side))
    offset8 = ((0x12121212 - down2 - 5 * (t_words & k_down)) << 2) \
        & 0xFFFFFFFF
    bounds = np.array(list(bounds_arg(table)), np.int64)
    k0, k1 = rng.seed_keys(seed)
    base = (np.arange(n)[:, None] * h + 4 * np.arange(nw)[None, :])
    flip = np.zeros_like(t_words)
    for e in range(4):
        draw = rng.philox4x32(offset, 0, torch.from_numpy(
            (base + e) & rng.MASK32), 0, k0, k1)[0].numpy()
        bound = bounds[((offset8 >> (8 * e)) & 0xFF) // 8]
        flip |= np.where(draw < bound, 0xFE << (8 * e), 0)
    out = (t_words ^ flip).astype("<u4").view(np.uint8).reshape(n, 4 * nw)
    return out[:, :h].view(np.int8)


@pytest.mark.parametrize("n,h", [(9, 1), (13, 3), (21, 5), (17, 7),
                                 (17, 127), (33, 129), (15, 130), (7, 256)])
@pytest.mark.parametrize("is_black,offset", [(True, 2 ** 31 - 1),
                                             (False, 2 ** 32 - 1)])
def test_stencil_update_word_loop_equals_plain(n, h, is_black, offset):
    """The CUDA ``stencil_update``'s arithmetic on words of 4 cells, at
    widths that are and are not a multiple of 4 and odd row counts."""
    b, w = planes(n, 2 * h, seed=n + h)
    table = metropolis.acceptance_table(BETA)
    want = metropolis.update_color_philox(t(b), t(w), table, is_black, SEED,
                                          offset)
    got = word_update(b, w, table, is_black, SEED, offset)
    np.testing.assert_array_equal(got, want.numpy())


def test_stencil_update_word_loop_cold_all_up_never_flips():
    """At T = 0.05 from all-up planes every bound is 0."""
    up = np.ones((11, 130), np.int8)
    got = word_update(up, up, metropolis.acceptance_table(1 / 0.05), True,
                      SEED, 5)
    np.testing.assert_array_equal(got, up)


def test_device_bounds_are_the_draw_bounds_made_once():
    table = metropolis.acceptance_table(BETA)
    got = device_bounds(table, "cpu")
    assert got.dtype == torch.int64 and got.tolist() == list(
        bounds_arg(table))
    assert device_bounds(table.clone(), "cpu") is got


def test_planner_rejects_unported_family():
    with pytest.raises(ValueError, match="ported"):
        resident.plan_resident("tensorcore", 16, 16)


def test_wrappers_validate_planes():
    b, w = planes(8, 8)
    table = metropolis.acceptance_table(BETA)
    with pytest.raises(ValueError, match="int8"):
        stencil_update(t(b).to(torch.int32), t(w), table, is_black=True,
                       seed=1, offset=0)
    with pytest.raises(ValueError, match="differ"):
        stencil_update(t(b), t(w)[:4], table, is_black=True, seed=1,
                       offset=0)
    plan = resident.plan_resident("stencil", 16, 16)
    with pytest.raises(ValueError, match="plan is for"):
        stencil_sweeps_resident(t(b), t(w), table, n_sweeps=1, seed=1,
                                start_offset=0, plan=plan)
    plan8 = dataclasses.replace(plan, n=8, m=8)
    with pytest.raises(ValueError, match="n_sweeps"):
        stencil_sweeps_resident(t(b), t(w), table, n_sweeps=0, seed=1,
                                start_offset=0, plan=plan8)
