"""The port's sharded tier against the JAX package, on the CPU.

* the plain per-shard kernels equal ``repro.dist.kernels`` in Pallas
  interpret mode, bit for bit, on whole halo-extended planes with random
  planes and random index planes;
* the shard planner, re-derived for Hopper shared memory, keeps the JAX
  planner's rules (``tests/test_dist.py``);
* the halo gather equals a modular slice of the whole plane on several
  grids;
* sharded sessions on both tiers give the single-mode digest and the
  JAX package's, count halo exchanges in the JAX package's units, and
  restore across meshes and across packages;
* the spec checks and the ``--mesh`` flag.
"""
import functools
import math

import numpy as np
import pytest
import torch

import repro.api as japi
import repro_torch.dist
from repro.core import multispin as jms
from repro.dist import kernels as jdk
from repro_torch import __main__ as cli
from repro_torch.api import (BatchSpec, EngineSpec, LatticeSpec, MeshSpec,
                             RunSpec, Session)
from repro_torch.core import distributed as dist
from repro_torch.core import metropolis
from repro_torch.dist import kernels as dk
from repro_torch.dist import planner
from repro_torch.dist.driver import extend
from repro_torch.dist.planner import (K_CAP, SHARD_THREADS,
                                      plan_shard_resident,
                                      shard_decision_attrs, shard_smem_bytes)
from repro_torch.kernels.resident import GEOMETRY, SMEM_BUDGET_BYTES
from repro_torch.launch.mesh import Mesh, make_mesh

TEMPERATURE = 2.2
SEED = 2 ** 33 + 5


def words(a: np.ndarray) -> torch.Tensor:
    """A uint32 numpy plane as the port's int32 tensor of the same bits."""
    return torch.tensor(np.ascontiguousarray(a).view(np.int32))


def jax_table(beta):
    """The JAX package's accept values: jnp.exp of the same float32
    arguments (what its stencil shard kernel computes per site)."""
    import jax.numpy as jnp
    return torch.tensor(np.asarray(jnp.exp(jnp.asarray(
        metropolis.acceptance_arguments(beta)))))


# -- the plain shard kernels against the Pallas kernels ---------------------

@pytest.mark.parametrize("family", ["stencil", "multispin", "bitplane"])
@pytest.mark.parametrize("n_sweeps", [1, 3])
def test_plain_shard_kernel_equals_jax(family, n_sweeps):
    """Whole extended planes, edge rings included, with index planes of
    random uint32 values (lanes too, so that every lane and 'else 3'
    occurs) and a start offset that wraps."""
    r = np.random.default_rng(n_sweeps * 7 + len(family))
    shape, start = (14, 10), 2 ** 32 - 3
    beta = np.float32(1.0 / TEMPERATURE)
    idx = [r.integers(0, 2 ** 32, shape, dtype=np.uint64).astype(np.uint32)
           for _ in range(2)]
    if family == "stencil":
        b, w = (np.where(r.random(shape) < 0.5, 1, -1).astype(np.int8)
                for _ in range(2))
        want = jdk.stencil_shard_sweeps(
            b, w, beta, idx[0], n_sweeps=n_sweeps, seed=SEED,
            start_offset=start, interpret=True)
        got = dk.stencil_shard_sweeps(
            torch.tensor(b), torch.tensor(w), jax_table(beta),
            words(idx[0]), n_sweeps=n_sweeps, seed=SEED, start_offset=start)
    else:
        b, w = (r.integers(0, 2 ** 32, shape, dtype=np.uint64)
                .astype(np.uint32) for _ in range(2))
        thr = np.asarray(jms.acceptance_thresholds(beta))
        if family == "multispin":
            # one spin bit per 4-bit nibble
            b, w = b & np.uint32(0x11111111), w & np.uint32(0x11111111)
            want = jdk.multispin_shard_sweeps(
                b, w, thr, idx[0], n_sweeps=n_sweeps, seed=SEED,
                start_offset=start, interpret=True)
            got = dk.multispin_shard_sweeps(
                words(b), words(w), torch.tensor(thr.astype(np.int64)),
                words(idx[0]), n_sweeps=n_sweeps, seed=SEED,
                start_offset=start)
        else:
            lane = idx[1] % np.uint32(6)   # 4 and 5 take lane 3
            want = jdk.bitplane_shard_sweeps(
                b, w, thr, idx[0], lane, n_sweeps=n_sweeps, seed=SEED,
                start_offset=start, interpret=True)
            got = dk.bitplane_shard_sweeps(
                words(b), words(w), torch.tensor(thr.astype(np.int64)),
                words(idx[0]), words(lane), n_sweeps=n_sweeps, seed=SEED,
                start_offset=start)
    for g, x in zip(got, want):
        x = np.asarray(x)
        np.testing.assert_array_equal(
            g.numpy(), x.view(np.int32) if x.dtype == np.uint32 else x)


@pytest.mark.parametrize("n,w,n_sweeps,tile_r,tile_c", [
    (14, 10, 1, 8, 8),
    (12, 3, 1, 6, 3),         # extended widths 3 and 5: under a word
    (14, 5, 2, 6, 5),
    (10, 129, 1, 5, 120),     # past a row of 32 words
    (16, 130, 3, 8, 13),      # tiles whose width is not a multiple of 4
])
def test_stencil_shard_kernel_schedule_equals_plain(n, w, n_sweeps, tile_r,
                                                    tile_c):
    """The CUDA stencil shard kernel's schedule (the tile emulation of
    ``test_torch_stencil``, keyed on gidx: a region one ring smaller
    each half-sweep in whole 4-cell words, the accept on integer draw
    bounds) gives the plain version's whole extended planes with random
    index planes and a start offset that wraps."""
    from test_torch_stencil import tiled_sweeps
    r = np.random.default_rng(n * w + n_sweeps)
    b, w_ = (torch.tensor(np.where(r.random((n, w)) < 0.5, 1, -1)
                          .astype(np.int8)) for _ in range(2))
    gidx = words(r.integers(0, 2 ** 32, (n, w), dtype=np.uint64)
                 .astype(np.uint32))
    table = metropolis.acceptance_table(1.0 / TEMPERATURE)
    want = dk.stencil_shard_sweeps_plain(b, w_, table, gidx,
                                         n_sweeps=n_sweeps, seed=SEED,
                                         start_offset=2 ** 32 - 3)
    got = tiled_sweeps(b, w_, table, n_sweeps, SEED, 2 ** 32 - 3, tile_r,
                       tile_c, gidx=gidx)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


def bitplane_tiled_shard_sweeps(black, white, thr, gidx, lane, k, seed,
                                start, tile_r, tile_c, counts=None):
    """PyTorch emulation of ``bitplane_shard_sweeps_kernel`` (``csrc/
    bitplane.cu``) on an extended plane: every tile plus 2k rows above and
    below and ``col_halo(k)`` columns each side, its columns rounded up to
    whole 4-word groups, indices wrapped over the plane, runs 2k
    half-sweeps on its own.  A group whose 4 words hold one gidx and the
    lanes 0, 1, 2, 3 in order draws the 4 lanes of one Philox call; any
    other group draws per word, lane min(lane, 3) of the call at the
    word's own gidx.  Half-sweep q updates the rows at distance >= q + 1
    from the extended tile's edge and the groups holding a column at that
    distance, the side neighbour wrapped within the extended tile; only
    the tile is written back.  ``counts`` (a dict) collects the aligned
    and the other groups."""
    from repro_torch.core import bitplane as bp
    from repro_torch.core import rng
    from repro_torch.kernels.resident import col_halo
    n, w = black.shape
    halo, left = 2 * k, col_halo(k, "bitplane")
    er, ec = tile_r + 2 * halo, -(-tile_c // 4) * 4 + 2 * left
    k0, k1 = rng.seed_keys(seed)
    out_b, out_w = torch.empty_like(black), torch.empty_like(white)
    for r0 in range(0, n, tile_r):
        for c0 in range(0, w, tile_c):
            rows = torch.arange(r0 - halo, r0 - halo + er) % n
            cols = torch.arange(c0 - left, c0 - left + ec) % w
            ext = [black[rows][:, cols].clone(), white[rows][:, cols].clone()]
            g = gidx.to(torch.int64)[rows][:, cols] & rng.MASK32
            ln = lane.to(torch.int64)[rows][:, cols]
            gg, lg = g.reshape(er, -1, 4), ln.reshape(er, -1, 4)
            aligned = ((gg == gg[..., :1]).all(-1)
                       & (lg == torch.arange(4)).all(-1))
            if counts is not None:
                counts["aligned"] += int(aligned.sum())
                counts["other"] += int((~aligned).sum())
            for s in range(k):
                for color in (0, 1):
                    off = rng.half_sweep_offset(start, s, color)
                    group = torch.stack(rng.philox4x32(
                        off, 0, gg[..., 0], 0, k0, k1), -1).reshape(er, ec)
                    draws = torch.where(aligned.repeat_interleave(4, 1),
                                        group, bp.lane_draws(seed, g, ln, off))
                    m = 2 * s + color + 1
                    region = torch.zeros((er, ec), dtype=torch.bool)
                    region[m:er - m, 4 * (m // 4):4 * ((ec - m + 3) // 4)] = 1
                    tgt, op = ext[color], ext[1 - color]
                    plus = ((rows % 2 == 1) == (color == 0))[:, None]
                    side = torch.where(plus, torch.roll(op, -1, 1),
                                       torch.roll(op, 1, 1))
                    nbrs = bp.bit_count_neighbors(torch.roll(op, 1, 0),
                                                  torch.roll(op, -1, 0), op,
                                                  side)
                    new = tgt ^ bp.flip_word_from_classes(tgt, nbrs, draws,
                                                          thr)
                    ext[color] = torch.where(region, new, tgt)
            rr = slice(halo, halo + min(tile_r, n - r0))
            cc = slice(left, left + min(tile_c, w - c0))
            out_b[r0:r0 + tile_r, c0:c0 + tile_c] = ext[0][rr, cc]
            out_w[r0:r0 + tile_r, c0:c0 + tile_c] = ext[1][rr, cc]
    return out_b, out_w


def driver_index_planes(family, n, k, i, mesh=(2, 2)):
    """Shard ``i``'s index planes of the sharded driver on a 2 x 2 mesh
    of an n x n lattice, k pinned."""
    from repro_torch.dist.driver import index_planes
    plan = plan_shard_resident(family, n, n, *mesh, k_cap=k,
                               max_overlap=100.0)
    assert plan is not None and plan.k == k
    grid = dist.ShardGrid.of(make_mesh(mesh, ("data", "model"),
                                       device="cpu"),
                             n, n // GEOMETRY[family].col_divisor)
    return plan, index_planes(plan, grid, i)


@pytest.mark.parametrize("case", ["random", "mixed", "driver-1", "driver-2",
                                  "driver-3"])
def test_bitplane_shard_kernel_group_draws_equal_plain(case):
    """The CUDA bitplane shard kernel's group decision and schedule (the
    emulation above) give the plain version's whole extended planes: on
    random planes (no group aligned, extended width 10, not a multiple
    of 4), on planes where some groups are broken, and on the driver's
    planes at k = 1, 2, 3 (aligned groups only at k = 2)."""
    from repro_torch.core import multispin
    r = np.random.default_rng(len(case))
    thr = multispin.acceptance_thresholds(1 / 2.3)
    if case == "random":
        n, w, k, tile = 14, 10, 2, (6, 8)
        gidx = words(r.integers(0, 2 ** 32, (n, w), dtype=np.uint64)
                     .astype(np.uint32))
        lane = torch.tensor(r.integers(0, 6, (n, w)).astype(np.int32))
    elif case == "mixed":
        n, w, k, tile = 20, 40, 2, (8, 16)
        cols = np.arange(w)
        g = np.arange(n)[:, None] * 1000 + cols[None, :] // 4
        ln = np.broadcast_to(cols % 4, (n, w)).copy()
        ln[3, 8] = 7                  # a lane past 3: per word
        g[5, 13] += 1                 # a group of two gidx
        ln[9, 20:24] = [1, 0, 2, 3]   # lanes out of order
        gidx = words(g.astype(np.uint32))
        lane = torch.tensor(ln.astype(np.int32))
    else:
        k = int(case[-1])
        plan, (gidx, lane) = driver_index_planes("bitplane", 64, k, 3)
        n, w = gidx.shape
        tile = (16, 12)
    b, w_ = (words(r.integers(0, 2 ** 32, (n, w), dtype=np.uint64)
                   .astype(np.uint32)) for _ in range(2))
    counts = {"aligned": 0, "other": 0}
    got = bitplane_tiled_shard_sweeps(b, w_, thr, gidx, lane, k, SEED,
                                      2 ** 32 - 3, *tile, counts)
    want = dk.bitplane_shard_sweeps_plain(b, w_, thr, gidx, lane,
                                          n_sweeps=k, seed=SEED,
                                          start_offset=2 ** 32 - 3)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    if case in ("random", "driver-1", "driver-3"):
        assert counts["aligned"] == 0
    elif case == "driver-2":
        assert counts["other"] == 0
    else:
        assert counts["aligned"] > 0 and counts["other"] > 0


@pytest.mark.parametrize("n", [64, 1024])
@pytest.mark.parametrize("i", [0, 1, 2, 3])
def test_driver_planes_at_k2_are_aligned_groups(n, i):
    """At k = 2 (a halo of 4 columns) every extended shard starts 4
    columns left of a group, so every run of 4 words from column 0 is one
    Philox group with lanes 0, 1, 2, 3: the bitplane shard kernel draws
    once per group on the main path (its tile columns are whole groups).
    At k = 1 and 3 (halos of 2 and 6) no such run is one."""
    for k in (1, 2, 3):
        if n > 64 and k != 2:
            continue
        plan, (gidx, lane) = driver_index_planes("bitplane", n, k, i)
        rows = slice(0, 16)       # the planes repeat by rows
        g = gidx[rows].to(torch.int64).reshape(16, -1, 4)
        ln = lane[rows].reshape(16, -1, 4)
        aligned = (g == g[..., :1]).all(-1) & (ln == torch.arange(4)).all(-1)
        assert bool(aligned.all()) == (k == 2)
        assert not aligned.any() or k == 2
    assert planner.SHARD_TILES["bitplane"][1] % 4 == 0


def test_shard_kernel_rejects_bad_index_planes():
    b = torch.ones((6, 4), dtype=torch.int8)
    table = metropolis.acceptance_table(0.5)
    with pytest.raises(ValueError, match="do not match"):
        dk.stencil_shard_sweeps(b, b, table,
                                torch.zeros((6, 5), dtype=torch.int32),
                                n_sweeps=1, seed=1, start_offset=0)
    with pytest.raises(ValueError, match="n_sweeps"):
        dk.stencil_shard_sweeps(b, b, table,
                                torch.zeros((6, 4), dtype=torch.int32),
                                n_sweeps=0, seed=1, start_offset=0)


# -- the shard planner (tests/test_dist.py's rules) -------------------------

def test_plan_picks_largest_feasible_k():
    """Default cap: the smaller of K_CAP and the family's measured
    max_k."""
    plan = plan_shard_resident("stencil", 64, 128, 2, 1)
    assert plan is not None
    assert plan.k == min(K_CAP, GEOMETRY["stencil"].max_k) == 2
    assert plan.halo == 2 * plan.k
    assert plan.n_loc == 32 and plan.w_loc == 64
    assert plan_shard_resident("stencil", 64, 128, 2, 1, k_cap=K_CAP).k \
        == K_CAP


def test_plan_halo_always_even():
    for k_cap in range(1, K_CAP + 1):
        plan = plan_shard_resident("stencil", 64, 128, 2, 1, k_cap=k_cap,
                                   max_overlap=100.0)
        assert plan is not None and plan.k == k_cap
        assert plan.halo == 2 * plan.k and plan.halo % 2 == 0


def test_plan_rejects_non_divisible_grid():
    assert plan_shard_resident("stencil", 64, 128, 3, 1) is None
    assert plan_shard_resident("stencil", 64, 128, 1, 5) is None
    # odd rows per shard break the uniform checkerboard parity
    assert plan_shard_resident("stencil", 34, 128, 2, 1) is None


def test_plan_overlap_cap_demotes_small_shards():
    assert plan_shard_resident("stencil", 32, 64, 4, 4) is None
    assert plan_shard_resident("stencil", 32, 64, 4, 4,
                               max_overlap=100.0) is not None


def test_plan_halo_fit():
    # 4-row shards fit h = 2 and 4, not 6
    assert plan_shard_resident("stencil", 16, 256, 4, 1, k_cap=3,
                               max_overlap=100.0).k == 2


def test_plan_shared_memory_budget_demotes():
    assert plan_shard_resident("stencil", 64, 128, 2, 1,
                               budget_bytes=64) is None
    assert plan_shard_resident("stencil", 64, 128, 2, 1,
                               budget_bytes=0) is None


@pytest.mark.parametrize("family,index_bytes", [("stencil", 4),
                                                ("multispin", 4),
                                                ("bitplane", 5)])
def test_plan_shared_memory_counts_index_planes(family, index_bytes):
    """No kernel keeps row or column index tables.  The stencil and
    multispin kernels' rows are whole 4-cell words or 4-word chunks: a
    left halo of 2k rounded up to 4, and the row rounded up to 4 (10 + 2
    x 4 = 18 -> 20 cells or words); the bitplane kernel keeps its index
    planes per 4-word group (a uint32 gidx and an aligned byte)."""
    g = GEOMETRY[family]
    if family == "bitplane":
        # per 4-word group: tile columns 10 -> 12, a column halo of 2k
        # rounded up to 4 each side
        er, ec = 8 + 4, 12 + 2 * 4
        assert shard_smem_bytes(family, 8, 10, 1) == (
            2 * g.element_bytes * er * ec + index_bytes * er * ec // 4)
        return
    er, ec = 8 + 4, 20
    assert shard_smem_bytes(family, 8, 10, 1) == (
        g.table_bytes + (index_bytes + 2 * g.element_bytes) * er * ec)


@pytest.mark.parametrize("family,n,tile", [("stencil", 32768, (64, 248)),
                                           ("multispin", 32768, (64, 120)),
                                           ("bitplane", 16384, (32, 248))])
def test_plan_of_the_main_paths(family, n, tile):
    """2 x 2 shards of the full-size lattices take the family's shard
    tile at k = 2 within one block's shared memory."""
    plan = plan_shard_resident(family, n, n, 2, 2)
    assert plan.k == 2 and (plan.tile_rows, plan.tile_cols) == tile
    assert plan.threads == SHARD_THREADS[family]
    assert plan.smem_bytes == shard_smem_bytes(family, *tile, 2) \
        <= SMEM_BUDGET_BYTES
    assert plan.n_loc == n // 2


def test_plan_shrinks_the_tile_to_the_extended_plane():
    plan = plan_shard_resident("multispin", 64, 1024, 2, 2, k_cap=3,
                               max_overlap=100.0)
    assert (plan.tile_rows, plan.tile_cols) == (32 + 12, 32 + 12)


def test_plan_exchanges_ceil_semantics():
    plan = plan_shard_resident("stencil", 64, 128, 2, 1, k_cap=3,
                               max_overlap=100.0)
    assert plan.k == 3
    assert plan.exchanges(6) == 2
    assert plan.exchanges(7) == 3
    assert plan.exchanges(1) == 1


def test_plan_halo_bytes_formula():
    plan = plan_shard_resident("stencil", 64, 128, 2, 2, k_cap=1,
                               max_overlap=100.0)
    h, nl, wl = plan.halo, plan.n_loc, plan.w_loc
    per_plane = 2 * nl * h + 2 * h * (wl + 2 * h)
    assert plan.halo_bytes_per_exchange == 2 * per_plane * 1 * 4
    word = plan_shard_resident("bitplane", 64, 128, 2, 2, k_cap=1,
                               max_overlap=100.0)
    assert word.cell_bytes == 4 and word.width == 64


def test_decision_attrs_positive_and_demoted():
    attrs = shard_decision_attrs("stencil", 64, 128, 2, 1)
    assert attrs["sharded_resident"] is True and attrs["grid"] == "2x1"
    assert attrs["halo_width"] == 2 * attrs["halo_k"]
    assert attrs["smem_bytes"] <= attrs["budget_bytes"]
    attrs = shard_decision_attrs("stencil", 64, 128, 3, 1)
    assert attrs["sharded_resident"] is False
    assert "tile the device grid" in attrs["reason"]
    attrs = shard_decision_attrs("stencil", 64, 128, 2, 1, budget_bytes=0)
    assert "shared-memory" in attrs["reason"]


def test_unknown_family_raises():
    with pytest.raises(ValueError, match="unknown resident family"):
        plan_shard_resident("nope", 64, 64, 2, 1)


# -- mesh, halo gather ------------------------------------------------------

def test_mesh_places_shard_i_on_device_i_mod_count():
    devices = tuple(torch.device("cuda", i) for i in range(3))
    mesh = Mesh((2, 4), ("data", "model"), devices)
    assert [mesh.device_of(i).index for i in range(8)] == \
        [0, 1, 2, 0, 1, 2, 0, 1]
    mesh = make_mesh((2, 2), ("data", "model"), "cpu")
    assert {mesh.device_of(i).type for i in range(4)} == {"cpu"}


def test_mesh_without_a_card_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        make_mesh((2, 2), ("data", "model"))


@pytest.mark.parametrize("shape", [(2, 2), (4, 1), (2, 1, 2)])
def test_extend_equals_a_modular_slice(shape):
    """Every shard's extended plane is the whole plane's cells at its
    rows and columns modulo the plane, corners included, on grids whose
    rows run over one axis or a product of two."""
    mesh = make_mesh(shape, tuple(f"a{i}" for i in range(len(shape))),
                     "cpu")
    n, width = 16, 12
    plane = torch.arange(n * width, dtype=torch.int32).reshape(n, width)
    grid = dist.ShardGrid.of(mesh, n, width)
    shards = []
    for i in range(mesh.size):
        r0, c0 = grid.origin(i)
        shards.append(plane[r0:r0 + grid.n_loc, c0:c0 + grid.w_loc]
                      .contiguous())
    assert torch.equal(grid.gather(shards), plane)
    for h in (1, 2):
        for i, e in enumerate(extend(shards, grid, h)):
            r0, c0 = grid.origin(i)
            rows = np.arange(r0 - h, r0 + grid.n_loc + h) % n
            cols = np.arange(c0 - h, c0 + grid.w_loc + h) % width
            np.testing.assert_array_equal(e.numpy(),
                                          plane.numpy()[np.ix_(rows, cols)])


def test_extend_refuses_a_halo_wider_than_a_shard():
    mesh = make_mesh((4, 1), ("a", "b"), "cpu")
    grid = dist.ShardGrid.of(mesh, 8, 8)
    with pytest.raises(ValueError, match="wider"):
        extend([torch.zeros((2, 8))] * 4, grid, 3)


# -- sharded sessions -------------------------------------------------------

#: lattices whose 2 x 2 shards fit k = 3 under the default overlap cap
LATTICES = {"stencil_pallas": (64, 128), "multispin_pallas": (64, 1024),
            "bitplane_pallas": (64, 128), "multispin": (64, 1024),
            "bitplane": (64, 128)}
PRE, RUN = 2, 5   # sweeps before the checkpoint, and after it


def spec(engine, mesh_shape=None, lattice=None):
    n, m = lattice or LATTICES[engine]
    mesh = None if mesh_shape is None else MeshSpec(
        mesh_shape, tuple(f"a{i}" for i in range(len(mesh_shape))))
    return RunSpec(lattice=LatticeSpec(n, m), engine=EngineSpec(engine),
                   temperature=TEMPERATURE, seed=SEED, mesh=mesh)


def pin_k(monkeypatch, k):
    """Pin the shard planner's k in the sessions of a test (``None``:
    its default), as the JAX package's tests pin its planner's budget:
    the driver is exact at any feasible k."""
    if k is not None:
        monkeypatch.setattr(
            repro_torch.dist, "plan_shard_resident",
            functools.partial(planner.plan_shard_resident, k_cap=k))


@pytest.fixture(scope="module")
def jax_digests():
    """engine -> the JAX package's digest after RUN sweeps from a
    checkpoint (computed once per engine: it does not depend on k)."""
    return {}


@pytest.mark.parametrize("engine,k", [
    ("stencil_pallas", 1), ("stencil_pallas", 3),
    ("multispin_pallas", 1), ("multispin_pallas", 3),
    ("bitplane_pallas", 1), ("bitplane_pallas", 3),
    ("multispin", None), ("bitplane", None)])
def test_sharded_session_equals_single_mode_and_jax(engine, k, tmp_path,
                                                    jax_digests, monkeypatch):
    """A 2 x 2 session, PRE sweeps, a checkpoint, RUN more sweeps (k = 3:
    one block and a remainder of 2): the same digest as the port's
    single-mode run from the same spec and as the JAX package's single
    mode restored from the checkpoint."""
    pin_k(monkeypatch, k)
    s = Session.open(spec(engine, (2, 2)), device="cpu")
    assert s.mode == "sharded"
    if engine.endswith("_pallas"):
        assert s.shard_plan is not None and s.shard_plan.k == k
    else:
        assert s.shard_plan is None     # the JAX package's routing
    s.run(PRE)
    path = str(tmp_path / "sharded.npz")
    s.save(path)
    s.run(RUN)
    if k is None:
        assert s.halo_exchanges == 2 * (PRE + RUN)
    else:
        assert s.halo_exchanges == math.ceil(PRE / k) + math.ceil(RUN / k)
    single = Session.open(spec(engine), device="cpu")
    single.run(PRE + RUN)
    assert s.state_digest() == single.state_digest()
    if engine not in jax_digests:
        j = japi.Session.restore(path, mesh=None)
        assert j.step_count == PRE
        j.run(RUN)
        jax_digests[engine] = j.state_digest()
    assert s.state_digest() == jax_digests[engine]
    # observables from per-shard sums: the single-mode values bit for bit
    want = single.engine.observables(single.state, single.engine.cfg.inv_temp)
    got = s._runner.observables()
    for f in ("m", "e"):
        assert torch.equal(got[f], want[f])
    assert s.magnetization() == single.magnetization()
    assert s.energy() == single.energy()


@pytest.mark.parametrize("engine", ["stencil_pallas", "bitplane_pallas"])
def test_plan_none_takes_the_per_half_sweep_tier(engine):
    s = Session.open(spec(engine, (2, 2)), device="cpu",
                     resident_budget_bytes=0)
    assert s.shard_plan is None
    s.run(3)
    assert s.halo_exchanges == 6
    single = Session.open(spec(engine), device="cpu")
    single.run(3)
    assert s.state_digest() == single.state_digest()


def test_bitplane_step_with_unaligned_shard_columns():
    """Shards 6 words wide: their columns do not start on 4-site groups,
    so each site draws its lane of its group's call."""
    s = Session.open(spec("bitplane", (2, 2), (8, 24)), device="cpu")
    assert s._runner.grid.w_loc % 4
    s.run(4)
    single = Session.open(spec("bitplane", None, (8, 24)), device="cpu")
    single.run(4)
    assert s.state_digest() == single.state_digest()


def test_measure_is_per_sample_and_equals_single_mode():
    from repro_torch.analysis import MeasurementPlan
    plan = MeasurementPlan(3, 2, thermalize=1)
    s = Session.open(spec("bitplane_pallas", (2, 2)), device="cpu")
    single = Session.open(spec("bitplane_pallas"), device="cpu")
    got, want = s.measure(plan), single.measure(plan)
    for f in want:
        assert got[f].shape == (3, 32) and got[f].dtype == np.float32
        np.testing.assert_array_equal(got[f], want[f])
    assert s.step_count == single.step_count == 7
    with pytest.raises(ValueError, match="not in engine"):
        s.measure(MeasurementPlan(1, 1, fields=("chi",)))


def test_cross_mesh_restore_chain(tmp_path):
    """Saved on 2 x 2, resumed on 4 x 1, on (2, 1, 2) and in single
    mode: the uninterrupted single-mode digest; the JAX package resumes
    the sharded checkpoint."""
    engine = "stencil_pallas"
    ref = Session.open(spec(engine), device="cpu")
    ref.run(8)
    s = Session.open(spec(engine, (2, 2)), device="cpu")
    s.run(2)
    for i, mesh in enumerate([MeshSpec((4, 1), ("a", "b")),
                              MeshSpec((2, 1, 2), ("a", "b", "c")), None]):
        path = str(tmp_path / f"ck{i}.npz")
        s.save(path)
        s = Session.restore(path, device="cpu", mesh=mesh)
        assert s.mode == ("single" if mesh is None else "sharded")
        s.run(2)
    assert s.step_count == 8
    assert s.state_digest() == ref.state_digest()
    j = japi.Session.restore(str(tmp_path / "ck0.npz"), mesh=None)
    j.run(6)
    assert j.state_digest() == ref.state_digest()


def test_single_mode_checkpoint_resumes_on_a_mesh(tmp_path):
    path = str(tmp_path / "single.npz")
    s = Session.open(spec("multispin_pallas"), device="cpu")
    s.run(2)
    s.save(path)
    s.run(3)
    r = Session.restore(path, device="cpu",
                        mesh=MeshSpec((2, 2), ("data", "model")))
    assert r.spec.mesh.shape == (2, 2) and r.halo_exchanges == 0
    r.run(3)
    assert r.state_digest() == s.state_digest()
    assert r.full_lattice().shape == (64, 1024)
    assert torch.equal(r.full_lattice(), s.full_lattice())


def test_restore_rejects_a_lattice_of_another_size(tmp_path):
    path = str(tmp_path / "small.npz")
    Session.open(spec("stencil_pallas", None, (32, 64)), device="cpu") \
        .save(path)
    import json
    with np.load(path) as z:
        arrays = dict(z)
    doc = json.loads(str(arrays["spec_json"]))
    doc["lattice"]["n"] = 64
    arrays["spec_json"] = json.dumps(doc)
    np.savez(path, **arrays)
    with pytest.raises(ValueError, match="lattice needs"):
        Session.restore(path, device="cpu",
                        mesh=MeshSpec((2, 2), ("a", "b")))


def test_lattice_that_does_not_tile_the_mesh_raises():
    # 9 rows a shard: the shards would not share the checkerboard parity
    with pytest.raises(ValueError, match="does not tile"):
        Session.open(spec("stencil_pallas", (2, 1), (18, 8)), device="cpu")


# -- spec and CLI -----------------------------------------------------------

def test_spec_errors_as_in_the_jax_package():
    mesh = MeshSpec((2, 2), ("data", "model"))
    with pytest.raises(ValueError, match="no distributed step"):
        RunSpec(lattice=LatticeSpec(64, 64),
                engine=EngineSpec("tensorcore", {"tc_block": 16}), mesh=mesh)
    with pytest.raises(ValueError, match="batch \\+ mesh"):
        RunSpec(batch=BatchSpec(temperatures=(2.0,)), mesh=mesh)
    doc = spec("bitplane", (2, 2)).to_json()
    assert japi.RunSpec.from_json(doc).to_json() == doc
    assert RunSpec.from_json(doc).mode == "sharded"


def test_cli_mesh_prints_the_single_mode_magnetization(capsys, tmp_path):
    flags = ["run", "--device", "cpu", "--n", "32", "--init-p-up", "1.0",
             "--temperature", "2.0", "--seed", "7", "--sweeps", "6"]
    assert cli.main(flags) == 0
    single = capsys.readouterr().out
    path = str(tmp_path / "mesh.npz")
    assert cli.main(flags + ["--mesh", "2x2", "--mesh-axes", "data,model",
                             "--save", path]) == 0
    sharded = capsys.readouterr().out
    assert "2x2 mesh" in sharded
    assert single.split("|m| = ")[1] == sharded.split("|m| = ")[1] \
        .split("\n")[0] + "\n"
    r = Session.restore(path, device="cpu")
    assert r.spec.mesh.axis_names == ("data", "model")
    assert r.step_count == 6


def test_weakscale_rows_carry_pct_of_roofline_with_jax_keys(tmp_path):
    """``python -m repro_torch.dist.weakscale --json`` rows carry
    ``pct_of_roofline`` (the record's backend's roofline at the row's k)
    and the same keys as a JAX weakscale row, in a record that both
    packages' schemas accept."""
    import json
    import os
    import subprocess
    import sys

    from repro.perf.schema import validate_record as jax_validate
    from repro_torch.dist import weakscale
    from repro_torch.launch import roofline
    args = ["--devices", "1,2", "--sweeps", "1", "--trials", "1"]
    jax_path, port_path = tmp_path / "jax.json", tmp_path / "port.json"
    src = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "src")
    proc = subprocess.run(
        [sys.executable, "-m", "repro.dist.weakscale", *args, "--json",
         str(jax_path)], capture_output=True, text=True, timeout=600,
        env=dict(os.environ, PYTHONPATH=src, JAX_PLATFORMS="cpu"))
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert weakscale.main([*args, "--device", "cpu", "--json",
                           str(port_path)]) == 0
    jrec, prec = (json.loads(p.read_text()) for p in (jax_path, port_path))
    jax_validate(prec)
    assert prec["meta"]["backend"] == jrec["meta"]["backend"] == "cpu"
    assert [r["name"] for r in prec["rows"]] == \
        [r["name"] for r in jrec["rows"]]
    for p, j in zip(prec["rows"], jrec["rows"]):
        assert sorted(p) == sorted(j)
        assert sorted(p["derived"]) == sorted(j["derived"])
        d = p["derived"]
        assert d["pct_of_roofline"] == round(roofline.pct_of_roofline(
            d["flips_per_ns"], d["engine"], "cpu", k=d["halo_k"]), 4)
        assert d["pct_of_roofline"] > 0


def test_weakscale_labels_its_record_by_the_device_type(tmp_path):
    """``--device cpu:0`` runs on the CPU and says so: backend "cpu", one
    device, each row's reading against the CPU row of the roofline."""
    import json

    from repro_torch.dist import weakscale
    from repro_torch.launch import roofline
    path = tmp_path / "cpu0.json"
    assert weakscale.main(["--devices", "1", "--sweeps", "1", "--trials",
                           "1", "--device", "cpu:0", "--json",
                           str(path)]) == 0
    rec = json.loads(path.read_text())
    assert rec["meta"]["backend"] == "cpu"
    assert rec["meta"]["device_count"] == 1
    for row in rec["rows"]:
        d = row["derived"]
        assert d["pct_of_roofline"] == round(roofline.pct_of_roofline(
            d["flips_per_ns"], d["engine"], "cpu", k=d["halo_k"]), 4)
