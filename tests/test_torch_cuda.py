"""The CUDA kernels against their plain versions, on the card, and
sessions on the card against the CPU.

These need an NVIDIA GPU and nvcc, and skip without one.  Run them on
the card with ``PYTHONPATH=src python -m pytest -m cuda
tests/test_torch_cuda.py``.  The kernels build at first use."""
import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.api import EngineSpec, LatticeSpec, MeshSpec, RunSpec, Session
from repro_torch.core import metropolis, multispin
from repro_torch.dist import kernels as dk
from repro_torch.dist import planner as shard_planner
from repro_torch.kernels import resident
from repro_torch.kernels.bitplane import (bitplane_sweeps_resident,
                                          bitplane_sweeps_resident_plain,
                                          bitplane_update,
                                          bitplane_update_plain)
from repro_torch.kernels.multispin import (multispin_sweeps_resident,
                                           multispin_sweeps_resident_plain,
                                           multispin_update,
                                           multispin_update_plain)
from repro_torch.kernels.stencil import (stencil_sweeps_resident,
                                         stencil_sweeps_resident_plain,
                                         stencil_update,
                                         stencil_update_plain)

pytestmark = pytest.mark.cuda

SEED = 2 ** 40 + 11

#: tensorcore blocks on (2B, 3B) planes: the multiples of 16 take the
#: tiled kernel, 8 and 24 (sides not multiples of 16) the element-wise one
TC_BLOCKS = (8, 16, 24, 32, 48, 64, 80, 96, 112, 128)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: run on the card with "
                    "'python -m pytest -m cuda tests/test_torch_cuda.py'")
    return torch.device("cuda")


def planes(n, h, seed, device):
    r = np.random.default_rng(seed)
    return tuple(torch.tensor(np.where(r.random((n, h)) < 0.5, 1, -1)
                              .astype(np.int8), device=device)
                 for _ in range(2))


@pytest.mark.parametrize("n,h", [(64, 32), (30, 7), (2, 1), (13, 3),
                                 (21, 5), (17, 127), (33, 129), (15, 130),
                                 (35, 256)])
@pytest.mark.parametrize("is_black,offset", [(True, 0), (False, 2 ** 32 - 1)])
def test_stencil_update_kernel_matches_plain(cuda, n, h, is_black, offset):
    target, op = planes(n, h, n + h, cuda)
    table = metropolis.acceptance_table(1 / 1.9)
    want = stencil_update_plain(target, op, table, is_black=is_black,
                                seed=SEED, offset=offset)
    before = stencil_update.launches
    got = stencil_update(target, op, table, is_black=is_black, seed=SEED,
                         offset=offset)
    torch.cuda.synchronize()
    assert stencil_update.launches == before + 1
    assert torch.equal(got, want)


@pytest.mark.parametrize("n,m,tile_r,tile_c,k,n_sweeps", [
    (64, 128, 128, 256, 4, 4),
    (64, 128, 16, 32, 2, 5),     # several tiles, two launches and a third
    (30, 14, 7, 3, 3, 3),        # ragged tiles, halo wider than the plane
    # plane widths around the kernel's 4-cell words and 32-word rows:
    # cell by cell (3, 5, 127, 129, 130), tiles whose width is not a
    # multiple of 4 and extended rows that are not (13 + 2 x 4)
    (12, 6, 5, 3, 1, 2),
    (20, 10, 8, 5, 2, 3),
    (16, 254, 8, 120, 2, 2),
    (10, 258, 5, 120, 1, 1),
    (16, 260, 8, 13, 3, 3),
    (16, 260, 6, 248, 2, 1),
    (48, 512, 16, 248, 2, 3),    # word loads, inner and edge tiles
])
def test_resident_kernel_matches_plain(cuda, n, m, tile_r, tile_c, k,
                                       n_sweeps):
    b, w = planes(n, m // 2, n + k, cuda)
    table = metropolis.acceptance_table(1 / 2.4)
    plan = dataclasses.replace(resident.plan_resident("stencil", n, m), k=k,
                               tile_rows=tile_r, tile_cols=tile_c)
    want = stencil_sweeps_resident_plain(b, w, table, n_sweeps=n_sweeps,
                                         seed=SEED, start_offset=2 ** 32 - 3)
    before = stencil_sweeps_resident.launches
    got = stencil_sweeps_resident(b, w, table, n_sweeps=n_sweeps, seed=SEED,
                                  start_offset=2 ** 32 - 3, plan=plan)
    torch.cuda.synchronize()
    assert stencil_sweeps_resident.launches == before - (-n_sweeps // k)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


@pytest.mark.parametrize("shard", [False, True])
def test_stencil_kernels_cold_all_up_never_flip(cuda, shard):
    """At T = 0.05 the table's -8 beta entries underflow to 0, and from
    all-up planes no draw may flip a spin (draw bound 0)."""
    n, h = 40, 132
    up = torch.ones((n, h), dtype=torch.int8, device=cuda)
    table = metropolis.acceptance_table(1 / 0.05)
    assert float(table.min()) == 0.0
    if shard:
        r = np.random.default_rng(3)
        gidx = torch.tensor(r.integers(0, 2 ** 32, (n, h), dtype=np.uint64)
                            .astype(np.uint32).view(np.int32), device=cuda)
        got = dk.stencil_shard_sweeps(up, up.clone(), table, gidx,
                                      n_sweeps=3, seed=SEED,
                                      start_offset=2 ** 32 - 3,
                                      tile=(16, 120, 256))
    else:
        plan = dataclasses.replace(
            resident.plan_resident("stencil", n, 2 * h), k=3, tile_rows=16,
            tile_cols=120)
        got = stencil_sweeps_resident(up, up.clone(), table, n_sweeps=3,
                                      seed=SEED, start_offset=2 ** 32 - 3,
                                      plan=plan)
    torch.cuda.synchronize()
    assert torch.equal(got[0], up) and torch.equal(got[1], up)


@pytest.mark.parametrize("h", [130, 256])
def test_stencil_update_cold_all_up_never_flips(cuda, h):
    up = torch.ones((35, h), dtype=torch.int8, device=cuda)
    got = stencil_update(up.clone(), up, metropolis.acceptance_table(
        1 / 0.05), is_black=True, seed=SEED, offset=5)
    torch.cuda.synchronize()
    assert torch.equal(got, up)


def test_planner_and_kernel_agree_on_shared_memory(cuda):
    from repro_torch.kernels.stencil.stencil import library
    lib = library()
    for tr, tc, k in ((128, 256, 4), (7, 3, 1), (64, 64, 8)):
        assert lib.stencil_resident_smem_bytes(tr, tc, k) == \
            resident.smem_bytes(tr, tc, k)


def test_oversized_tile_raises(cuda):
    b, w = planes(64, 32, 0, cuda)
    plan = dataclasses.replace(resident.plan_resident("stencil", 64, 64),
                               tile_rows=1024, tile_cols=1024, k=1)
    with pytest.raises(RuntimeError, match="launch failed"):
        stencil_sweeps_resident(b, w, metropolis.acceptance_table(0.5),
                                n_sweeps=1, seed=1, start_offset=0,
                                plan=plan)


@pytest.mark.parametrize("tier", ["k-sweep", "half-sweep"])
def test_session_on_card_equals_cpu(cuda, tier):
    spec = RunSpec(lattice=LatticeSpec(64, 96),
                   engine=EngineSpec("stencil_pallas"), temperature=2.1,
                   seed=SEED)
    cpu = Session.open(spec, device="cpu")
    cpu.run(7)
    card = Session.open(
        spec, resident_budget_bytes=0 if tier == "half-sweep" else None)
    assert card.device.type == "cuda"
    assert (card.engine.resident_plan is not None) == (tier == "k-sweep")
    card.run(7)
    assert card.state_digest() == cpu.state_digest()


def word_planes(n, w, seed, device, mask=0xFFFFFFFF):
    """Two random int32 word planes; ``mask`` 0x11111111 keeps multispin
    words to 0/1 nibbles."""
    r = np.random.default_rng(seed)
    return tuple(torch.tensor((r.integers(0, 2 ** 32, (n, w), dtype=np.uint64)
                               & mask).astype(np.uint32).view(np.int32),
                              device=device)
                 for _ in range(2))


NIBBLES = 0x11111111
WORD_KERNELS = {
    "multispin": (multispin_update, multispin_update_plain,
                  multispin_sweeps_resident, multispin_sweeps_resident_plain,
                  NIBBLES, 16),
    "bitplane": (bitplane_update, bitplane_update_plain,
                 bitplane_sweeps_resident, bitplane_sweeps_resident_plain,
                 0xFFFFFFFF, 2),
}


@pytest.mark.parametrize("family,n,w", [
    ("multispin", 64, 32), ("multispin", 30, 7), ("multispin", 2, 1),
    ("bitplane", 64, 128), ("bitplane", 30, 12), ("bitplane", 2, 4)])
@pytest.mark.parametrize("is_black,offset", [
    (True, 0), (False, 2 ** 31 - 1), (True, 2 ** 31), (False, 2 ** 32 - 1)])
def test_word_update_kernel_matches_plain(cuda, family, n, w, is_black,
                                          offset):
    kernel, plain, _, _, mask, _ = WORD_KERNELS[family]
    target, op = word_planes(n, w, n + w, cuda, mask)
    thr = multispin.acceptance_thresholds(1 / 2.2)
    want = plain(target, op, thr, is_black=is_black, seed=SEED,
                 offset=offset)
    before = kernel.launches
    got = kernel(target, op, thr, is_black=is_black, seed=SEED,
                 offset=offset)
    torch.cuda.synchronize()
    assert kernel.launches == before + 1
    assert torch.equal(got, want)


@pytest.mark.parametrize("family,n,w,tile_r,tile_c,k,n_sweeps", [
    ("multispin", 64, 16, 64, 64, 2, 2),
    ("multispin", 64, 32, 16, 8, 2, 5),    # several tiles, three launches
    ("multispin", 30, 3, 7, 2, 3, 3),      # ragged, halo wider than plane
    ("bitplane", 64, 64, 64, 128, 2, 2),
    ("bitplane", 64, 64, 16, 16, 2, 5),
    ("bitplane", 30, 12, 7, 8, 3, 3),      # ragged, halo wider than plane
])
def test_word_resident_kernel_matches_plain(cuda, family, n, w, tile_r,
                                            tile_c, k, n_sweeps):
    _, _, kernel, plain, mask, divisor = WORD_KERNELS[family]
    b, wp = word_planes(n, w, n + k, cuda, mask)
    thr = multispin.acceptance_thresholds(1 / 2.4)
    plan = dataclasses.replace(
        resident.plan_resident(family, n, w * divisor), k=k,
        tile_rows=tile_r, tile_cols=tile_c)
    want = plain(b, wp, thr, n_sweeps=n_sweeps, seed=SEED,
                 start_offset=2 ** 32 - 3)
    before = kernel.launches
    got = kernel(b, wp, thr, n_sweeps=n_sweeps, seed=SEED,
                 start_offset=2 ** 32 - 3, plan=plan)
    torch.cuda.synchronize()
    assert kernel.launches == before - (-n_sweeps // k)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


#: the bitplane kernels' tables by accept: the three-threshold one at
#: T = 3.0 and T = 0.05 (t4 = t8 = 0), the general one for a shuffled
#: table
BITPLANE_TABLES = {
    "three": lambda: multispin.acceptance_thresholds(1 / 3.0),
    "three-cold": lambda: multispin.acceptance_thresholds(1 / 0.05),
    "general": lambda: multispin.acceptance_thresholds(1 / 2.4)[
        torch.tensor([3, 8, 1, 0, 9, 5, 7, 2, 4, 6])],
}


def run_bitplane(kernel, accept, fn):
    """``fn()`` on the card, checking that its launches took ``accept``."""
    before = (kernel.launches, kernel.general_launches)
    out = fn()
    torch.cuda.synchronize()
    launched = kernel.launches - before[0]
    general = kernel.general_launches - before[1]
    assert launched > 0
    assert general == (launched if accept == "general" else 0)
    return out


@pytest.mark.parametrize("accept", sorted(BITPLANE_TABLES))
@pytest.mark.parametrize("n,w,tile_r,tile_c,k,n_sweeps", [
    (30, 12, 7, 8, 3, 3),       # halo wider than the plane
    (40, 52, 16, 20, 1, 2),     # ragged tiles
    (64, 64, 24, 56, 2, 3),     # tiles that do not divide the plane
    (20, 4, 6, 4, 2, 2),        # one group wide
    (100, 300, 40, 120, 2, 4),  # rows of 32 groups
])
def test_bitplane_resident_accepts_match_plain(cuda, accept, n, w, tile_r,
                                               tile_c, k, n_sweeps):
    b, wp = word_planes(n, w, n + w + k, cuda)
    thr = BITPLANE_TABLES[accept]()
    plan = dataclasses.replace(resident.plan_resident("bitplane", n, 2 * w),
                               k=k, tile_rows=tile_r, tile_cols=tile_c)
    want = bitplane_sweeps_resident_plain(b, wp, thr, n_sweeps=n_sweeps,
                                          seed=SEED, start_offset=2 ** 32 - 3)
    got = run_bitplane(bitplane_sweeps_resident, accept,
                       lambda: bitplane_sweeps_resident(
                           b, wp, thr, n_sweeps=n_sweeps, seed=SEED,
                           start_offset=2 ** 32 - 3, plan=plan))
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


@pytest.mark.parametrize("accept", sorted(BITPLANE_TABLES))
@pytest.mark.parametrize("n,w", [(64, 128), (30, 12), (2, 4)])
def test_bitplane_update_accepts_match_plain(cuda, accept, n, w):
    target, op = word_planes(n, w, n * w, cuda)
    thr = BITPLANE_TABLES[accept]()
    want = bitplane_update_plain(target, op, thr, is_black=False, seed=SEED,
                                 offset=2 ** 32 - 1)
    got = run_bitplane(bitplane_update, accept, lambda: bitplane_update(
        target.clone(), op, thr, is_black=False, seed=SEED,
        offset=2 ** 32 - 1))
    assert torch.equal(got, want)


@pytest.mark.parametrize("shard", [False, True])
def test_bitplane_kernels_cold_all_up_never_flip(cuda, shard):
    """At T = 0.05 t8 is 0: from all-up planes (every site of every
    replica up with 4 up neighbours) no draw may flip a spin."""
    n, w = 40, 44
    up = torch.full((n, w), -1, dtype=torch.int32, device=cuda)
    thr = BITPLANE_TABLES["three-cold"]()
    if shard:
        index = shard_inputs("bitplane", n, w, 3, cuda)[3]
        got = dk.bitplane_shard_sweeps(up, up.clone(), thr, *index,
                                       n_sweeps=3, seed=SEED,
                                       start_offset=2 ** 32 - 3,
                                       tile=(16, 12, 64))
    else:
        plan = dataclasses.replace(
            resident.plan_resident("bitplane", n, 2 * w), k=3,
            tile_rows=16, tile_cols=12)
        got = bitplane_sweeps_resident(up, up.clone(), thr, n_sweeps=3,
                                       seed=SEED, start_offset=2 ** 32 - 3,
                                       plan=plan)
    torch.cuda.synchronize()
    assert torch.equal(got[0], up) and torch.equal(got[1], up)


#: the multispin k-sweep kernel's geometry: word widths 1, 3, 31, 33 and
#: 129, tiles whose width is not a multiple of 4 or of a warp, a halo
#: wider than the plane, n_sweeps 1 to 3, offsets near 2^31 and 2^32, 16-
#: byte loads on inner tiles and word loads on edge tiles:
#: (rows, words, tile rows, tile words, k, n_sweeps, start offset)
MULTISPIN_EDGE_CASES = [
    (12, 1, 5, 1, 1, 2, 2 ** 31 - 2),
    (20, 3, 8, 3, 2, 3, 2 ** 32 - 3),
    (16, 31, 8, 12, 2, 2, 2 ** 31 - 1),
    (10, 33, 5, 33, 1, 1, 2 ** 32 - 1),
    (16, 129, 8, 120, 3, 3, 2 ** 32 - 3),
    (48, 256, 16, 120, 2, 3, 2 ** 31 - 2),
]


@pytest.mark.parametrize("case", MULTISPIN_EDGE_CASES)
@pytest.mark.parametrize("seed", [2 ** 33 + 5, SEED])
def test_multispin_resident_kernel_edge_cases(cuda, case, seed):
    n, w, tile_r, tile_c, k, n_sweeps, start = case
    b, wp = word_planes(n, w, n + w + k, cuda, NIBBLES)
    thr = multispin.acceptance_thresholds(1 / 2.2)
    plan = dataclasses.replace(
        resident.plan_resident("multispin", n, 16 * w), k=k,
        tile_rows=tile_r, tile_cols=tile_c)
    want = multispin_sweeps_resident_plain(b, wp, thr, n_sweeps=n_sweeps,
                                           seed=seed, start_offset=start)
    got = multispin_sweeps_resident(b, wp, thr, n_sweeps=n_sweeps,
                                    seed=seed, start_offset=start, plan=plan)
    torch.cuda.synchronize()
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


@pytest.mark.parametrize("shard", [False, True])
def test_multispin_kernels_cold_all_up_never_flip(cuda, shard):
    """At T = 0.05 an up spin's flip against 3 or 4 up neighbours has a
    threshold of 0, and from all-up planes no draw may flip a spin."""
    n, w = 40, 20
    up = torch.full((n, w), NIBBLES, dtype=torch.int32, device=cuda)
    thr = multispin.acceptance_thresholds(1 / 0.05)
    assert int(thr[8]) == int(thr[9]) == 0
    if shard:
        index = shard_inputs("multispin", n, w, 3, cuda)[3]
        got = dk.multispin_shard_sweeps(up, up.clone(), thr, *index,
                                        n_sweeps=3, seed=SEED,
                                        start_offset=2 ** 32 - 3,
                                        tile=(16, 12, 64))
    else:
        plan = dataclasses.replace(
            resident.plan_resident("multispin", n, 16 * w), k=3,
            tile_rows=16, tile_cols=12)
        got = multispin_sweeps_resident(up, up.clone(), thr, n_sweeps=3,
                                        seed=SEED, start_offset=2 ** 32 - 3,
                                        plan=plan)
    torch.cuda.synchronize()
    assert torch.equal(got[0], up) and torch.equal(got[1], up)


@pytest.mark.parametrize("family", ["multispin", "bitplane"])
def test_word_planner_and_kernel_agree_on_shared_memory(cuda, family):
    import importlib
    lib = importlib.import_module(
        f"repro_torch.kernels.{family}.{family}").library()
    query = getattr(lib, f"{family}_resident_smem_bytes")
    for tr, tc, k in ((64, 128, 2), (7, 8, 1), (64, 64, 3)):
        assert query(tr, tc, k) == resident.smem_bytes(tr, tc, k, family)


@pytest.mark.parametrize("engine", ["multispin_pallas", "bitplane_pallas"])
@pytest.mark.parametrize("tier", ["k-sweep", "half-sweep"])
def test_word_session_on_card_equals_cpu(cuda, engine, tier):
    spec = RunSpec(lattice=LatticeSpec(64, 96), engine=EngineSpec(engine),
                   temperature=2.1, seed=SEED)
    cpu = Session.open(spec, device="cpu")
    cpu.run(7)
    card = Session.open(
        spec, resident_budget_bytes=0 if tier == "half-sweep" else None)
    assert card.device.type == "cuda"
    assert (card.engine.resident_plan is not None) == (tier == "k-sweep")
    card.run(7)
    assert card.state_digest() == cpu.state_digest()


def tc_planes(n, dtype, seed, device, w=None, p_up=0.5):
    """The four (n, w or n) sublattice planes of a random lattice whose
    spins are up with probability ``p_up``."""
    from repro_torch.core import tensorcore as tc
    r = np.random.default_rng(seed)
    full = torch.tensor(np.where(r.random((2 * n, 2 * (w or n))) < p_up,
                                 1, -1).astype(np.int8))
    return {k: v.to(dtype).to(device) for k, v in tc.decompose(full).items()}


def tc_kernel_matches_plain(planes, color, inv_temp, block):
    from repro_torch.kernels.tensorcore import (tensorcore_update,
                                                tensorcore_update_plain)
    want = tensorcore_update_plain(planes, color, inv_temp, seed=SEED,
                                   offset=2 ** 32 - 1, block=block)
    before = tensorcore_update.launches
    got = tensorcore_update(planes, color, inv_temp, seed=SEED,
                            offset=2 ** 32 - 1, block=block)
    torch.cuda.synchronize()
    assert tensorcore_update.launches == before + 1
    for k in want:
        assert got[k].dtype == want[k].dtype
        assert torch.equal(got[k], want[k]), k
    return want


@pytest.mark.parametrize("n,w,block", [(64, None, 16), (128, None, 64),
                                       (256, None, 128), (384, None, 128)]
                         + [(2 * b, 3 * b, b) for b in TC_BLOCKS])
@pytest.mark.parametrize("color", ["black", "white"])
@pytest.mark.parametrize("dtype", [torch.int8, torch.bfloat16])
def test_tensorcore_kernel_matches_plain(cuda, n, w, block, color, dtype):
    tc_kernel_matches_plain(tc_planes(n, dtype, n + block, cuda, w), color,
                            1 / 2.0, block)


@pytest.mark.parametrize("temperature", [0.05, 0.02])
@pytest.mark.parametrize("block", TC_BLOCKS)
@pytest.mark.parametrize("color", ["black", "white"])
@pytest.mark.parametrize("dtype", [torch.int8, torch.bfloat16])
def test_tensorcore_kernel_matches_plain_where_the_table_is_zero(
        cuda, temperature, block, color, dtype):
    """At these temperatures the -8 beta entries of the float32 table
    are exactly 0: from a nearly all-up start almost no spin may flip,
    and a spin with four aligned neighbours never does."""
    assert (metropolis.acceptance_table(1 / temperature) == 0).any()
    planes = tc_planes(2 * block, dtype, block, cuda, 3 * block, p_up=0.99)
    before = {k: v.clone() for k, v in planes.items()}
    after = tc_kernel_matches_plain(planes, color, 1 / temperature, block)
    flipped = sum(int((after[k] != before[k]).sum()) for k in after)
    assert flipped < 0.05 * sum(v.numel() for v in after.values())


#: planes whose largest dividing tile (64, 32, 16 rows; 128, 64, 32, 16
#: columns) is each tile the kernel takes
TC_TILE_PLANES = {(r, c): (h, w)
                  for r, h in ((64, 128), (32, 96), (16, 80))
                  for c, w in ((128, 256), (64, 192), (32, 160), (16, 144))}


@pytest.mark.parametrize("tile", [(64, 128), (64, 64), (64, 32), (64, 16),
                                  (32, 128), (32, 64), (32, 32), (32, 16),
                                  (16, 128), (16, 64), (16, 32), (16, 16)])
@pytest.mark.parametrize("dtype", [torch.int8, torch.bfloat16])
def test_tensorcore_kernel_tiles_match_plain(cuda, tile, dtype):
    """Every tile the kernel takes gives the plain version's planes: the
    sums are exact whatever the tile.  The kernel takes the largest tile
    that divides the planes, so each tile has planes of its own."""
    from repro_torch.kernels.tensorcore import (tensorcore_update,
                                                tensorcore_update_plain)
    from repro_torch.kernels.tensorcore.tensorcore import kernel_geometry
    h, w = TC_TILE_PLANES[tile]
    geo = kernel_geometry(h, w, dtype)
    assert (geo["tile_rows"], geo["tile_cols"]) == tile
    planes = tc_planes(h, dtype, tile[0] + tile[1], cuda, w)
    want = tensorcore_update_plain(planes, "white", 1 / 2.0, seed=SEED,
                                   offset=5, block=16)
    got = tensorcore_update({k: v.clone() for k, v in planes.items()},
                            "white", 1 / 2.0, seed=SEED, offset=5, block=16)
    torch.cuda.synchronize()
    for k in want:
        assert torch.equal(got[k], want[k]), k


@pytest.mark.parametrize("color", ["black", "white"])
def test_tensorcore_kernel_persistent_grid_with_a_tile_over(cuda, color):
    """Planes of one tile more than a multiple of the persistent grid's
    blocks: the blocks' last round is ragged."""
    from repro_torch.kernels.tensorcore.tensorcore import kernel_geometry
    h, w = 320, 6784
    geo = kernel_geometry(h, w)
    assert geo["tiles"] > geo["blocks"] and geo["tiles"] % geo["blocks"]
    tc_kernel_matches_plain(tc_planes(h, torch.int8, 3, cuda, w), color,
                            1 / 2.0, 64)


@pytest.mark.parametrize("color", ["black", "white"])
@pytest.mark.parametrize("dtype", [torch.int8, torch.bfloat16])
def test_tensorcore_kernel_hot_table_flips_nearly_all(cuda, color, dtype):
    """At inverse temperature 0 every entry is 1: every draw but the top
    2^-25 flips, at block 128 on a 512^2 lattice."""
    planes = tc_planes(256, dtype, 9, cuda)
    before = {k: v.clone() for k, v in planes.items()}
    after = tc_kernel_matches_plain(planes, color, 0.0, 128)
    flipped = sum(int((after[k] != before[k]).sum()) for k in after)
    assert flipped > 0.999 * 2 * 256 * 256


def test_tensorcore_kernel_rejects_block_8(cuda):
    """A block of 8 where it does not tile the planes (12 x 12); where it
    does, the card takes it (below), as the JAX engine does."""
    from repro_torch.kernels.tensorcore import tensorcore_update
    planes = tc_planes(12, torch.int8, 0, cuda)
    before = tensorcore_update.launches
    with pytest.raises(ValueError, match="block"):
        tensorcore_update(planes, "black", 0.5, block=8)
    assert tensorcore_update.launches == before
    with pytest.raises(ValueError, match="block"):
        Session.open(RunSpec(lattice=LatticeSpec(24, 24),
                             engine=EngineSpec("tensorcore",
                                               {"tc_block": 8})))


@pytest.mark.parametrize("n,block", [(64, 8), (48, 24), (48, 8), (64, 32)])
def test_tensorcore_session_at_jax_blocks_on_card_equals_cpu(cuda, n, block):
    """Every block the JAX engine takes runs on the card with the CPU's
    trajectory: 8 (the JAX quickstart's) on 64^2, 24 and 8 on 48^2, whose
    24 x 24 planes take the element-wise kernel."""
    from repro_torch.kernels.tensorcore import tensorcore_update
    spec = RunSpec(lattice=LatticeSpec(n, n),
                   engine=EngineSpec("tensorcore", {"tc_block": block}),
                   temperature=2.2, seed=SEED)
    cpu = Session.open(spec, device="cpu")
    cpu.run(10)
    before = tensorcore_update.launches
    card = Session.open(spec)
    card.run(10)
    assert tensorcore_update.launches == before + 20
    assert card.state_digest() == cpu.state_digest()


def test_tensorcore_session_on_card_equals_cpu(cuda):
    spec = RunSpec(lattice=LatticeSpec(128, 256),
                   engine=EngineSpec("tensorcore", {"tc_block": 32}),
                   temperature=2.1, seed=SEED)
    cpu = Session.open(spec, device="cpu")
    cpu.run(7)
    card = Session.open(spec)
    assert card.device.type == "cuda"
    card.run(7)
    assert card.state_digest() == cpu.state_digest()


def test_tensorcore_cold_ordered_session_on_card_equals_cpu(cuda):
    """From an ordered start at T = 0.05 (a table with exact zeros) the
    card and the CPU give one trajectory, and it stays ordered."""
    spec = RunSpec(lattice=LatticeSpec(128, 192, init_p_up=1.0),
                   engine=EngineSpec("tensorcore", {"tc_block": 32}),
                   temperature=0.05, seed=SEED)
    cpu = Session.open(spec, device="cpu")
    cpu.run(5)
    card = Session.open(spec)
    card.run(5)
    assert card.state_digest() == cpu.state_digest()
    assert abs(card.magnetization()) > 0.99


# -- the sharded tier -------------------------------------------------------

SHARD_KERNELS = {"stencil": (dk.stencil_shard_sweeps,
                             dk.stencil_shard_sweeps_plain),
                 "multispin": (dk.multispin_shard_sweeps,
                               dk.multispin_shard_sweeps_plain),
                 "bitplane": (dk.bitplane_shard_sweeps,
                              dk.bitplane_shard_sweeps_plain)}


def shard_inputs(family, n, w, seed, device):
    """Random extended planes, their table, and random index planes
    (lanes 0..5: 4 and 5 take lane 3)."""
    r = np.random.default_rng(seed)
    if family == "stencil":
        b, w_ = planes(n, w, seed, device)
        table = metropolis.acceptance_table(1 / 2.3)
    else:
        b, w_ = word_planes(n, w, seed, device,
                            NIBBLES if family == "multispin" else 0xFFFFFFFF)
        table = multispin.acceptance_thresholds(1 / 2.3)
    index = [torch.tensor(r.integers(0, 2 ** 32, (n, w), dtype=np.uint64)
                          .astype(np.uint32).view(np.int32), device=device)]
    if family == "bitplane":
        index.append(torch.tensor(r.integers(0, 6, (n, w)).astype(np.int32),
                                  device=device))
    return b, w_, table, index


SHARD_CASES = [
    (14, 10, 1, None),
    (14, 10, 3, None),            # the halo wraps over the whole plane
    (40, 36, 2, (16, 8, 128)),    # several ragged tiles
    (70, 200, 3, (24, 40, 512)),
]
#: the stencil kernel's 4-cell words: extended widths 3, 5, 127, 129 and
#: 130, tiles whose width is not a multiple of 4, word loads
STENCIL_SHARD_CASES = [
    (12, 3, 1, (6, 3, 64)),
    (14, 5, 2, (6, 5, 64)),
    (10, 127, 2, (8, 120, 256)),
    (10, 129, 1, (5, 120, 64)),
    (16, 130, 3, (8, 13, 96)),
    (40, 512, 2, (16, 248, 256)),
]


#: the multispin shard kernel's: extended widths 3, 5, 33 and 129, tiles
#: whose width is not a multiple of 4, 16-byte loads
MULTISPIN_SHARD_CASES = [
    (12, 3, 1, (6, 3, 64)),
    (14, 5, 2, (6, 5, 64)),
    (10, 129, 1, (5, 120, 64)),
    (16, 33, 3, (8, 13, 96)),
    (40, 512, 2, (16, 120, 256)),
]


@pytest.mark.parametrize("family,n,w,n_sweeps,tile", [
    (family, *case) for case in SHARD_CASES
    for family in sorted(SHARD_KERNELS)] + [
    ("stencil", *case) for case in STENCIL_SHARD_CASES] + [
    ("multispin", *case) for case in MULTISPIN_SHARD_CASES])
def test_shard_kernel_matches_plain(cuda, family, n, w, n_sweeps, tile):
    """The whole extended plane, edge rings included, with random index
    planes."""
    kernel, plain = SHARD_KERNELS[family]
    b, w_, table, index = shard_inputs(family, n, w, n + w + n_sweeps, cuda)
    want = plain(b, w_, table, *index, n_sweeps=n_sweeps, seed=SEED,
                 start_offset=2 ** 32 - 3)
    before = kernel.launches
    got = kernel(b, w_, table, *index, n_sweeps=n_sweeps, seed=SEED,
                 start_offset=2 ** 32 - 3, tile=tile)
    torch.cuda.synchronize()
    assert kernel.launches == before + 1
    for g, x in zip(got, want):
        assert torch.equal(g, x)


def mixed_groups(n, w):
    """Bitplane index planes of 4-word Philox groups (lanes 0..3), some
    broken: a lane past 3, a group of two gidx, lanes out of order."""
    cols = np.arange(w)
    g = np.arange(n)[:, None] * 1000 + cols[None, :] // 4
    lane = np.broadcast_to(cols % 4, (n, w)).copy()
    lane[3, 8], g[5, 13] = 7, g[5, 13] + 1
    lane[9, 20:24] = [1, 0, 2, 3]
    return g.astype(np.int32), lane.astype(np.int32)


@pytest.mark.parametrize("case", ["width-41", "width-7", "mixed",
                                  "driver-1", "driver-2", "driver-3"])
def test_bitplane_shard_kernel_groups_match_plain(cuda, case):
    """The bitplane shard kernel draws once per group where a group is one
    Philox group and per word elsewhere: extended widths that are not
    whole groups, planes with broken groups, and the driver's own planes
    at k = 1, 2, 3 (whole groups at k = 2 only)."""
    r = np.random.default_rng(len(case))
    if case.startswith("driver"):
        from repro_torch.core.distributed import ShardGrid
        from repro_torch.dist.driver import index_planes
        from repro_torch.launch.mesh import make_mesh
        k = int(case[-1])
        plan = shard_planner.plan_shard_resident(
            "bitplane", 512, 512, 2, 2, k_cap=k, max_overlap=100.0)
        grid = ShardGrid.of(make_mesh((2, 2), ("data", "model")), 512, 256)
        # shard 1's planes, on the card of this test's other inputs (on a
        # host of several cards the mesh puts shard 1 on another)
        index = [t.to(cuda) for t in index_planes(plan, grid, 1)]
        n, w = index[0].shape
        tile = (plan.tile_rows, plan.tile_cols, plan.threads)
    else:
        n, w, k, tile = {"width-41": (30, 41, 2, (12, 20, 64)),
                         "width-7": (22, 7, 3, (8, 4, 128)),
                         "mixed": (40, 72, 2, (16, 16, 256))}[case]
        if case == "mixed":
            index = [torch.tensor(a, device=cuda) for a in mixed_groups(n, w)]
        else:
            index = shard_inputs("bitplane", n, w, n + w, cuda)[3]
    b, w_ = word_planes(n, w, n * w, cuda)
    table = multispin.acceptance_thresholds(1 / 2.3)
    want = dk.bitplane_shard_sweeps_plain(b, w_, table, *index, n_sweeps=k,
                                          seed=SEED, start_offset=2 ** 32 - 3)
    got = dk.bitplane_shard_sweeps(b, w_, table, *index, n_sweeps=k,
                                   seed=SEED, start_offset=2 ** 32 - 3,
                                   tile=tile)
    torch.cuda.synchronize()
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


@pytest.mark.parametrize("accept", sorted(BITPLANE_TABLES))
@pytest.mark.parametrize("case", ["width-41", "mixed", "rows-of-32"])
def test_bitplane_shard_accepts_match_plain(cuda, accept, case):
    n, w, k, tile = {"width-41": (30, 41, 2, (12, 20, 64)),
                     "mixed": (40, 72, 2, (16, 16, 256)),
                     "rows-of-32": (40, 136, 1, (16, 120, 256))}[case]
    if case == "mixed":
        index = [torch.tensor(a, device=cuda) for a in mixed_groups(n, w)]
    else:
        index = shard_inputs("bitplane", n, w, n + w, cuda)[3]
    b, w_ = word_planes(n, w, n * w + k, cuda)
    thr = BITPLANE_TABLES[accept]()
    want = dk.bitplane_shard_sweeps_plain(b, w_, thr, *index, n_sweeps=k,
                                          seed=SEED, start_offset=2 ** 32 - 3)
    got = run_bitplane(dk.bitplane_shard_sweeps, accept,
                       lambda: dk.bitplane_shard_sweeps(
                           b, w_, thr, *index, n_sweeps=k, seed=SEED,
                           start_offset=2 ** 32 - 3, tile=tile))
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


@pytest.mark.parametrize("family", sorted(SHARD_KERNELS))
def test_shard_planner_and_kernel_agree_on_shared_memory(cuda, family):
    lib = dk.library(family)
    query = getattr(lib, f"{family}_shard_smem_bytes")
    for tr, tc, k in ((128, 256, 2), (96, 128, 2), (7, 8, 3)):
        assert query(tr, tc, k) == shard_planner.shard_smem_bytes(
            family, tr, tc, k)


@pytest.mark.parametrize("engine", ["stencil_pallas", "multispin_pallas",
                                    "bitplane_pallas", "multispin",
                                    "bitplane"])
def test_sharded_session_on_card_equals_cpu(cuda, engine):
    """2 x 2 shards on the card (the resident tier for the ``_pallas``
    engines, the per-half-sweep step for the others): the CPU's digest,
    and the single-mode card digest."""
    m = 1024 if engine.startswith("multispin") else 128
    spec = RunSpec(lattice=LatticeSpec(64, m), engine=EngineSpec(engine),
                   temperature=2.1, seed=SEED,
                   mesh=MeshSpec((2, 2), ("data", "model")))
    cpu = Session.open(spec, device="cpu")
    cpu.run(5)
    card = Session.open(spec)
    assert card.device.type == "cuda"
    assert (card.shard_plan is not None) == engine.endswith("_pallas")
    card.run(5)
    assert card.state_digest() == cpu.state_digest()
    single = Session.open(dataclasses.replace(spec, mesh=None))
    single.run(5)
    assert single.state_digest() == cpu.state_digest()


# -- ensembles: the six kernels' member axis ---------------------------------

ENSEMBLE_TEMPS = (2.0, 2.5, 3.0)
ENSEMBLE_SEEDS = (7, 2 ** 31 + 11, 2 ** 32 - 1)


def member_batch(family, n, w, seed, device):
    if family == "stencil":
        return tuple(torch.stack(p) for p in zip(
            *(planes(n, w, seed + i, device) for i in range(3))))
    mask = 0x11111111 if family == "multispin" else 0xFFFFFFFF
    return tuple(torch.stack(p) for p in zip(
        *(word_planes(n, w, seed + i, device, mask) for i in range(3))))


def member_tables(family, accept):
    make = metropolis.acceptance_table if family == "stencil" \
        else multispin.acceptance_thresholds
    tables = [make(1.0 / t) for t in ENSEMBLE_TEMPS]
    if accept == "general":
        tables[0] = tables[0][torch.tensor((3, 8, 1, 0, 9, 5, 7, 2, 4, 6))]
    return tables


@pytest.mark.parametrize("family,accept", [
    ("stencil", "three"), ("multispin", "three"), ("bitplane", "three"),
    ("bitplane", "general")])
@pytest.mark.parametrize("n,w,tile_r,tile_c,k,n_sweeps", [
    (64, 32, 16, 8, 1, 1), (30, 12, 7, 8, 3, 3), (40, 52, 16, 20, 2, 2)])
def test_member_axis_matches_plain(cuda, family, accept, n, w, tile_r,
                                   tile_c, k, n_sweeps):
    """B = 3 members of distinct temperatures and seeds in one launch of
    each kernel against the plain batched version; a tile grid that does
    not divide the planes."""
    import importlib
    pkg = importlib.import_module(f"repro_torch.kernels.{family}")
    tables = member_tables(family, accept)
    b, wp = member_batch(family, n, w, n + w, cuda)
    want = getattr(pkg, f"{family}_update_batched_plain")(
        b, wp, tables, is_black=False, seeds=ENSEMBLE_SEEDS,
        offset=2 ** 32 - 1)
    update = getattr(pkg, f"{family}_update")
    before = update.launches
    got = getattr(pkg, f"{family}_update_batched")(
        b.clone(), wp, tables, is_black=False, seeds=ENSEMBLE_SEEDS,
        offset=2 ** 32 - 1)
    torch.cuda.synchronize()
    assert update.launches - before == 1
    assert torch.equal(got, want)
    divisor = resident.GEOMETRY[family].col_divisor
    plan = dataclasses.replace(resident.plan_resident(family, n, w * divisor),
                               n=n, m=w * divisor, k=k, tile_rows=tile_r,
                               tile_cols=tile_c)
    want = getattr(pkg, f"{family}_sweeps_resident_batched_plain")(
        b, wp, tables, n_sweeps=n_sweeps, seeds=ENSEMBLE_SEEDS,
        start_offset=2 ** 32 - 3)
    sweeps = getattr(pkg, f"{family}_sweeps_resident")
    before = (sweeps.launches, getattr(sweeps, "general_launches", 0))
    got = getattr(pkg, f"{family}_sweeps_resident_batched")(
        b, wp, tables, n_sweeps=n_sweeps, seeds=ENSEMBLE_SEEDS,
        start_offset=2 ** 32 - 3, plan=plan)
    torch.cuda.synchronize()
    blocks = -(-n_sweeps // k)
    assert sweeps.launches - before[0] == blocks
    assert getattr(sweeps, "general_launches", 0) - before[1] == (
        blocks if accept == "general" else 0)
    for a, c in zip(got, want):
        assert torch.equal(a, c)


@pytest.mark.parametrize("family,accept", [
    ("stencil", "three"), ("multispin", "three"), ("bitplane", "three"),
    ("bitplane", "general")])
def test_member_axis_over_the_launch_limit(cuda, family, accept):
    """One member over the library's limit: each block of sweeps (and each
    half-sweep) takes ceil(B / limit) = 2 launches, the second of one
    member (the single-member instance), and agrees with the plain
    batched version."""
    import importlib
    pkg = importlib.import_module(f"repro_torch.kernels.{family}")
    lib = importlib.import_module(
        f"repro_torch.kernels.{family}.{family}").library()
    members = getattr(lib, f"{family}_max_members")() + 1
    three = member_tables(family, accept)
    tables = [three[i % 3] for i in range(members)]
    tables[-1] = three[0]
    seeds = ENSEMBLE_SEEDS + tuple(range(100, 97 + members))
    n, w = 30, 12
    b, wp = (torch.stack(p) for p in zip(*(
        member_batch(family, n, w, n + 3 * i, cuda) for i in
        range(-(-members // 3)))))
    b, wp = (p.reshape(-1, n, w)[:members].contiguous() for p in (b, wp))
    want = getattr(pkg, f"{family}_update_batched_plain")(
        b, wp, tables, is_black=True, seeds=seeds, offset=5)
    update = getattr(pkg, f"{family}_update")
    before = update.launches
    got = getattr(pkg, f"{family}_update_batched")(
        b.clone(), wp, tables, is_black=True, seeds=seeds, offset=5)
    torch.cuda.synchronize()
    assert update.launches - before == 2
    assert torch.equal(got, want)
    divisor = resident.GEOMETRY[family].col_divisor
    plan = dataclasses.replace(resident.plan_resident(family, n, w * divisor),
                               n=n, m=w * divisor, k=3, tile_rows=7,
                               tile_cols=8)
    want = getattr(pkg, f"{family}_sweeps_resident_batched_plain")(
        b, wp, tables, n_sweeps=5, seeds=seeds, start_offset=2 ** 32 - 3)
    sweeps = getattr(pkg, f"{family}_sweeps_resident")
    before = (sweeps.launches, getattr(sweeps, "general_launches", 0))
    got = getattr(pkg, f"{family}_sweeps_resident_batched")(
        b, wp, tables, n_sweeps=5, seeds=seeds, start_offset=2 ** 32 - 3,
        plan=plan)
    torch.cuda.synchronize()
    assert sweeps.launches - before[0] == 4
    assert getattr(sweeps, "general_launches", 0) - before[1] == (
        4 if accept == "general" else 0)
    for a, c in zip(got, want):
        assert torch.equal(a, c)


@pytest.mark.parametrize("engine", ["stencil_pallas", "multispin",
                                    "multispin_pallas", "bitplane",
                                    "bitplane_pallas"])
@pytest.mark.parametrize("tier", ["k-sweep", "half-sweep"])
def test_ensemble_session_on_card_equals_cpu(cuda, engine, tier):
    """Every member's digest on the card is the CPU's, each block of
    sweeps one launch of the member axis."""
    import importlib
    from repro_torch.api import BatchSpec
    spec = RunSpec(lattice=LatticeSpec(64, 96), engine=EngineSpec(engine),
                   batch=BatchSpec(ENSEMBLE_TEMPS, ENSEMBLE_SEEDS))
    cpu = Session.open(spec, device="cpu")
    cpu.run(5)
    card = Session.open(
        spec, resident_budget_bytes=0 if tier == "half-sweep" else None)
    family = engine.split("_")[0]
    pkg = importlib.import_module(f"repro_torch.kernels.{family}")
    name = f"{family}_sweeps_resident" if tier == "k-sweep" \
        else f"{family}_update"
    before = getattr(pkg, name).launches
    card.run(5)
    torch.cuda.synchronize()
    blocks = -(-5 // card.engine.resident_plan.k) if tier == "k-sweep" \
        else 10
    assert getattr(pkg, name).launches - before == blocks
    for i in range(3):
        assert card.state_digest(member=i) == cpu.state_digest(member=i)


# -- the measured trajectory: a sample's observables one captured graph -----

GRAPH_PLAN = dict(thermalize=3, measure_every=3, n_measure=5)


def graph_and_loop(spec, budget):
    """A session's ``measure()`` (the graph) and the same plan as the loop
    of launches on the card, each from 2 sweeps in: their trajectories
    and final digests, and the graph replays of the ``measure()``: one a
    sample after the first."""
    from repro_torch.analysis import measure
    graph = Session.open(spec, resident_budget_bytes=budget)
    loop = Session.open(spec, resident_budget_bytes=budget)
    for s in (graph, loop):
        s.run(2)
    before = measure.DISPATCHES
    got = graph.measure()
    replays = measure.DISPATCHES - before
    runner, plan = loop._runner, spec.sweep.plan()
    if spec.batch is None:
        runner.state, want, runner.step_count = measure.measure_scan(
            runner.engine, runner.state, plan, runner.step_count, loop=True)
    else:
        runner.state, want, runner.step_count = measure.measure_scan_batched(
            runner.engine, runner.state, runner.inv_temps, runner.seeds,
            plan, runner.step_count, loop=True)
    assert measure.DISPATCHES - before == replays
    return got, want, graph, loop, replays


@pytest.mark.parametrize("engine", ["stencil_pallas", "multispin",
                                    "multispin_pallas", "bitplane",
                                    "bitplane_pallas"])
@pytest.mark.parametrize("tier", ["k-sweep", "half-sweep"])
@pytest.mark.parametrize("mode", ["single", "ensemble"])
def test_graph_trajectory_equals_loop(cuda, engine, tier, mode):
    """The graph's samples and final digest equal the loop's bit for bit,
    and the CPU's; one replay a sample after the first."""
    from repro_torch.api import BatchSpec, SweepSpec
    spec = RunSpec(lattice=LatticeSpec(64, 96, init_p_up=0.5),
                   engine=EngineSpec(engine), temperature=2.3,
                   seed=2 ** 33 + 5, sweep=SweepSpec(**GRAPH_PLAN),
                   batch=BatchSpec(ENSEMBLE_TEMPS, ENSEMBLE_SEEDS)
                   if mode == "ensemble" else None)
    got, want, graph, loop, replays = graph_and_loop(
        spec, 0 if tier == "half-sweep" else None)
    assert replays == GRAPH_PLAN["n_measure"] - 1
    assert sorted(got) == sorted(want) == ["e", "m"]
    for k in got:
        np.testing.assert_array_equal(got[k], want[k])
    cpu = Session.open(spec, device="cpu")
    cpu.run(2)
    on_cpu = cpu.measure()
    for k in got:
        np.testing.assert_array_equal(got[k], on_cpu[k])
    assert graph.state_digest() == loop.state_digest() == cpu.state_digest()


def test_graph_trajectory_at_the_figure_shape(cuda):
    """The figure's 13 members of 64^2 (multispin), 2 samples 4 sweeps
    apart after 6: graph and loop agree, the second sample one replay."""
    from repro_torch.analysis.figures import TEMPS, size_spec
    from repro_torch.api import SweepSpec
    spec = size_spec(64, TEMPS, SweepSpec(thermalize=6, measure_every=4,
                                          n_measure=2), "multispin", 1101)
    got, want, graph, loop, replays = graph_and_loop(spec, None)
    assert replays == 1 and got["m"].shape == (2, 13)
    for k in got:
        np.testing.assert_array_equal(got[k], want[k])
    assert graph.state_digest() == loop.state_digest()


def test_tensorcore_measure_keeps_its_loop(cuda):
    """``tensorcore`` is not counter-based: no graph, no replay."""
    from repro_torch.analysis import measure
    from repro_torch.api import SweepSpec
    spec = RunSpec(lattice=LatticeSpec(128, 128, init_p_up=1.0),
                   engine=EngineSpec("tensorcore", {"tc_block": 64}),
                   sweep=SweepSpec(measure_every=2, n_measure=3))
    before = measure.DISPATCHES
    got = Session.open(spec).measure()
    assert measure.DISPATCHES == before and got["m"].shape == (3,)


def test_graph_capture_failure_raises(cuda, monkeypatch):
    """An observable that reads a device value on the host cannot be
    captured: measure() raises, replays nothing and does not fall back
    to the loop (the first sample's observables, outside the graph, read
    it once)."""
    from repro_torch.analysis import measure
    from repro_torch.api import SweepSpec
    spec = RunSpec(lattice=LatticeSpec(64, 64, init_p_up=1.0),
                   engine=EngineSpec("multispin"),
                   sweep=SweepSpec(measure_every=2, n_measure=3))
    session = Session.open(spec)
    engine = session.engine
    real = engine.observables_batched
    calls = []

    def host_read(states, inv_temps):
        out = real(states, inv_temps)
        calls.append(float(out["m"][0].item()))
        return out

    monkeypatch.setattr(engine, "observables_batched", host_read)
    before = measure.DISPATCHES
    with pytest.raises(RuntimeError):
        session.measure()
    assert measure.DISPATCHES == before
    assert len(calls) == 1          # the first sample's; the capture failed
    torch.cuda.synchronize()


# -- bitplane_counts: the counts of the bitplane observables -----------------

def count_planes(members, n, w, pattern, device):
    """``(members, n, w)`` black and white int32 word planes: random
    words, or all ones on the first and last row and column of one plane
    (``edges-black``, ``edges-white``) against zeros elsewhere, which a
    wrong wrap or a wrong row parity of the side tap miscounts."""
    if pattern == "random":
        gen = torch.Generator(device=device).manual_seed(members * n + w)
        return tuple((torch.randint(0, 2 ** 32, (members, n, w),
                                    generator=gen, device=device)
                      - 2 ** 31).to(torch.int32) for _ in range(2))
    planes = [torch.zeros((members, n, w), dtype=torch.int32, device=device)
              for _ in range(2)]
    edged = planes[0 if pattern == "edges-black" else 1]
    edged[:, 0] = edged[:, -1] = -1
    edged[:, :, 0] = edged[:, :, -1] = -1
    return tuple(planes)


#: (rows, words): 2 rows; a width of one 4-word group; widths that are not
#: a multiple of a warp's 128-word strip; an odd row count
COUNT_SHAPES = ((2, 4), (64, 4), (30, 132), (17, 200), (96, 256))


@pytest.mark.parametrize("members,n,w,pattern", [
    (members, n, w, pattern) for members in (1, 3) for n, w in COUNT_SHAPES
    for pattern in ("random", "edges-black", "edges-white")] + [
    (1, 16384, 8192, "random"),     # the sample cell's planes
    (8, 4096, 8192, "random"),      # runs longer than a counter's flush
])
def test_bitplane_counts_kernel_matches_plain(cuda, members, n, w, pattern):
    """The kernel's ``(B, 2, 32)`` counts (``(2, 32)`` for one plane pair)
    equal the plain version's bit for bit, one launch a call."""
    from repro_torch.kernels.bitplane.counts import (bitplane_counts,
                                                     bitplane_counts_plain)
    black, white = count_planes(members, n, w, pattern, cuda)
    if members == 1:
        black, white = black[0], white[0]
    want = bitplane_counts_plain(black, white)
    before = bitplane_counts.launches
    got = bitplane_counts(black, white)
    torch.cuda.synchronize()
    assert bitplane_counts.launches == before + 1
    assert got.shape == want.shape and torch.equal(got, want)


def test_bitplane_measure_launches_the_counts_kernel(cuda):
    """A bitplane ``Session.measure`` on the card counts with
    ``bitplane_counts``: one launch for the first sample, one captured in
    the graph, whose replays give the later samples."""
    from repro_torch.api import SweepSpec
    from repro_torch.kernels.bitplane.counts import bitplane_counts
    spec = RunSpec(lattice=LatticeSpec(64, 96, init_p_up=0.5),
                   engine=EngineSpec("bitplane"), temperature=2.3,
                   seed=2 ** 33 + 5,
                   sweep=SweepSpec(measure_every=2, n_measure=3))
    session = Session.open(spec)
    before = bitplane_counts.launches
    got = session.measure()
    assert bitplane_counts.launches == before + 2
    assert got["m"].shape == got["e"].shape == (3, 32)


# -- philox_fill and the engines of plain updates ----------------------------

@pytest.mark.parametrize("members,shape,offset,c1,c3,lanes", [
    (1, (1001, 1003), 5, 0, 0, 1), (16, (64, 130), 2 ** 32 - 1, 0, 0, 1),
    (3, (33, 65), 2 ** 31, 3, 1, 2), (4, (5, 7), 2 ** 31 - 1, 2, 7, 1),
    (2, (9, 8, 7), 2 ** 32 - 3, 2, 1, 2)])
def test_philox_fill_matches_plain(cuda, members, shape, offset, c1, c3,
                                   lanes):
    from repro_torch.kernels import draws
    seeds = [SEED + i * 7919 for i in range(members)]
    kw = dict(shape=shape, c1=c1, c3=c3, lanes=lanes)
    got = draws.philox_fill(seeds, offset, device=cuda, **kw)
    want = draws.philox_fill_plain(seeds, offset, device=cuda, **kw)
    assert torch.equal(got, want)


@pytest.mark.parametrize("dtype", [torch.int32, torch.int64])
def test_philox_fill_index_plane_matches_plain(cuda, dtype):
    from repro_torch.kernels import draws
    g = torch.Generator(device="cuda").manual_seed(3)
    index = torch.randint(-2 ** 31, 2 ** 31 - 1, (77, 129), generator=g,
                          device=cuda, dtype=torch.int32).to(dtype)
    seeds = [SEED, 5, 2 ** 32 - 1]
    got = draws.philox_fill(seeds, 2 ** 32 - 2, index=index, c1=2, c3=5,
                            lanes=2)
    want = draws.philox_fill_plain(seeds, 2 ** 32 - 2, index=index, c1=2,
                                   c3=5, lanes=2)
    assert torch.equal(got, want)


@pytest.mark.parametrize("engine,temperature,sweeps", [
    ("basic_philox", 2.2, 6), ("basic", 2.2, 6), ("spinglass", 2.2, 6),
    ("wolff", 3.0, 3)])
def test_plain_update_session_on_card_equals_cpu(cuda, engine, temperature,
                                                 sweeps):
    from repro_torch.kernels import draws
    params = {"p_ferro": 0.6} if engine == "spinglass" else {}
    spec = RunSpec(lattice=LatticeSpec(64, 64),
                   engine=EngineSpec(engine, params),
                   temperature=temperature, seed=SEED)
    draws.philox_fill.launches = 0
    card = Session.open(spec, device=cuda)
    card.run(sweeps)
    assert draws.philox_fill.launches > 0
    cpu = Session.open(spec, device="cpu")
    cpu.run(sweeps)
    assert card.state_digest() == cpu.state_digest()


def test_ising3d_on_card_equals_cpu_and_slabs(cuda):
    from repro_torch.core import ising3d
    from repro_torch.launch.mesh import make_mesh
    cube = (torch.arange(16 ** 3) % 3 == 0).to(torch.int8).reshape(
        16, 16, 16) * 2 - 1
    table = ising3d.acceptance_table_3d(1 / 4.0)
    want = ising3d.run_sweeps_3d(cube, table, 5, SEED, 2 ** 32 - 5)
    got = ising3d.run_sweeps_3d(cube.to(cuda), table, 5, SEED, 2 ** 32 - 5)
    assert torch.equal(got.cpu(), want)
    step, split, gather = ising3d.make_ising3d_step(
        make_mesh((2, 2), ("data", "model")), n=16, seed=SEED, n_sweeps=5)
    slabs = gather(step(split(cube.to(cuda)), 1 / 4.0, 2 ** 32 - 5))
    assert torch.equal(slabs.cpu(), want)


# -- telemetry and resilience on the card ------------------------------------

RESILIENCE_ENGINES = ["stencil_pallas", "multispin_pallas", "bitplane_pallas"]


def _resilience_spec(engine, n=512):
    return RunSpec(lattice=LatticeSpec(n, n, init_p_up=1.0),
                   engine=EngineSpec(engine), temperature=2.2, seed=SEED)


@pytest.fixture
def clean_resilience():
    """No demotion, fault plan or memory limit leaks between tests."""
    from repro_torch.resilience import degrade, faults
    degrade.reset_demotions()
    faults.clear()
    yield
    degrade.reset_demotions()
    faults.clear()
    torch.cuda.set_per_process_memory_fraction(1.0)


def test_measure_phases_on_the_profiler_clock(cuda, tmp_path):
    """A traced ``Session.measure`` of a bitplane session under
    ``torch.profiler``: every phase of the graph's trajectory is a
    ``repro_torch/`` range, and the sweep kernels start inside
    ``repro_torch/dispatch``'s interval on the trace's clock (the
    trajectory ends in a wait for its last replay)."""
    import inspect
    import json

    from torch.profiler import ProfilerActivity, profile

    import repro_torch.telemetry as tel
    from repro_torch.analysis.measure import MeasurementPlan
    spec = RunSpec(lattice=LatticeSpec(1024, 1024),
                   engine=EngineSpec("bitplane_pallas"), temperature=3.0,
                   seed=SEED)
    session = Session.open(spec)
    plan = MeasurementPlan(4, 2, thermalize=1)
    session.measure(plan)
    torch.cuda.synchronize()
    tel.TRACER.clear()
    tel.enable()
    try:
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            session.measure(plan)
            torch.cuda.synchronize()
    finally:
        tel.disable()
    path = str(tmp_path / "profile.json")
    prof.export_chrome_trace(path)
    with open(path) as f:
        events = [e for e in json.load(f)["traceEvents"]
                  if e.get("ph") == "X"]
    ranges = {}
    for e in events:
        if e.get("cat") == "user_annotation" \
                and e["name"].startswith("repro_torch/"):
            ranges.setdefault(e["name"][len("repro_torch/"):], []).append(e)
    separate = "keep_graph" in inspect.signature(
        torch.cuda.CUDAGraph.__new__).parameters
    want = {"measure.sweeps": 1 + 4, "measure.observe": 1,
            "measure.graph_capture": 1,
            "measure.graph_instantiate": 1 if separate else 0,
            "measure.graph_replay": 3, "measure.graph_reset": 1,
            "measure.alloc": 1, "measure.to_host": 1, "dispatch": 1,
            "measure_scan": 1, "session.measure": 1}
    assert {k: len(ranges.get(k, [])) for k in want} == want
    traced = {}
    for e in tel.TRACER.events:
        traced[e["name"]] = traced.get(e["name"], 0) + 1
    tel.TRACER.clear()
    assert {k: traced.get(k, 0) for k in want} == want
    (dsp,) = ranges["dispatch"]
    sweeps = [e for e in events if e.get("cat") == "kernel"
              and "bitplane" in e["name"]]
    assert len(sweeps) >= 5
    assert all(dsp["ts"] <= k["ts"] <= dsp["ts"] + dsp["dur"]
               for k in sweeps)


def _fill_cached_blocks(device) -> list:
    """Tensors that take every free block of 1 MiB or more the caching
    allocator still holds on ``device`` (free tails of segments that live
    tensors share), so that the next large allocation needs new device
    memory."""
    index = device.index if device.index is not None \
        else torch.cuda.current_device()
    sizes = [block["size"] for segment in torch.cuda.memory_snapshot()
             if segment["device"] == index
             for block in segment["blocks"]
             if block["state"] == "inactive" and block["size"] >= 1 << 20]
    return [torch.empty(size, dtype=torch.uint8, device=device)
            for size in sorted(sizes, reverse=True)]


@pytest.mark.parametrize("engine", RESILIENCE_ENGINES)
def test_real_out_of_memory_demotes_bit_exact(cuda, clean_resilience,
                                              engine):
    """The cache emptied, its free blocks of 1 MiB or more taken, and a
    memory limit 3 MiB above what the card then holds: room for the
    per-half-sweep tier's small tables, not for the k-sweep tier's second
    copy of the planes (16 MiB or more at 8192^2).  The caching allocator
    raises a real OutOfMemoryError, the run demotes to the per-half-sweep
    tier and ends on the undisturbed run's digest."""
    import repro_torch.telemetry as tel
    from repro_torch.resilience import degrade
    n = 8192
    spec = _resilience_spec(engine, n)
    ref = Session.open(spec)
    ref.run(6)
    want = ref.state_digest()
    del ref
    session = Session.open(spec)
    assert session.engine.resident_plan is not None
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    fillers = _fill_cached_blocks(cuda)
    total = torch.cuda.get_device_properties(cuda).total_memory
    limit = torch.cuda.memory_reserved() + (3 << 20)
    before = tel.REGISTRY.counter("resident.demote").value
    torch.cuda.set_per_process_memory_fraction(limit / total)
    try:
        session.run(6)
    finally:
        torch.cuda.set_per_process_memory_fraction(1.0)
        del fillers
    assert tel.REGISTRY.counter("resident.demote").value == before + 1
    family = session.engine.resident_family
    assert degrade.demotion_reason(family, n, n).startswith(
        "OutOfMemoryError")
    assert session.engine.resident_plan is None
    assert session.state_digest() == want


@pytest.mark.parametrize("engine", RESILIENCE_ENGINES)
def test_shared_memory_overflow_demotes(cuda, clean_resilience, engine):
    """A k-sweep tile over the card's opt-in shared memory: the launcher
    raises SharedMemoryOverflow before any launch, and the run demotes
    with its digest unchanged."""
    from repro_torch.kernels import errors
    from repro_torch.resilience import degrade
    spec = _resilience_spec(engine)
    ref = Session.open(spec)
    ref.run(4)
    session = Session.open(spec)
    plan = session.engine.resident_plan
    session.engine.resident_plan = dataclasses.replace(plan, tile_rows=2048)
    family = plan.family
    with pytest.raises(errors.SharedMemoryOverflow) as ei:
        session.engine.resident_sweeps(
            tuple(p[None] for p in session.state),
            [session.engine.sweep_context(session.engine.cfg.inv_temp)],
            [SEED], 0, 2)
    assert ei.value.code == errors.INVALID_VALUE
    assert ei.value.need > ei.value.limit
    session.run(4)
    assert degrade.demotion_reason(family, 512, 512).startswith(
        "SharedMemoryOverflow")
    assert session.state_digest() == ref.state_digest()


@pytest.mark.parametrize("engine", RESILIENCE_ENGINES + ["tensorcore"])
def test_half_sweep_dispatch_not_retried_after_first_launch(
        cuda, clean_resilience, engine):
    """A transient failure after the first in-place launch of a
    per-half-sweep dispatch propagates: running the dispatch again would
    apply that half-sweep twice."""
    from repro_torch.resilience import TransientDispatchError, degrade
    params = {"tc_block": 64} if engine == "tensorcore" else {}
    spec = dataclasses.replace(_resilience_spec(engine),
                               engine=EngineSpec(engine, params))
    session = Session.open(spec, resident_budget_bytes=0)
    before = [p.clone() for p in (session.state.values()
                                  if engine == "tensorcore"
                                  else session.state)]
    retries = degrade.RETRIES.value
    name = "sweep_fn" if engine == "tensorcore" else "color_update"
    real = getattr(session.engine, name)

    def fail_after(*args, **kwargs):
        out = real(*args, **kwargs)
        raise TransientDispatchError("after the first launch")

    setattr(session.engine, name, fail_after)
    with pytest.raises(TransientDispatchError):
        session.run(3)
    assert degrade.RETRIES.value == retries
    after = list(session.state.values()) if engine == "tensorcore" \
        else list(session.state)
    assert any(not torch.equal(a, b) for a, b in zip(before, after))


# ---------------------------------------------------------------------------
# the sweep farm and the legacy entry point on the card
# ---------------------------------------------------------------------------

def _farm_jobs():
    """Three coalescible multispin_pallas jobs, a bitplane_pallas job and
    a stencil_pallas job on a (2, 2) mesh (four shards on the card)."""
    def spec(engine, n, t, seed, **kw):
        return RunSpec(lattice=LatticeSpec(n, n, init_p_up=1.0),
                       engine=EngineSpec(engine), temperature=t, seed=seed,
                       **kw)
    return ([spec("multispin_pallas", 256, t, 20 + i)
             for i, t in enumerate((1.8, 2.2, 2.5))]
            + [spec("bitplane_pallas", 128, 3.0, 91),
               spec("stencil_pallas", 256, 2.0, 93,
                    mesh=MeshSpec((2, 2), ("data", "model")))])


def test_farm_on_card_equals_cpu(cuda, tmp_path, clean_resilience):
    """The farm on the card (no device named): every job completes with
    the digest of its CPU run, the coalesced batch in one launch of the
    member-axis k-sweep kernel a block of sweeps, no retry, no
    demotion."""
    import repro_torch.telemetry as tel
    from repro_torch.serve import SweepFarm
    jobs = _farm_jobs()
    want = []
    for spec in jobs:
        s = Session.open(spec, device="cpu")
        s.run(40)
        want.append(s.state_digest())
    base = tel.REGISTRY.snapshot()
    farm = SweepFarm(str(tmp_path / "farm"), chunk=20, ckpt_every_sweeps=20)
    jids = [farm.submit({"spec": s.to_dict(), "sweeps": 40}) for s in jobs]
    multispin_sweeps_resident.launches = 0
    assert farm.step()        # the coalesced batch
    plan = resident.plan_resident("multispin", 256, 256)
    assert multispin_sweeps_resident.launches == 2 * -(-20 // plan.k)
    assert farm.run_until_idle() == 2
    for jid, digest in zip(jids, want):
        job = farm.job(jid)
        assert job["status"] == "completed", job["error"]
        assert job["digest"] == digest
    got = tel.diff_counters(base, tel.REGISTRY.snapshot())
    assert got["serve.completed"] == len(jobs)
    assert got.get("resilience.retry", 0) == got.get(
        "resident.demote", 0) == 0
    farm.close()


def test_simulation_on_card_equals_cpu(cuda, tmp_path):
    from repro_torch.core.sim import SimConfig, Simulation
    cfg = SimConfig(n=256, m=256, temperature=2.2, seed=SEED,
                    engine="multispin")
    card, cpu = Simulation(cfg), Simulation(cfg, device="cpu")
    assert card._session.device.type == "cuda"
    for sim in (card, cpu):
        sim.run(30)
    assert card.magnetization() == cpu.magnetization()
    path = str(tmp_path / "sim.npz")
    card.save(path)
    back = Simulation.restore(path)
    assert back.config == cfg and back._session.device.type == "cuda"
    back.run(10)
    cpu.run(10)
    assert back._session.state_digest() == cpu._session.state_digest()


def test_simulate_restore_on_card(cuda, tmp_path, capsys):
    from repro_torch.launch import simulate
    args = ["--size", "512", "--temp", "2.0", "--measure-every", "20"]
    assert simulate.main(args + ["--sweeps", "60"]) == 0
    whole = capsys.readouterr().out.splitlines()
    ck = str(tmp_path / "ck.npz")
    assert simulate.main(args + ["--sweeps", "40", "--ckpt", ck]) == 0
    first = capsys.readouterr().out.splitlines()
    assert simulate.main(args + ["--sweeps", "60", "--ckpt", ck,
                                 "--restore"]) == 0
    second = capsys.readouterr().out.splitlines()
    m_lines = [[l for l in out if l.startswith("sweep")]
               for out in (whole, first, second)]
    assert len(m_lines[0]) == 3 and m_lines[1] + m_lines[2] == m_lines[0]


# -- the LM stack's inference path -------------------------------------------

#: the card against the CPU: the logits' RMS error over their RMS (bf16
#: activations summed in another order; chip_smoke.py's LM_REL_RMS)
LM_REL_RMS = 0.03


@pytest.mark.parametrize("arch", ["internlm2-1.8b", "chatglm3-6b",
                                  "zamba2-1.2b", "xlstm-125m",
                                  "whisper-large-v3"])
def test_lm_forward_and_decode_on_card_equal_cpu(cuda, arch):
    import copy

    from repro_torch.configs import get_smoke_config
    from repro_torch.models import (decode_step, forward, init_cache,
                                    init_model)
    from repro_torch.models.model import encode_audio
    cfg = get_smoke_config(arch)
    cpu = init_model(cfg, 3, device="cpu")
    card = copy.deepcopy(cpu).to(cuda)
    r = np.random.default_rng(3)
    batch = {"tokens": torch.tensor(r.integers(0, cfg.vocab, (2, 8)).astype(
        np.int32))}
    if cfg.family == "audio":
        batch["frames"] = torch.tensor(r.standard_normal(
            (2, cfg.enc_seq, cfg.d_model)).astype(np.float32))

    def rel(got, want):
        got = got.float().cpu()
        return float((got - want).pow(2).mean().sqrt()
                     / want.pow(2).mean().sqrt())

    want, _ = forward(cfg, cpu, batch, remat=False)
    got, _ = forward(cfg, card, {k: v.to(cuda) for k, v in batch.items()},
                     remat=False)
    assert got.device.type == "cuda" and rel(got, want) <= LM_REL_RMS
    caches = []
    for params, device in ((cpu, "cpu"), (card, cuda)):
        enc = None
        if cfg.family == "audio":
            enc = encode_audio(cfg, params, batch["frames"].to(device))
        caches.append(init_cache(cfg, 2, 8, enc_out=enc, params=params
                                 if enc is not None else None,
                                 device=device))
    for t in range(8):
        tok = batch["tokens"][:, t:t + 1]
        want, _ = decode_step(cfg, cpu, caches[0], tok)
        got, _ = decode_step(cfg, card, caches[1], tok.to(cuda))
        assert rel(got, want) <= LM_REL_RMS, t


def test_lm_batch_and_init_on_card(cuda):
    from repro_torch.configs import SHAPES, get_smoke_config
    from repro_torch.data import make_batch
    from repro_torch.models import init_model
    cfg = get_smoke_config("internvl2-26b")
    got = make_batch(cfg, SHAPES["prefill_32k"], step=3, seed=5,
                     batch_override=2, seq_override=16)
    want = make_batch(cfg, SHAPES["prefill_32k"], step=3, seed=5,
                      batch_override=2, seq_override=16, device="cpu")
    assert got["tokens"].device.type == "cuda"
    assert torch.equal(got["tokens"].cpu(), want["tokens"])
    assert torch.equal(got["labels"].cpu(), want["labels"])
    params = init_model(cfg, 4)
    assert all(p.device.type == "cuda" for p in params.parameters())


# -- the LM stack's training path ---------------------------------------------

#: (a's shape, b's shape) of ``layers.mm``: 2-D weights, batched, b
#: broadcast over a's leading axis
MM_LAYOUTS = [((64, 96), (96, 80)), ((4, 32, 48), (4, 48, 40)),
              ((3, 4, 32, 48), (4, 48, 40))]


@pytest.mark.parametrize("a_shape,b_shape", MM_LAYOUTS)
def test_mm_backward_on_card_equals_cpu_plain(cuda, a_shape, b_shape):
    """``layers.mm``'s gradient on the card (``CardProduct``: the
    cotangent rounded to bf16 for the tensor cores, each operand's
    gradient rounded to bf16 as JAX's transpose does) against the CPU's
    plain f32 product under autograd: within 2^-6 of the largest
    gradient (the cotangent's rounding, 2^-9 relative, over the sums)."""
    from repro_torch.models import layers as L
    gen = torch.Generator().manual_seed(len(a_shape) + len(b_shape))
    a0 = torch.randn(a_shape, generator=gen).to(torch.bfloat16)
    w0 = torch.randn(b_shape, generator=gen)
    grads = []
    for device in ("cpu", cuda):
        a = a0.to(device, copy=True).requires_grad_(True)
        w = w0.to(device, copy=True).requires_grad_(True)
        y = L.mm(a, w)
        assert y.dtype == torch.float32
        y.backward(torch.randn(y.shape, generator=torch.Generator(
            ).manual_seed(1)).to(device))
        assert a.grad.dtype == torch.bfloat16 and w.grad.dtype == \
            torch.float32
        grads.append((a.grad.float().cpu(), w.grad.cpu()))
    for got, want in zip(grads[1], grads[0]):
        assert got.shape == want.shape
        assert float((got - want).abs().max()) <= 2 ** -6 * float(
            want.abs().max())
        # the parameter's gradient is a bf16 value carried to f32
        assert torch.equal(got, got.to(torch.bfloat16).float())


@pytest.mark.parametrize("arch", ["internlm2-1.8b", "zamba2-1.2b",
                                  "xlstm-125m"])
def test_lm_train_step_on_card_equals_cpu(cuda, arch):
    """One ``make_train_step`` on the card and on the CPU from one
    initialisation and batch: loss within 1e-3 relative, grad_norm 1e-2,
    the gradient tree's relative RMS error within 3 % (chip_smoke.py's
    LM_GRAD_TREE)."""
    import copy

    from repro_torch.configs import SHAPES, get_smoke_config
    from repro_torch.data import make_batch
    from repro_torch.models import init_model
    from repro_torch.train import OptConfig, make_train_step, opt_init
    cfg = get_smoke_config(arch)
    cpu = init_model(cfg, 5, device="cpu")
    card = copy.deepcopy(cpu).to(cuda)
    batch = make_batch(cfg, SHAPES["train_4k"], step=1, seed=6,
                       batch_override=2, seq_override=16, device="cpu")
    out = []
    for params in (cpu, card):
        saved = []

        def keep(grads):
            saved.append([g.detach().cpu().clone() for g in grads])
            return grads
        step = make_train_step(cfg, OptConfig(lr=1e-2, warmup=0,
                                              total_steps=10),
                               grad_sync=keep)
        device = next(params.parameters()).device
        got, _, m = step(params, opt_init(params),
                         {k: v.to(device) for k, v in batch.items()})
        assert got is params
        out.append(({k: float(v) for k, v in m.items()}, saved[0]))
    (mc, gc), (mg, gg) = out
    assert mg["loss"] == pytest.approx(mc["loss"], rel=1e-3)
    assert mg["grad_norm"] == pytest.approx(mc["grad_norm"], rel=1e-2)
    sq = sum(float((a - b).pow(2).sum()) for a, b in zip(gg, gc))
    norm = sum(float(b.pow(2).sum()) for b in gc)
    assert (sq / norm) ** 0.5 <= 0.03
    assert all(p.device.type == "cuda" for p in card.parameters())


def test_param_shardings_and_place_on_card(cuda):
    """``param_shardings`` on a one-device mesh of the card: every spec
    fits its leaf whole, and ``place`` leaves the tree on the card."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.launch.mesh import make_debug_mesh
    from repro_torch.models import init_model
    from repro_torch.train.sharding import param_shardings, place
    cfg = get_smoke_config("internlm2-1.8b")
    mesh = make_debug_mesh(n_devices=1, device="cuda")
    assert mesh.devices == (torch.device("cuda"),)
    params = init_model(cfg, 0, device="cuda")
    sh = param_shardings(cfg, params, mesh)
    assert len(sh) == len(list(params.parameters()))
    for path, s in sh.items():
        leaf = params.get_parameter(path.replace("/", "."))
        assert s.shard_shape(leaf.shape) == tuple(leaf.shape)
    assert place(params, sh) is params
    assert all(p.device.type == "cuda" for p in params.parameters())


@pytest.mark.parametrize("arch", ["internlm2-1.8b", "deepseek-moe-16b",
                                  "whisper-large-v3"])
def test_lm_mesh_step_on_card_equals_one_shard(cuda, arch):
    """One ``make_train_step`` on a (2, 2) mesh whose four shards share
    the card, against the card's one-shard step from one initialisation
    and batch: each piece its ``NamedSharding.index`` slice on the card,
    every shard computes rows, loss within 1e-3 relative, grad_norm 1e-2,
    each parameter within 2.1 lr and 98 % within 1e-4 (chip_smoke.py's
    phase 16 bounds)."""
    import copy

    from repro_torch.configs import SHAPES, get_smoke_config
    from repro_torch.data import make_batch
    from repro_torch.launch.mesh import make_debug_mesh
    from repro_torch.models import init_model
    from repro_torch.train import OptConfig, make_train_step, opt_init
    from repro_torch.train import step as train_step
    from repro_torch.train.sharding import param_shardings, place
    cfg = get_smoke_config(arch)
    one = init_model(cfg, 5, device=cuda)
    mesh = make_debug_mesh(n_devices=4, device=cuda)
    sh = param_shardings(cfg, one, mesh)
    placed = place(copy.deepcopy(one), sh)
    for i, tree in enumerate(placed.pieces):
        for name, piece in tree.named_parameters():
            leaf = one.get_parameter(name)
            assert piece.device.type == "cuda"
            assert torch.equal(piece, leaf[sh[name.replace(".", "/")].index(
                i, leaf.shape)])
    batch = make_batch(cfg, SHAPES["train_4k"], step=1, seed=6,
                       batch_override=4, seq_override=32, device=cuda)
    ocfg = OptConfig(lr=1e-2, warmup=0, total_steps=10)
    _, _, m1 = make_train_step(cfg, ocfg)(one, opt_init(one), batch)
    computed = []
    parts = train_step.split_rows

    def recording(params, b):
        out = parts(params, b)
        computed.extend(i for i, _ in out)
        return out
    train_step.split_rows = recording
    try:
        _, _, mm = make_train_step(cfg, ocfg, mesh=mesh)(
            placed, opt_init(placed), batch)
    finally:
        train_step.split_rows = parts
    assert sorted(computed) == [0, 1, 2, 3]
    assert float(mm["loss"]) == pytest.approx(float(m1["loss"]), rel=1e-3)
    assert float(mm["grad_norm"]) == pytest.approx(float(m1["grad_norm"]),
                                                   rel=1e-2)
    lr = float(m1["lr"])
    whole = placed.tree(cuda)
    near = []
    with torch.no_grad():
        for (name, a), b in zip(whole.named_parameters(), one.parameters()):
            assert float((a - b).abs().max()) <= 2.1 * lr, name
            near.append(((a - b).abs() < 1e-4).flatten())
    assert float(torch.cat(near).float().mean()) >= 0.98


def test_lm_mesh_step_across_cards(cuda, tmp_path, capsys):
    """On four cards or more: ``launch.train`` with no ``--device`` trains
    on ``make_debug_mesh()`` over every card (each shard's pieces on its
    card), and one step of that mesh equals the one-card step (the
    bounds of the test above).  The mesh step repeats bit for bit from
    one state, and under ``--deterministic`` a ``--die-at`` restart of
    ``launch.train`` on every card ends with a straight run's checkpoint
    bit for bit (each piece sums its shards' cuts in shard order,
    whichever card's autograd thread finishes first)."""
    import copy
    import os
    import subprocess
    import sys

    from repro_torch.ckpt import Checkpointer

    from repro_torch.configs import SHAPES, get_smoke_config
    from repro_torch.data import make_batch
    from repro_torch.launch import train
    from repro_torch.launch.mesh import make_debug_mesh
    from repro_torch.models import init_model
    from repro_torch.train import OptConfig, make_train_step, opt_init
    from repro_torch.train.sharding import param_shardings, place
    n = torch.cuda.device_count()
    if n < 4:
        pytest.skip(f"needs four cards, has {n}")
    assert train.main(["--smoke", "--arch", "deepseek-moe-16b", "--steps",
                       "2", "--batch", "8", "--seq", "16", "--log-every",
                       "1"]) == 0
    out = capsys.readouterr().out
    assert f"mesh={{'data': {n // 2}, 'model': 2}} devices={n}" in out
    cfg = get_smoke_config("deepseek-moe-16b")
    one = init_model(cfg, 5, device=cuda)
    mesh = make_debug_mesh()
    assert len(set(mesh.devices)) == n
    sh = param_shardings(cfg, one, mesh)
    placed, twin = (place(copy.deepcopy(one), sh) for _ in range(2))
    assert {str(p.device) for t in placed.pieces
            for p in t.parameters()} == {f"cuda:{i}" for i in range(n)}
    batch = make_batch(cfg, SHAPES["train_4k"], step=1, seed=6,
                       batch_override=2 * n, seq_override=32, device=cuda)
    ocfg = OptConfig(lr=1e-2, warmup=0, total_steps=10)
    _, _, m1 = make_train_step(cfg, ocfg)(one, opt_init(one), batch)
    mesh_step = make_train_step(cfg, ocfg, mesh=mesh)
    _, _, mm = mesh_step(placed, opt_init(placed), batch)
    assert float(mm["loss"]) == pytest.approx(float(m1["loss"]), rel=1e-3)
    assert float(mm["grad_norm"]) == pytest.approx(float(m1["grad_norm"]),
                                                   rel=1e-2)
    lr = float(m1["lr"])
    near = []
    with torch.no_grad():
        for a, b in zip(placed.tree(cuda).parameters(), one.parameters()):
            assert float((a - b).abs().max()) <= 2.1 * lr
            near.append(((a - b).abs() < 1e-4).flatten())
    assert float(torch.cat(near).float().mean()) >= 0.98
    mesh_step(twin, opt_init(twin), batch)
    for a, b in zip(twin.leaves(), placed.leaves()):
        assert torch.equal(a, b)

    src = os.path.join(os.path.dirname(__file__), "..", "src")
    env = dict(os.environ, CUBLAS_WORKSPACE_CONFIG=":4096:8",
               PYTHONPATH=src + os.pathsep + os.environ.get("PYTHONPATH", ""))

    def train(ckpt_dir, *extra):
        return subprocess.run(
            [sys.executable, "-m", "repro_torch.launch.train", "--smoke",
             "--steps", "6", "--batch", "8", "--seq", "16", "--ckpt-every",
             "2", "--log-every", "1", "--deterministic", "--ckpt-dir",
             str(tmp_path / ckpt_dir), *extra], env=env,
            capture_output=True, text=True).returncode
    assert train("straight") == 0
    assert train("restarted", "--die-at", "3") == 42
    assert train("restarted") == 0
    a, b = (Checkpointer(str(tmp_path / d)).load_arrays(6)[1]
            for d in ("straight", "restarted"))
    assert sorted(a) == sorted(b)
    assert [k for k in a if not np.array_equal(a[k], b[k])] == []


def test_launch_train_on_card_mesh(cuda, capsys):
    """``launch.train`` with no ``--device``: every card, its debug mesh
    (one card: one shard) printed as JAX's driver prints its mesh."""
    from repro_torch.launch import train
    from repro_torch.launch.mesh import make_debug_mesh
    assert train.main(["--smoke", "--steps", "2", "--batch", "2", "--seq",
                       "16", "--log-every", "1"]) == 0
    out = capsys.readouterr().out
    mesh = make_debug_mesh()
    n = torch.cuda.device_count()
    assert f"mesh={dict(zip(mesh.axis_names, mesh.shape))} devices={n}" \
        in out
    assert (n, mesh.size) != (1, 1) or \
        "mesh={'data': 1, 'model': 1} devices=1" in out
    assert "done" in out


def test_dryrun_count_equals_card_count(cuda):
    """One smoke train step counted on meta and around the same step on
    the card: the same FLOPs, op for op."""
    from repro_torch.configs import SHAPES, get_smoke_config
    from repro_torch.data import make_batch
    from repro_torch.launch.roofline import OpCounter
    from repro_torch.models import init_model
    from repro_torch.train import OptConfig, make_train_step, opt_init
    cfg = get_smoke_config("internlm2-1.8b")
    step = make_train_step(cfg, OptConfig())
    counts = []
    for device in ("meta", "cuda"):
        params = init_model(cfg, 0, device=device)
        batch = make_batch(cfg, SHAPES["train_4k"], batch_override=2,
                           seq_override=16, abstract=device == "meta",
                           device=None if device == "meta" else device)
        with OpCounter() as c:
            step(params, opt_init(params), batch)
        counts.append(c)
    torch.cuda.synchronize()
    assert counts[0].by_op == counts[1].by_op
    assert counts[0].flops == counts[1].flops > 0


@pytest.mark.parametrize("engine", ["multispin", "bitplane", "basic"])
def test_shard_kernel_at_dryrun_plan(cuda, engine):
    """One dispatch of the family's shard kernel at the plan and extended
    shard that the dry-run reports for lat_256k on the (2, 16, 16) mesh
    (the last shard's index planes), against its plain version."""
    from repro_torch.analysis.tune_resident import acceptance, random_planes
    from repro_torch.core.distributed import ShardGrid
    from repro_torch.dist import driver
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import make_production_mesh
    rec = dryrun.run_cell(f"ising-{engine}", "lat_256k", "multi",
                          verbose=False)
    assert rec["status"] == "ok"
    family = dryrun.ISING_ENGINES[engine][3]
    n, m = dryrun.ISING_SHAPES["lat_256k"]
    grid = ShardGrid.of(make_production_mesh(multi_pod=True, device="cuda"),
                        n, m // resident.GEOMETRY[family].col_divisor)
    plan = shard_planner.plan_shard_resident(family, n, m, grid.rows_devs,
                                             grid.cols_devs)
    ext = [plan.n_loc + 2 * plan.halo, plan.w_loc + 2 * plan.halo]
    assert ext == rec["plan"]["extended"] and plan.k == rec["plan"]["k"]
    index = driver.index_planes(plan, grid, 511)
    b, w = random_planes(family, *ext, 15)
    name = f"{family}_shard_sweeps"
    kernel, plain = getattr(dk, name), getattr(dk, f"{name}_plain")
    table = acceptance(family)
    before = kernel.launches
    got = kernel(b, w, table, *index, n_sweeps=plan.k, seed=SEED,
                 start_offset=2 ** 32 - 3,
                 tile=(plan.tile_rows, plan.tile_cols, plan.threads))
    assert kernel.launches == before + 1
    want = plain(b, w, table, *index, n_sweeps=plan.k, seed=SEED,
                 start_offset=2 ** 32 - 3)
    for x, y in zip(got, want):
        assert torch.equal(x, y)
