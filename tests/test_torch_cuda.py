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
from repro_torch.kernels.tensorcore.tensorcore import CUDA_BLOCKS

pytestmark = pytest.mark.cuda

SEED = 2 ** 40 + 11


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
                         + [(2 * b, 3 * b, b) for b in CUDA_BLOCKS])
@pytest.mark.parametrize("color", ["black", "white"])
@pytest.mark.parametrize("dtype", [torch.int8, torch.bfloat16])
def test_tensorcore_kernel_matches_plain(cuda, n, w, block, color, dtype):
    tc_kernel_matches_plain(tc_planes(n, dtype, n + block, cuda, w), color,
                            1 / 2.0, block)


@pytest.mark.parametrize("temperature", [0.05, 0.02])
@pytest.mark.parametrize("block", CUDA_BLOCKS)
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
    from repro_torch.kernels.tensorcore import tensorcore_update
    planes = tc_planes(32, torch.int8, 0, cuda)
    before = tensorcore_update.launches
    with pytest.raises(ValueError, match="block"):
        tensorcore_update(planes, "black", 0.5, block=8)
    assert tensorcore_update.launches == before
    spec = RunSpec(lattice=LatticeSpec(64, 64),
                   engine=EngineSpec("tensorcore", {"tc_block": 8}))
    with pytest.raises(ValueError, match="block"):
        Session.open(spec)


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
        index = list(index_planes(plan, grid, 1))
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


def test_dispatch_span_fence_waits(cuda):
    """The traced dispatch span lasts at least as long as its launches on
    the card (CUDA events just before the first and just after the last,
    inside the span); disabled, the span records nothing."""
    import repro_torch.telemetry as tel
    session = Session.open(_resilience_spec("multispin_pallas", 2048))
    session.run(2)
    marks = []
    launch = session.engine.resident_sweeps

    def marked(*args, **kwargs):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        out = launch(*args, **kwargs)
        end.record()
        marks.append((start, end))
        return out

    session.engine.resident_sweeps = marked
    tel.TRACER.clear()
    tel.enable()
    try:
        session.run(40)
    finally:
        tel.disable()
    spans = [e for e in tel.TRACER.events if e["name"] == "dispatch"]
    tel.TRACER.clear()
    assert len(spans) == len(marks) == 1
    assert spans[0]["dur_us"] / 1e3 >= marks[0][0].elapsed_time(marks[0][1])
    session.run(2)
    assert tel.TRACER.events == []


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
