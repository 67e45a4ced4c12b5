"""The CUDA kernels against their plain versions, on the card.

These need an NVIDIA GPU and nvcc, and skip without one.  Run them on
the card with ``PYTHONPATH=src python -m pytest -m cuda
tests/test_torch_cuda.py``.  The kernels build at first use."""
import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.api import LatticeSpec, RunSpec, Session
from repro_torch.core import metropolis
from repro_torch.kernels import resident
from repro_torch.kernels.stencil import (stencil_sweeps_resident,
                                         stencil_sweeps_resident_plain,
                                         stencil_update,
                                         stencil_update_plain)

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


@pytest.mark.parametrize("n,h", [(64, 32), (30, 7), (2, 1)])
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
    spec = RunSpec(lattice=LatticeSpec(64, 96), temperature=2.1, seed=SEED)
    cpu = Session.open(spec, device="cpu")
    cpu.run(7)
    card = Session.open(
        spec, resident_budget_bytes=0 if tier == "half-sweep" else None)
    assert card.device.type == "cuda"
    assert (card.engine.resident_plan is not None) == (tier == "k-sweep")
    card.run(7)
    assert card.state_digest() == cpu.state_digest()
