"""The tuning script of the k-sweep kernels (``repro_torch.analysis.
tune_resident``): it times the planner's own configuration, and only
configurations that fit one block's shared memory."""
import pytest

from repro_torch.analysis import tune_resident
from repro_torch.kernels import resident


@pytest.mark.parametrize("family", tune_resident.FAMILIES)
def test_candidates_include_the_planners_geometry(family):
    g = resident.GEOMETRY[family]
    n, _ = tune_resident.FULL_PLANE[family]
    plan = resident.plan_resident(family, n, n)
    assert (plan.tile_rows, plan.tile_cols, plan.k) == (
        g.tile_rows, g.tile_cols, g.max_k)
    assert (g.tile_rows, g.tile_cols, g.max_k,
            g.threads) in tune_resident.CANDIDATES[family]


@pytest.mark.parametrize("family", tune_resident.FAMILIES)
def test_full_plane_is_the_planes_of_the_main_path(family):
    n, h = tune_resident.FULL_PLANE[family]
    assert h == n // resident.GEOMETRY[family].col_divisor


@pytest.mark.parametrize("family", tune_resident.FAMILIES)
def test_shard_candidates_include_the_planners_shard_tile(family):
    from repro_torch.dist import planner
    n, _ = tune_resident.FULL_PLANE[family]
    plan = planner.plan_shard_resident(family, n, n, 2, 2)
    assert (plan.tile_rows, plan.tile_cols) == planner.SHARD_TILES[family]
    assert (plan.tile_rows, plan.tile_cols, plan.threads) in \
        tune_resident.SHARD_CANDIDATES
    assert planner.shard_smem_bytes(family, plan.tile_rows, plan.tile_cols,
                                    plan.k) <= plan.budget_bytes
