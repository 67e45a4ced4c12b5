"""The ablation tool of ``tensorcore_update`` and the multispin k-sweep
kernel (``repro_torch.analysis.ablate``): every ablation still applies
to ``csrc/tensorcore.cu`` or ``csrc/multispin.cu`` and takes out what
it names, and every tile copy fixes its tile, so that its card timings
mean what they say; the copies build from their own directories."""
import pytest

from repro_torch.analysis import ablate
from repro_torch.kernels import _build


@pytest.mark.parametrize("name", sorted(ablate.ABLATIONS))
def test_ablation_applies_to_the_kernel(name):
    source = (_build.CSRC_DIR / "tensorcore.cu").read_text()
    new = ablate.ablated_source(name)
    assert new != source
    if "philox" in name:
        assert "philox.lanes01(" not in new
    if "accept" in name:
        assert "bound_of(bound" not in new
    if name == "products":
        assert "mma_bf16_16816(" not in new
        assert "ldmatrix_x4" not in new
    if name == "fetch":
        assert new.count("fetch(") == source.count("fetch(") - 1


@pytest.mark.parametrize("tile", ablate.TILES,
                         ids=[f"{r}x{c}" for r, c in ablate.TILES])
def test_tile_copy_fixes_the_tile(tile):
    source = (_build.CSRC_DIR / "tensorcore.cu").read_text()
    new = ablate.tiled_source(*tile)
    assert f"REPRO_TC_TILE({tile[0]}, {tile[1]})" in source
    assert new.count(f"return run({tile[0]}, {tile[1]}, elem_bytes,") == 1
    assert "run(tile_rows(h), tile_cols(w)" not in new
    assert len(new.splitlines()) == len(source.splitlines())


def test_copy_builds_from_its_own_directory(tmp_path):
    """A copy's library is named by its own sources and the package's
    directories stay as they are."""
    for header in _build.CSRC_DIR.glob("*.cuh"):
        (tmp_path / header.name).write_bytes(header.read_bytes())
    (tmp_path / "tensorcore.cu").write_text(ablate.tiled_source(32, 64))
    package = _build._target("tensorcore", _build.CSRC_DIR, _build.BUILD_DIR)
    copy = _build._target("tensorcore", tmp_path, _build.BUILD_DIR)
    assert copy.parent == package.parent == _build.BUILD_DIR
    assert copy != package
    assert _build.CSRC_DIR == _build.PACKAGE_DIR / "csrc"


@pytest.mark.parametrize("name", sorted(ablate.MULTISPIN_ABLATIONS))
def test_multispin_ablation_applies_to_the_word_loop(name):
    source = (_build.CSRC_DIR / "multispin.cu").read_text()
    new = ablate.multispin_source(name)
    assert new != source
    taken_out = {"philox": "philox(widx, draw);",
                 "accept": "flip_below(flip, draw",
                 "plane loads": "op[c - pitch]",
                 "staging": "load_tile<kShard>(b_in",
                 "sweeps": "half_sweep<kShard, false>(tgt",
                 "select": "setp.lt.u32"}[name]
    assert taken_out in source and taken_out not in new
