"""The ablation tool of ``tensorcore_update`` and the multispin and
bitplane k-sweep kernels (``repro_torch.analysis.ablate``): every
ablation still applies to ``csrc/tensorcore.cu``, ``csrc/multispin.cu``
or ``csrc/bitplane.cu`` and takes out what it names, and every tile copy
fixes its tile, so that its card timings mean what they say; the copies
build from their own directories; the command line takes the families
and, without a card, exits non-zero."""
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
    new = ablate.loop_source("multispin", name)
    assert new != source
    taken_out = {"philox": "philox(widx, draw);",
                 "accept": "flip_below(flip, draw",
                 "plane loads": "op[c - pitch]",
                 "staging": "load_tile<kShard>(b_in",
                 "sweeps": "half_sweep<kShard, false>(tgt",
                 "select": "setp.lt.u32"}[name]
    assert taken_out in source and taken_out not in new


@pytest.mark.parametrize("name", sorted(ablate.BITPLANE_ABLATIONS))
def test_bitplane_ablation_applies_to_the_group_loop(name):
    source = (_build.CSRC_DIR / "bitplane.cu").read_text()
    new = ablate.loop_source("bitplane", name)
    assert new != source
    taken_out = {"philox": "r = philox.lanes(row_base",
                 "accept": "xor_below(out, draw, t4, m4);",
                 "plane loads": "op + c - tile.pitch",
                 "staging": "load_tile<kShard>(b_in",
                 "sweeps": "half_sweep<kShard, kThree, false>(tgt"}[name]
    assert taken_out in source and taken_out not in new
    # the shard kernel's draws stay: only the k-sweep kernel's are cut
    assert "philox.lanes(index.s_g[gq])" in new


@pytest.mark.parametrize("argv", [["bitplane"], ["multispin", "bitplane"],
                                  ["parts", "bitplane"], []])
def test_command_line_takes_the_families_and_needs_a_card(argv, capsys):
    """Without a card every valid choice exits 1 and says why."""
    assert ablate.main(argv) == 1
    assert "no CUDA device" in capsys.readouterr().err


def test_command_line_refuses_an_unknown_family():
    with pytest.raises(SystemExit):
        ablate.main(["stencil"])
