"""Time edited copies of ``tensorcore_update``'s kernel on the card.

    PYTHONPATH=src python -m repro_torch.analysis.ablate [parts] [tiles]

Builds copies of ``csrc/tensorcore.cu`` (each from its own directory
under ``kernels/_build``'s, all nvcc processes at once) and times each as
``tune_resident --tensorcore`` times the kernel (four 16384^2 int8
planes, block 128, ms per half-sweep), beside the whole kernel.

``parts``: each copy has one part of the work per plane position
replaced by a stand-in that costs next to nothing: ``philox`` (the
draws become a multiply and an XOR of the position), ``products`` (no
``ldmatrix`` or ``mma``: the sums keep their start), ``accept`` (the
draw's top bit, not the bound, flips the spin), ``philox+accept``, and
``fetch`` (a block copies only its first tile from device memory and
takes the same stage again for every later tile; the write-back stays).
Their results are wrong; the gaps to the whole kernel say what each
part costs where the others stay.

``tiles``: each copy takes a fixed tile of :data:`TILES` in place of the
largest that divides the planes; the results are the same.

The last lines are the card's name and power limit and one JSON object
of every time.
"""
from __future__ import annotations

import argparse
import concurrent.futures
import json
import shutil
import subprocess
import sys

import torch

from repro_torch.analysis import tune_resident
from repro_torch.kernels import _build

#: (old, new) source edits of each ablation; each must apply
_STAND_IN = (
    "// Persistent: grid",
    "__device__ __forceinline__ uint2 stand_in(uint32_t s) {\n"
    "  return make_uint2(s * 0x9E3779B9u, s ^ 0xDEADBEEFu);\n"
    "}\n\n// Persistent: grid")
_DRAWS = ("philox.lanes01(", "stand_in(")
_ACCEPT = [("d.x < bound_of(bound, n1[e][x])",
            "(d.x ^ __float_as_uint(n1[e][x])) >> 31"),
           ("d.y < bound_of(bound, n2[e][x])",
            "(d.y ^ __float_as_uint(n2[e][x])) >> 31")]
_FETCH = [("    unsigned char* st = smem + (i & 1) * L::kStage;",
           "    unsigned char* st = smem;"),
          ("      fetch(tile + gridDim.x, smem + ((i + 1) & 1) * L::kStage);",
           "")]
ABLATIONS = {"philox": [_STAND_IN, _DRAWS], "products": "products",
             "accept": _ACCEPT, "philox+accept": [_STAND_IN, _DRAWS, *_ACCEPT],
             "fetch": _FETCH}
#: (rows, columns) of the kernel's tiles: each divides the main path's
#: planes
TILES = tuple((r, c) for r in (64, 32, 16) for c in (128, 64, 32, 16))
#: the launch's choice of tile, which a tile copy fixes
_TILE_CHOICE = "return run(tile_rows(h), tile_cols(w), elem_bytes,"


def _source() -> str:
    return (_build.CSRC_DIR / "tensorcore.cu").read_text()


def _without_products(source: str) -> str:
    """The source with every ldmatrix and mma call of the kernel removed
    (a call may span lines)."""
    out, skipping = [], False
    for line in source.split("\n"):
        call = ("repro_torch::mma_bf16_16816(" in line
                or "repro_torch::ldmatrix_x4" in line)
        if call or skipping:
            skipping = not line.rstrip().endswith(";")
            continue
        out.append(line)
    return "\n".join(out)


def ablated_source(name: str) -> str:
    """``csrc/tensorcore.cu`` with ablation ``name`` applied."""
    source = _source()
    edits = ABLATIONS[name]
    if edits == "products":
        new = _without_products(source)
        if new == source:
            raise RuntimeError("no product to take out")
        return new
    for old, new in edits:
        if old not in source:
            raise RuntimeError(f"ablation {name!r} no longer applies to "
                               f"csrc/tensorcore.cu")
        source = source.replace(old, new)
    return source


def tiled_source(rows: int, cols: int) -> str:
    """``csrc/tensorcore.cu`` launching its kernel at tile rows x cols."""
    source = _source()
    if source.count(_TILE_CHOICE) != 1:
        raise RuntimeError("the tile choice no longer applies to "
                           "csrc/tensorcore.cu")
    return source.replace(_TILE_CHOICE,
                          f"return run({rows}, {cols}, elem_bytes,")


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("what", nargs="*", choices=("parts", "tiles"),
                        help="what to time (default: both)")
    args = parser.parse_args(argv)
    what = args.what or ["parts", "tiles"]
    if not torch.cuda.is_available():
        print("ablate: no CUDA device", file=sys.stderr)
        return 1
    sources = {}
    if "parts" in what:
        sources.update({f"without {name}": ablated_source(name)
                        for name in ABLATIONS})
    if "tiles" in what:
        sources.update({f"tile {r}x{c}": tiled_source(r, c)
                        for r, c in TILES})
    dirs = {}
    for i, (label, source) in enumerate(sources.items()):
        csrc = _build.BUILD_DIR / f"ablate-{i}"
        csrc.mkdir(parents=True, exist_ok=True)
        for header in _build.CSRC_DIR.glob("*.cuh"):
            shutil.copy(header, csrc / header.name)
        (csrc / "tensorcore.cu").write_text(source)
        dirs[label] = csrc
    with concurrent.futures.ThreadPoolExecutor(len(dirs) + 1) as pool:
        builds = [pool.submit(_build.build, ["tensorcore"])]
        builds += [pool.submit(_build.build, ["tensorcore"], d)
                   for d in dirs.values()]
        for b in builds:
            b.result()
    from repro_torch.kernels.tensorcore import tensorcore as tcm
    results = {"whole": tune_resident.tune_tensorcore()}
    for label, csrc in dirs.items():
        results[label] = tune_resident.tune_tensorcore(
            lib=tcm.library(csrc_dir=csrc))
        print(f"tensorcore_update {label}: {results[label]:.4f} ms per "
              f"half-sweep (whole kernel {results['whole']:.4f})",
              flush=True)
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], check=True, capture_output=True,
        text=True).stdout.strip().splitlines()[0])
    print(json.dumps(results))
    return 0


if __name__ == "__main__":
    sys.exit(main())
