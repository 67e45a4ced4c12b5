"""Time edited copies of ``tensorcore_update``'s kernel, and of the
multispin k-sweep kernel, on the card.

    PYTHONPATH=src python -m repro_torch.analysis.ablate [parts] [tiles]
    PYTHONPATH=src python -m repro_torch.analysis.ablate multispin

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

``multispin``: copies of ``csrc/multispin.cu`` timed as
``multispin_sweeps_resident`` on the main path's (32768, 2048) word
planes at the planner's plan, ms per launch of 2 sweeps
(:func:`time_multispin`), beside the whole kernel: each with one part of
the word loop's work taken out (:data:`MULTISPIN_ABLATIONS`: ``philox``,
the draws a multiply-add of the word index; ``accept``, the threshold
loads and compares replaced by XORs; ``plane loads``, the neighbour
words made from the word's address; ``staging``, no tile read from
device memory; ``sweeps``, no half-sweep, the staging and write-back
alone) or its predicated OR replaced by the C compare, which the
compiler turns into a select and an add (``select``).

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
import types

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
#: (old, new) source edits of ``csrc/multispin.cu``'s word loop
MULTISPIN_ABLATIONS = {
    "philox": [("  philox(widx, draw);\n",
                "  for (int q = 0; q < 8; ++q) draw[q] = widx * 0x9E3779B9u + q;\n")],
    "accept": [("""    const uint2 thr = *reinterpret_cast<const uint2*>(s_table + at);
    flip_below(flip, draw[2 * b], thr.x, 1u << (2 * kNibble * b));
    flip_below(flip, draw[2 * b + 1], thr.y, 1u << (2 * kNibble * b + 4));""",
                "    flip ^= draw[2 * b] ^ draw[2 * b + 1] ^ at;")],
    "plane loads": [("""  const uint32_t centre = op[c];
  const uint32_t side = kPlus
                            ? __funnelshift_r(centre, op[c + 1], kNibble)
                            : __funnelshift_l(op[c - 1], centre, kNibble);
  // per nibble: s * 8 + the count of up neighbours
  const uint32_t key = (op[c - pitch] + op[c + pitch] + centre + side) |""",
                     """  const uint32_t centre =
      (static_cast<uint32_t>(c) * 2654435761u) & 0x11111111u;
  const uint32_t side = centre >> 4;
  const uint32_t key = ((centre << 4) + (centre >> 8) + centre + side) |""")],
    "staging": [("  load_tile<kShard>(b_in, w_in, widx, s_b, s_w, s_g, tile, "
                 "words && inside);\n", "")],
    "sweeps": [("        half_sweep<kShard, false>(tgt, op, s_g, tile, m, "
                "color, philox, smem);", ""),
               ("        half_sweep<kShard, true>(tgt, op, s_g, tile, m, "
                "color, philox, smem);", "")],
    "select": [("""  asm("{\\n"
      "  .reg .pred p;\\n"
      "  setp.lt.u32 p, %1, %2;\\n"
      "  @p or.b32 %0, %0, %3;\\n"
      "}"
      : "+r"(flip)
      : "r"(draw), "r"(threshold), "r"(bit));""",
                "  if (draw < threshold) flip |= bit;")],
}
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


def multispin_source(name: str) -> str:
    """``csrc/multispin.cu`` with multispin ablation ``name`` applied."""
    source = (_build.CSRC_DIR / "multispin.cu").read_text()
    for old, new in MULTISPIN_ABLATIONS[name]:
        if old not in source:
            raise RuntimeError(f"ablation {name!r} no longer applies to "
                               f"csrc/multispin.cu")
        source = source.replace(old, new)
    return source


def time_multispin(lib) -> float:
    """ms per launch of ``lib``'s multispin k-sweep kernel (a build of
    ``csrc/multispin.cu`` or of a copy) at the main path's word planes and
    the planner's plan, launched as ``multispin_sweeps_resident``
    launches it."""
    from repro_torch.kernels import resident
    from repro_torch.kernels._words import (declare, key_table_arg,
                                            launch_resident)
    n, w = tune_resident.FULL_PLANE["multispin"]
    plan = resident.plan_resident("multispin", n, n)
    b, wp = tune_resident.random_planes("multispin", n, w, 1)
    table = key_table_arg(tune_resident.acceptance("multispin"))
    declare(lib, "multispin")
    counter = types.SimpleNamespace(launches=0,
                                    __name__="multispin_sweeps_resident")
    return tune_resident.timed_ms(lambda: launch_resident(
        lib, lib.multispin_sweeps_resident_launch, counter, b, wp, table,
        n_sweeps=plan.k, seed=2 ** 33 + 5, start_offset=0, plan=plan),
        reps=8)


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("what", nargs="*",
                        choices=("parts", "tiles", "multispin"),
                        help="what to time (default: parts and tiles)")
    args = parser.parse_args(argv)
    what = args.what or ["parts", "tiles"]
    if not torch.cuda.is_available():
        print("ablate: no CUDA device", file=sys.stderr)
        return 1
    if "multispin" in what:
        results = {"multispin": _time_multispin_copies()}
        if what == ["multispin"]:
            _report(results)
            return 0
        what = [w for w in what if w != "multispin"]
    else:
        results = {}
    sources = {}
    if "parts" in what:
        sources.update({f"without {name}": ablated_source(name)
                        for name in ABLATIONS})
    if "tiles" in what:
        sources.update({f"tile {r}x{c}": tiled_source(r, c)
                        for r, c in TILES})
    dirs = _copy_dirs("tensorcore", sources)
    from repro_torch.kernels.tensorcore import tensorcore as tcm
    results["whole"] = tune_resident.tune_tensorcore()
    for label, csrc in dirs.items():
        results[label] = tune_resident.tune_tensorcore(
            lib=tcm.library(csrc_dir=csrc))
        print(f"tensorcore_update {label}: {results[label]:.4f} ms per "
              f"half-sweep (whole kernel {results['whole']:.4f})",
              flush=True)
    _report(results)
    return 0


def _copy_dirs(family: str, sources: dict) -> dict:
    """``{label: directory}`` of each edited copy of
    ``csrc/<family>.cu``, beside the headers, under the build directory;
    all built at once with the package's own library."""
    dirs = {}
    for i, (label, source) in enumerate(sources.items()):
        csrc = _build.BUILD_DIR / f"ablate-{family}-{i}"
        csrc.mkdir(parents=True, exist_ok=True)
        for header in _build.CSRC_DIR.glob("*.cuh"):
            shutil.copy(header, csrc / header.name)
        (csrc / f"{family}.cu").write_text(source)
        dirs[label] = csrc
    with concurrent.futures.ThreadPoolExecutor(len(dirs) + 1) as pool:
        builds = [pool.submit(_build.build, [family])]
        builds += [pool.submit(_build.build, [family], d)
                   for d in dirs.values()]
        for b in builds:
            b.result()
    return dirs


def _time_multispin_copies() -> dict:
    """ms per launch of the whole multispin k-sweep kernel and of each
    copy of :data:`MULTISPIN_ABLATIONS`."""
    dirs = _copy_dirs("multispin", {
        ("with the compiler's select" if name == "select"
         else f"without {name}"): multispin_source(name)
        for name in MULTISPIN_ABLATIONS})
    results = {"whole": time_multispin(_build.load("multispin"))}
    for label, csrc in dirs.items():
        results[label] = time_multispin(_build.load("multispin", csrc))
        print(f"multispin_sweeps_resident {label}: {results[label]:.4f} ms "
              f"per launch (whole kernel {results['whole']:.4f})",
              flush=True)
    return results


def _report(results: dict) -> None:
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], check=True, capture_output=True,
        text=True).stdout.strip().splitlines()[0])
    print(json.dumps(results))


if __name__ == "__main__":
    sys.exit(main())
