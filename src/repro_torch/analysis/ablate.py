"""Time edited copies of ``tensorcore_update``'s kernel, and of the
multispin and bitplane k-sweep kernels, on the card.

    PYTHONPATH=src python -m repro_torch.analysis.ablate [parts] [tiles]
    PYTHONPATH=src python -m repro_torch.analysis.ablate multispin bitplane

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
(:func:`time_sweeps`), beside the whole kernel: each with one part of
the word loop's work taken out (:data:`MULTISPIN_ABLATIONS`: ``philox``,
the draws a multiply-add of the word index; ``accept``, the threshold
loads and compares replaced by XORs; ``plane loads``, the neighbour
words made from the word's address; ``staging``, no tile read from
device memory; ``sweeps``, no half-sweep, the staging and write-back
alone) or its predicated OR replaced by the C compare, which the
compiler turns into a select and an add (``select``).

``bitplane``: the same for ``csrc/bitplane.cu``'s group loop, timed as
``bitplane_sweeps_resident`` on the main path's (16384, 8192) planes at
T = 3.0 (the three-threshold accept) and the planner's plan
(:data:`BITPLANE_ABLATIONS`: ``philox``, the group's draws a few
multiplies and XORs of its address; ``accept``, the class masks and
predicated XORs replaced by two XORs; ``plane loads``, the neighbour
words made from the group's address; ``staging``; ``sweeps``).

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
#: (old, new) source edits of ``csrc/bitplane.cu``'s group loop
BITPLANE_ABLATIONS = {
    "philox": [("""      r = philox.lanes(row_base + static_cast<uint32_t>(gc0 + q));""",
                """      r = make_uint4(c * 0x9E3779B9u, c ^ 0x85EBCA6Bu,
                     c * 0xC2B2AE35u, c ^ 0x27D4EB2Fu);"""),
               ("""      r = philox.lanes(row_base +
                       static_cast<uint32_t>(wrap_near(gc0 + q, groups)));""",
                """      r = make_uint4(c * 0x9E3779B9u, c ^ 0x85EBCA6Bu,
                     c * 0xC2B2AE35u, c ^ 0x27D4EB2Fu);""")],
    "accept": [("""    const uint32_t m8 = (t & n2) | ~(t | n0 | n1 | n2);
    const uint32_t m4 = n0 & ~(t ^ n1);
    uint32_t out = t;
    xor_below(out, draw, 0xFFFFFFFFu, ~(m4 | m8));
    xor_below(out, draw, t4, m4);
    xor_below(out, draw, t8, m8);
    return out;""", """    return t ^ (n0 & draw) ^ n1 ^ n2;""")],
    "plane loads": [("""    const uint4 cv = *reinterpret_cast<const uint4*>(op + c);
    const uint4 uv = *reinterpret_cast<const uint4*>(op + c - tile.pitch);
    const uint4 dv = *reinterpret_cast<const uint4*>(op + c + tile.pitch);
    const uint4 sv = kPlus ? make_uint4(cv.y, cv.z, cv.w, op[c + kGroup])
                           : make_uint4(op[c - 1], cv.x, cv.y, cv.z);""",
                     """    const uint32_t a = static_cast<uint32_t>(c) * 2654435761u;
    const uint4 cv = make_uint4(a, a >> 3, a >> 5, a >> 7);
    const uint4 uv = make_uint4(a ^ 1u, a ^ 2u, a ^ 3u, a ^ 4u);
    const uint4 dv = make_uint4(a + 1u, a + 2u, a + 3u, a + 4u);
    const uint4 sv = make_uint4(a << 1, a << 2, a << 3, a << 4);""")],
    "staging": [("""  load_tile<kShard>(b_in, w_in, gidx, lane, s_b, s_w, s_g, s_aligned, tile,
                    vec);
""", "")],
    "sweeps": [("""        half_sweep<kShard, kThree, false>(tgt, op, index, tile, m, color,
                                          offset, keys, philox, acc);""", ""),
               ("""        half_sweep<kShard, kThree, true>(tgt, op, index, tile, m, color,
                                         offset, keys, philox, acc);""", "")],
}
#: the k-sweep kernels' loop ablations, by family
LOOP_ABLATIONS = {"multispin": MULTISPIN_ABLATIONS,
                  "bitplane": BITPLANE_ABLATIONS}
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


def loop_source(family: str, name: str) -> str:
    """``csrc/<family>.cu`` with the loop ablation ``name`` of
    :data:`LOOP_ABLATIONS` applied."""
    source = (_build.CSRC_DIR / f"{family}.cu").read_text()
    for old, new in LOOP_ABLATIONS[family][name]:
        if old not in source:
            raise RuntimeError(f"ablation {name!r} no longer applies to "
                               f"csrc/{family}.cu")
        source = source.replace(old, new)
    return source


def time_sweeps(family: str, lib) -> float:
    """ms per launch of ``lib``'s k-sweep kernel of ``family`` (a build
    of ``csrc/<family>.cu`` or of a copy) at the main path's planes,
    temperature and the planner's plan, launched as the family's
    ``*_sweeps_resident`` launches it."""
    from repro_torch.kernels import resident
    from repro_torch.kernels._words import declare, launch_resident
    n, w = tune_resident.FULL_PLANE[family]
    plan = resident.plan_resident(family, n, n)
    b, wp = tune_resident.random_planes(family, n, w, 1)
    thresholds = tune_resident.acceptance(family)
    declare(lib, family)
    counter = types.SimpleNamespace(launches=0, general_launches=0,
                                    __name__=f"{family}_sweeps_resident")
    return tune_resident.timed_ms(lambda: launch_resident(
        lib, family, counter, b, wp, [thresholds], n_sweeps=plan.k,
        seeds=[2 ** 33 + 5], start_offset=0, plan=plan), reps=8)


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("what", nargs="*",
                        choices=("parts", "tiles", *LOOP_ABLATIONS),
                        help="what to time (default: parts and tiles)")
    args = parser.parse_args(argv)
    what = args.what or ["parts", "tiles"]
    if not torch.cuda.is_available():
        print("ablate: no CUDA device", file=sys.stderr)
        return 1
    results = {family: _time_loop_copies(family)
               for family in LOOP_ABLATIONS if family in what}
    what = [w for w in what if w not in LOOP_ABLATIONS]
    if not what:
        _report(results)
        return 0
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


def _time_loop_copies(family: str) -> dict:
    """ms per launch of the whole k-sweep kernel of ``family`` and of each
    copy of its :data:`LOOP_ABLATIONS`."""
    dirs = _copy_dirs(family, {
        ("with the compiler's select" if name == "select"
         else f"without {name}"): loop_source(family, name)
        for name in LOOP_ABLATIONS[family]})
    results = {"whole": time_sweeps(family, _build.load(family))}
    for label, csrc in dirs.items():
        results[label] = time_sweeps(family, _build.load(family, csrc))
        print(f"{family}_sweeps_resident {label}: {results[label]:.4f} ms "
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
