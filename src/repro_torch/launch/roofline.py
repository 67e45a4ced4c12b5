"""The Ising sweep kernels' analytic flip-cost model and the card's figures
(counterpart of the Ising half of ``repro.launch.roofline``).

:data:`ISING_FLIP_COSTS` is the per-engine bytes/flip and ops/flip of one
attempted Metropolis update, derived from each engine's state layout: the
JAX package's nine rows, unchanged.  :func:`pct_of_roofline` divides a
measured flips/ns by the bound the backend's peaks admit, so a perf row
says how far from the hardware limit it ran.

The card's figures (NVIDIA H100 SXM: SMs, clocks, per-clock pipe rates,
HBM bandwidth) live here as named constants: the ``"cuda"`` row of
:data:`BACKEND_PEAKS` is derived from them, and so are ``chip_smoke.py``'s
kernel bounds.  The ``"cuda"`` row's ``flops`` is the dense bf16
tensor-core peak, as the JAX package's TPU row takes its matrix peak: it
is the rate no engine's flip can beat, so no reading exceeds 100 %.

    from repro_torch.launch import roofline
    roofline.pct_of_roofline(867.94, "multispin_pallas", "cuda", k=2)
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Optional

#: NVIDIA H100 SXM (data sheet; CUDA C++ Programming Guide, compute
#: capability 9.0): streaming multiprocessors and the boost clock at
#: which the data sheet states its peaks (``nvidia-smi`` reads the max
#: SM clock, 1980 MHz, on the cards of this study)
H100_SMS = 132
H100_BOOST_MHZ = 1830
#: HBM3 bandwidth, bytes/s
H100_HBM_BYTES_PER_S = 3.35e12
#: results per clock per SM: 32-bit integer multiply 64 (FMA pipe), add,
#: logic and compare 64 (ALU pipe), type conversions 16 (XU pipe); dense
#: bf16 FLOP on the tensor cores 4096 (989 TFLOP/s on the data sheet is
#: 4096 a clock on each of 132 SMs at 1830 MHz)
H100_PIPE_PER_CLOCK_PER_SM = {"fma": 64, "alu": 64, "xu": 16,
                              "tensor": 4096}
#: four schedulers per SM, each dispatching one warp instruction a clock
H100_DISPATCH_PER_CLOCK_PER_SM = 4 * 32
#: dense bf16 tensor-core FLOP/s: 989.4e12
H100_BF16_FLOPS = (H100_PIPE_PER_CLOCK_PER_SM["tensor"] * H100_SMS
                   * H100_BOOST_MHZ * 1e6)

#: Nominal peak (flops/s, memory bytes/s) per backend, used to turn a
#: measured flips/ns into a %-of-roofline.  ``cuda`` is the H100 above;
#: ``cpu`` is the JAX package's nominal single core (~100 f32 GFLOP/s
#: peak SIMD+FMA, ~25 GB/s single-core stream BW), an order of magnitude
#: for attribution, not a measured STREAM run.
BACKEND_PEAKS: Dict[str, Dict[str, float]] = {
    "cuda": {"flops": H100_BF16_FLOPS, "mem_bw": H100_HBM_BYTES_PER_S},
    "cpu": {"flops": 100e9, "mem_bw": 25e9},
}


@dataclass(frozen=True)
class FlipCost:
    """Analytic cost of ONE attempted (replica-)flip for an engine.

    ``bytes_per_flip`` is the memory traffic of a half-sweep colour
    update divided by the updates it performs: read target plane + read
    opposite plane + write target plane, at the engine's packing
    density.  ``flops_per_flip`` counts the arithmetic of the accept
    decision (neighbour reduction + threshold compare + Philox share).
    ``replicas`` is how many replica-spins one lattice site carries
    (bitplane packs 32): flips/ns rows for those engines already count
    replica-flips, so the cost here is *per replica-flip*.
    """

    bytes_per_flip: float
    flops_per_flip: float
    replicas: int = 1


#: Derivations (3 planes touched per half-sweep; density = bytes/site):
#: * int8 colour planes (basic/basic_philox/stencil_pallas): 1 B/site
#:   -> 3 B/flip; ~10 ops (4 neighbour adds, couple, threshold, Philox
#:   share) per flip.
#: * nibble multispin: 8 spins/uint32 word = 0.5 B/site -> 1.5 B/flip;
#:   word-parallel ops amortize to ~4/flip.
#: * bitplane: 32 replicas/word = 0.125 B/replica-site -> 0.375
#:   B/replica-flip; the 8-op CSA + 10-class threshold per word serves
#:   32 replicas -> ~1.25 ops/replica-flip.
#: * tensorcore: 4 int8 quarter-planes, all read + one written per
#:   plane update -> 5 B/flip; the banded neighbour matmul does ~2*64
#:   MACs per spin at the default block.
#: * spinglass: int8 lattice read/write + 2 quenched coupling planes
#:   -> 5 B/flip; coupling multiplies add ~4 ops.
ISING_FLIP_COSTS: Dict[str, FlipCost] = {
    "basic": FlipCost(3.0, 10.0),
    "basic_philox": FlipCost(3.0, 10.0),
    "stencil_pallas": FlipCost(3.0, 10.0),
    "multispin": FlipCost(1.5, 4.0),
    "multispin_pallas": FlipCost(1.5, 4.0),
    "bitplane": FlipCost(0.375, 1.25, replicas=32),
    "bitplane_pallas": FlipCost(0.375, 1.25, replicas=32),
    "tensorcore": FlipCost(5.0, 128.0),
    "spinglass": FlipCost(5.0, 14.0),
}


def flip_cost(engine: str) -> FlipCost:
    """The flip-cost model row for ``engine`` (KeyError when unmodeled,
    e.g. ``wolff``: a cluster flip is not a sweep flip)."""
    return ISING_FLIP_COSTS[engine]


def roofline_flips_per_ns(engine: str, backend: str,
                          k: int = 1) -> Optional[float]:
    """Peak attempted flips/ns the backend's roofline admits.

    ``min(mem_bw / bytes_per_flip, flops / flops_per_flip)``.  ``k`` is
    the resident tier's sweeps per dispatch: a k-sweep block crosses
    memory once instead of k times, dividing bytes/flip by k; the
    arithmetic is unchanged.  Returns None for engines or backends
    outside the model.
    """
    peaks = BACKEND_PEAKS.get(backend)
    cost = ISING_FLIP_COSTS.get(engine)
    if peaks is None or cost is None:
        return None
    mem_bound = peaks["mem_bw"] / (cost.bytes_per_flip / max(k, 1))
    compute_bound = peaks["flops"] / cost.flops_per_flip
    return min(mem_bound, compute_bound) / 1e9


def pct_of_roofline(flips_per_ns: float, engine: str, backend: str,
                    k: int = 1) -> Optional[float]:
    """Measured flips/ns as a percentage of the backend's roofline
    bound for this engine (None outside the model)."""
    peak = roofline_flips_per_ns(engine, backend, k=k)
    if peak is None or peak <= 0.0:
        return None
    return 100.0 * flips_per_ns / peak
