"""The Ising sweep kernels' analytic flip-cost model, the card's figures,
and the dry-run's counts and roofline terms (counterpart of
``repro.launch.roofline``).

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

The dry-run half (:func:`roofline_terms`, :func:`model_flops`,
:func:`count_params`, :class:`OpCounter`, :func:`memory_per_device`,
:func:`collective_bytes`) takes the place of what JAX reads from a
compiled module: where JAX asks XLA for ``cost_analysis()`` and
``memory_analysis()`` and parses the partitioned HLO for collectives,
the port runs the step on meta tensors under :class:`OpCounter` and
derives the memory and the collectives from the partition specs
(``repro_torch.train.sharding``).  It never produces HLO, so JAX's HLO
parser has no counterpart here.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Iterable, Optional, Tuple

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten

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
#: NVLink 4 bytes/s of one direction of one card: the H100 SXM data
#: sheet's 900 GB/s is both directions together.  Cards in different
#: nodes talk over NDR InfiniBand, some 50 GB/s a card: the collective
#: term does not model those slower links (a (16, 16) mesh spans 32
#: nodes of 8 cards)
H100_NVLINK_BYTES_PER_S = 450e9

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


# ---------------------------------------------------------------------------
# the dry-run: roofline terms, parameter counts, counted cost, collectives
# ---------------------------------------------------------------------------

def roofline_terms(flops: float, byts: float, coll: Dict[str, int],
                   n_chips: int) -> Dict[str, float]:
    """The three roofline terms of one device's step on the H100 row:
    ``flops`` over the dense bf16 peak, ``byts`` over the HBM bandwidth,
    the collectives' bytes over one direction of NVLink.  Each input is
    already per device (``n_chips`` is the JAX signature's, unused)."""
    coll_total = float(sum(coll.values()))
    t_compute = flops / H100_BF16_FLOPS
    t_memory = byts / H100_HBM_BYTES_PER_S
    t_coll = coll_total / H100_NVLINK_BYTES_PER_S
    dom = max((t_compute, "compute"), (t_memory, "memory"),
              (t_coll, "collective"))[1]
    return {"t_compute_s": t_compute, "t_memory_s": t_memory,
            "t_collective_s": t_coll, "dominant": dom,
            "coll_bytes": coll_total}


def model_flops(n_params_active: float, n_tokens: float,
                kind: str) -> float:
    """6ND for a train step, 2ND for forward-only (prefill/decode)."""
    return (6.0 if kind == "train" else 2.0) * n_params_active * n_tokens


def count_params(params, active_moe_frac: float = 1.0,
                 moe_paths=("moe/wi", "moe/wg", "moe/wo")
                 ) -> Dict[str, float]:
    """(total, active) parameter counts of a port ``Params`` tree (on any
    device, meta too), paths ``/``-separated as in JAX: a routed
    expert's weight counts ``active_moe_frac`` of itself, the embedding
    nothing (its lookups are gathers, not products)."""
    total = 0.0
    active = 0.0
    for name, leaf in params.named_parameters():
        key = name.replace(".", "/")
        n = float(leaf.numel())
        total += n
        if any(p in key for p in moe_paths):
            active += n * active_moe_frac
        elif "embed" in key:
            active += 0.0
        else:
            active += n
    return {"total": total, "active": active}


#: ops that move, create or reinterpret data and do no arithmetic: 0 FLOP
#: (their bytes count); views are skipped altogether
_NO_ARITHMETIC = frozenset((
    "copy_", "clone", "cat", "stack", "index", "index_select", "gather",
    "slice_scatter", "select_scatter", "as_strided_scatter", "empty",
    "empty_like", "empty_strided", "new_empty", "new_empty_strided",
    "zeros", "zeros_like", "new_zeros", "ones", "ones_like", "new_ones",
    "full", "full_like", "new_full", "fill_", "zero_", "arange",
    "scalar_tensor", "lift_fresh", "lift_fresh_copy", "_unsafe_view",
    "constant_pad_nd", "repeat", "embedding", "_local_scalar_dense",
    "_to_copy", "detach", "contiguous"))

#: ops that allocate without writing: neither FLOP nor bytes
_ALLOCATES = frozenset(("empty", "empty_like", "empty_strided",
                        "new_empty", "new_empty_strided"))


def _is_view(func) -> bool:
    return any(r.alias_info is not None and not r.alias_info.is_write
               for r in func._schema.returns)


def _written(func, args, kwargs) -> list:
    """The tensors an in-place or ``out=`` op writes (it returns none)."""
    out = []
    for arg, value in zip(func._schema.arguments,
                          list(args) + [kwargs.get(a.name) for a in
                                        func._schema.arguments[len(args):]]):
        if arg.alias_info is not None and arg.alias_info.is_write:
            out += [t for t in tree_flatten(value)[0]
                    if isinstance(t, torch.Tensor)]
    return out


def _nbytes(tensors: Iterable) -> int:
    return sum(t.numel() * t.element_size() for t in tensors
               if isinstance(t, torch.Tensor))


class OpCounter(TorchDispatchMode):
    """Counts the work of every ATen op run under it, on any device (the
    meta device too, where nothing is computed): ``flops`` and
    ``bytes``, and ``ops``, the ops counted.

    * flops: ``torch.utils.flop_counter``'s formulas for products,
      convolutions and attention kernels (2 a multiply-add), plus one a
      output element of every other op that does arithmetic: XLA's
      convention for element-wise work.  Ops that only move, create or
      cast data count none.
    * bytes: every tensor input and output of every op, once each, in
      place ops' written tensors as outputs.  Nothing is fused, so this
      is an upper bound on what XLA's fused module reports as "bytes
      accessed".  Views move nothing and count nothing; allocations
      neither.

    ``with OpCounter() as c: step(...)``; then ``c.flops``, ``c.bytes``,
    and ``c.by_op``, each op's (count, flops) by name.  The ops the card
    runs are the ops meta runs: the same count.
    """

    def __init__(self):
        super().__init__()
        self.flops = 0
        self.bytes = 0
        self.ops = 0
        self.by_op: Dict[str, list] = {}

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        from torch.utils.flop_counter import flop_registry
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        name = func.overloadpacket.__name__
        if _is_view(func) or name in _ALLOCATES:
            return out
        outs = [t for t in tree_flatten(out)[0]
                if isinstance(t, torch.Tensor)]
        if not outs:
            outs = _written(func, args, kwargs)
        packet = func.overloadpacket
        if packet in flop_registry:
            # the formulas take no ``out_dtype`` (``mm.dtype``, ``bmm.dtype``)
            flops = flop_registry[packet](
                *[a for a in args if not isinstance(a, torch.dtype)],
                **kwargs, out_val=out)
        elif name in _NO_ARITHMETIC:
            flops = 0
        else:
            flops = sum(t.numel() for t in outs)
        self.flops += int(flops)
        self.bytes += _nbytes(tree_flatten((args, kwargs))[0]) + _nbytes(outs)
        self.ops += 1
        tally = self.by_op.setdefault(name, [0, 0])
        tally[0] += 1
        tally[1] += int(flops)
        return out


def memory_per_device(arguments: Iterable[Tuple[object, torch.Tensor]],
                      outputs: Iterable[Tuple[object, torch.Tensor]] = (),
                      aliased: Iterable[Tuple[object, torch.Tensor]] = ()
                      ) -> Dict[str, int]:
    """One device's bytes of a step's arguments, outputs and donated
    (aliased) arguments, from the shard shape of each ``(sharding,
    leaf)`` pair: the counterpart of the sizes XLA's
    ``memory_analysis()`` gives.  Its temporaries have none: the port
    never schedules the step's buffers."""
    def size(pairs):
        return int(sum(sh.shard_bytes(leaf) for sh, leaf in pairs))
    return {"argument_size_in_bytes": size(arguments),
            "output_size_in_bytes": size(outputs),
            "alias_size_in_bytes": size(aliased)}


_COLLECTIVES = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all",
                "collective-permute")


def collective_bytes(mesh=None, params: Iterable = (), *, train: bool = False,
                     gathers: int = 1, residual: float = 0.0,
                     sp: bool = False, dispatch: float = 0.0,
                     halo: float = 0.0) -> Dict[str, int]:
    """One device's collective bytes of one step, by kind (JAX's five
    keys), from the partition specs: the operand bytes JAX's HLO parser
    sums (an all-gather's gathered result).  The port lowers nothing, so
    each term is computed, not parsed:

    * ``params``: ``(sharding, leaf)`` of each parameter.  A leaf whose
      spec puts a data axis on a dim (FSDP) is all-gathered
      ``gathers`` times a step (each forward pass; 2 for a train step
      with remat), ``shard bytes x the data axes' size`` each, and in a
      ``train`` step its gradient is reduce-scattered (the same bytes).
      Any other leaf's gradient is all-reduced over the data axes in a
      ``train`` step where they have more than one position: its shard
      bytes.  Gradients take the leaf's dtype.
    * ``residual``: the bytes of the tensor-parallel reductions of the
      residual stream (one a product whose contraction axis is on
      ``model``, a pass): all-reduce, or with ``sp`` an all-gather plus
      a reduce-scatter of the same bytes.
    * ``dispatch``: MoE dispatch and combine bytes, ``all-to-all``.
    * ``halo``: an Ising step's halo exchange, ``collective-permute``.
    """
    out = {k: 0 for k in _COLLECTIVES}
    params = list(params)
    if params:
        from repro_torch.train.sharding import _entry_axes, mesh_axes
        dp_axes, _ = mesh_axes(mesh)
        dp = mesh.axis_size(dp_axes)
        for sh, leaf in params:
            shard = sh.shard_bytes(leaf)
            on = [a for e in sh.spec for a in _entry_axes(e) if a in dp_axes]
            if on:
                full = shard * mesh.axis_size(on)
                out["all-gather"] += gathers * full
                if train:
                    out["reduce-scatter"] += full
            elif train and dp > 1:
                out["all-reduce"] += shard
    if sp:
        out["all-gather"] += residual
        out["reduce-scatter"] += residual
    else:
        out["all-reduce"] += residual
    out["all-to-all"] += dispatch
    out["collective-permute"] += halo
    return {k: int(v) for k, v in out.items()}
