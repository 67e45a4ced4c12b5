"""The least time an NVIDIA H100 SXM needs for a window's attempted flips.

A frozen yardstick: the work is counted from the semantics of the
update (``bench/reference/ising.py``), never from a kernel's
instructions, and the rates are the data sheet's, so that no kernel of
any design reads more than 100 %.

Rates (NVIDIA H100 SXM, the CUDA C++ Programming Guide's throughput
table for compute capability 9.0): 132 SMs at the 1980 MHz maximum SM
clock; per SM and clock, 64 results of a 32-bit integer multiply on the
FMA pipe, counting a multiply that gives both halves of the 64-bit
product (or its high half alone) as one; 64 results of 32-bit integer
logic, add, shift and compare on the ALU pipe; HBM at 3.35e12 B/s.  The
pipes and the memory work at once, so the least time is the largest of
the three.

Work (a family's file in ``bench/families/``, per update, which is a
word of ``sites_per_update`` sites):

* Philox4x32-10, as the counter layout makes each update need it once
  the work that consecutive counters share is shared.  A round takes two
  wide multiplies, of lanes x and z, and two three-input XORs.  The
  offset lane c0 is the same for every site of a half-sweep, so round
  0's product of it and round 1's product of its lane z are computed
  once for the whole plane; so are the XORs that read only them.
  - stencil (lane 0 a site, counter ``(off, 0, site, 0)``): rounds 0
    and 1 one product each, rounds 2 to 8 two, round 9 one (lane 0
    needs only ``hi(M1 z)``): 16 wide multiplies and round 8's one
    low-half product, 17 FMA-pipe results; 17 XORs.
  - multispin (two calls a word, counters ``(2 off, 0, w, 0)`` and
    ``(2 off + 1, 0, w, 0)``, all 8 lanes used): round 0's product of
    ``w`` and round 1's product of lane x are the same for both calls;
    each call then takes 2 in each of rounds 2 to 9: 2 + 2 x 16 = 34;
    XORs 1 + 2 x 18 = 37.
  - bitplane (one call for each 4 sites, counter ``(off, 0, s // 4,
    0)``): 18 products and 19 XORs a call, a quarter of that a site.
* The neighbour sum and the accept, in the least operations known to
  compute them (all on the ALU pipe): stencil 2 adds, 1 compare and 1
  select a site; multispin 1 funnel shift and 2 three-input adds a word
  (the 8 sums in nibbles), then per site 1 table index, 1 compare and 1
  merge into the flip word, and 1 XOR a word to apply it; bitplane 5
  three-input logic operations of a carry-save count of all 32
  replicas, 4 for the class masks of a ferromagnet's three thresholds,
  then 1 compare and 1 masked merge for each of the three.
* Bytes: the state read once and written once a timed call.
"""
from __future__ import annotations

import json
from pathlib import Path

SMS = 132
SM_CLOCK_HZ = 1980e6
FMA_PER_CLOCK_PER_SM = 64
ALU_PER_CLOCK_PER_SM = 64
HBM_BYTES_PER_S = 3.35e12

FAMILIES = Path(__file__).resolve().parent / "families"


def family(name: str) -> dict:
    """A family's work counts (``bench/families/<name>.json``)."""
    with open(FAMILIES / f"{name}.json") as f:
        return json.load(f)


def clocks_per_update(counts: dict) -> float:
    """SM clocks one update needs at the busier pipe."""
    return max(counts["fma"] / FMA_PER_CLOCK_PER_SM,
               counts["alu"] / ALU_PER_CLOCK_PER_SM)


def least_seconds(counts: dict, flips: float, state_bytes: float,
                  calls: int, chips: int) -> float:
    """The least time ``chips`` cards need for ``flips`` attempted
    (replica-)flips in ``calls`` timed calls over ``state_bytes`` of
    state, the work split evenly."""
    updates = flips / (counts["sites_per_update"] * counts["replicas"])
    t_ops = updates * clocks_per_update(counts) / (SMS * SM_CLOCK_HZ)
    t_bytes = 2 * state_bytes * calls / HBM_BYTES_PER_S
    return max(t_ops, t_bytes) / chips
