"""Counter-based Philox4x32-10, the plain PyTorch version.

Counterpart of ``repro.core.rng``.  ``philox4x32(counter, key)`` is a pure
function of a 4-lane uint32 counter and a 2-lane uint32 key, with the
cuRAND skip-ahead layout: the kernels of this package draw with counter
``(offset, 0, site index, 0)``, so any (half-sweep, site) pair addresses
its own 128-bit block.  The CUDA device function in ``csrc/philox.cuh``
computes the same bits.

The counter's lane c1 names the stream, so that no two streams of the
package can draw one block (key ``seed_keys(seed)`` in each):

* c1 = 0: the sweeps of every Metropolis engine, 2D and 3D, at
  ``(offset, 0, site, 0)``;
* c1 = 1: the fresh init (``lattice.init_row_chunks``), at
  ``(0, 1, site, q)``;
* c1 = 2: Wolff.  Cluster ``c = step_count + i`` draws its seed site at
  ``(c, 2, 0, 0)`` and its bond tests at BFS depth d at
  ``(c, 2, site, d + 1)``;
* c1 = 3: the spin glass's couplings at ``(0, 3, site, 0)``: lane 0
  gives ``j_up``, lane 1 ``j_left``.

``offset`` is ``half_sweep_offset``'s, ``site`` a flat index (in the
compact colour plane for the 2D sweeps, the spin glass's too; in the
whole lattice for the init, the couplings, Wolff and the 3D sweeps) and
``q`` the init's replica group.  The JAX package
draws ``basic``, ``spinglass``, ``wolff`` and the single-device 3D model
from ``jax.random``, which this package cannot reproduce; it draws them
from these lanes instead.

uint32 values travel in int64 tensors masked with ``0xFFFFFFFF``:
PyTorch on the CPU implements neither shifts, ``+`` nor ``<`` for
``torch.uint32``.  Products use 16-bit limbs, because the int64 product
of two uint32 values can leave the signed 64-bit range.
"""
from __future__ import annotations

import torch

PHILOX_M0 = 0xD2511F53
PHILOX_M1 = 0xCD9E8D57
PHILOX_W0 = 0x9E3779B9
PHILOX_W1 = 0xBB67AE85

MASK32 = 0xFFFFFFFF
_LO16 = 0xFFFF

#: counter lane c1 of each stream (the table above)
SWEEP_LANE = 0
INIT_LANE = 1
WOLFF_LANE = 2
COUPLING_LANE = 3

#: half-sweeps per full lattice sweep -- the unit of the Philox offset.
#: Every sweep loop of the package, host-side and in-kernel, advances its
#: offset with :func:`half_sweep_offset`.
HALF_SWEEPS_PER_SWEEP = 2


def chunk_limit(limit: int, device) -> int:
    """Elements a chunk of a plain version's Philox temporaries: ``limit``,
    or the whole plane on the meta device, which holds no memory (the
    dry-run counts the same work in one chunk's ops)."""
    return 1 << 62 if torch.device(device).type == "meta" else limit


def half_sweep_offset(start_offset: int, sweep: int, color: int) -> int:
    """Philox offset of half-sweep ``color`` (0 = black, 1 = white) of
    full sweep ``sweep`` past a cumulative ``start_offset`` (in
    half-sweep units), with uint32 wrap-around as in cuRAND."""
    return (int(start_offset) + HALF_SWEEPS_PER_SWEEP * int(sweep)
            + int(color)) & MASK32


def _u32(x, device=None) -> torch.Tensor:
    if isinstance(x, torch.Tensor):
        return x.to(torch.int64) & MASK32
    return torch.tensor(int(x) & MASK32, dtype=torch.int64, device=device)


def _mulhilo32(a, b):
    """32x32 -> (hi, lo) of uint32 values held in int64, via 16-bit limbs;
    where ``a`` is a Python int (a Philox multiplier) only ``b`` is split,
    each 16 x 32-bit product fitting 48 bits."""
    if isinstance(a, int):
        p0 = (b & _LO16) * a
        p1 = (b >> 16) * a
        return (p1 + (p0 >> 16)) >> 16, (((p1 & _LO16) << 16) + p0) & MASK32
    a0 = a & _LO16
    a1 = a >> 16
    b0 = b & _LO16
    b1 = b >> 16
    a0b0 = a0 * b0
    a0b1 = a0 * b1
    a1b0 = a1 * b0
    a1b1 = a1 * b1
    mid = (a0b1 & _LO16) + (a1b0 & _LO16) + (a0b0 >> 16)
    hi = (a1b1 + (a0b1 >> 16) + (a1b0 >> 16) + (mid >> 16)) & MASK32
    lo = ((mid << 16) | (a0b0 & _LO16)) & MASK32
    return hi, lo


def philox4x32(c0, c1, c2, c3, k0, k1, rounds: int = 10):
    """Philox4x32-``rounds`` on broadcastable uint32 values (int64 tensors
    or Python ints).  Returns 4 int64 tensors holding uint32 values."""
    device = next((x.device for x in (c0, c1, c2, c3, k0, k1)
                   if isinstance(x, torch.Tensor)), None)
    c0, c1, c2, c3, k0, k1 = (_u32(x, device)
                              for x in (c0, c1, c2, c3, k0, k1))
    for r in range(rounds):
        if r > 0:
            # the key schedule adds W0/W1 before every round but the first
            k0 = (k0 + PHILOX_W0) & MASK32
            k1 = (k1 + PHILOX_W1) & MASK32
        hi0, lo0 = _mulhilo32(PHILOX_M0, c0)
        hi1, lo1 = _mulhilo32(PHILOX_M1, c2)
        c0, c1, c2, c3 = hi1 ^ c1 ^ k0, lo1, hi0 ^ c3 ^ k1, lo0
    return c0, c1, c2, c3


def seed_keys(seed: int):
    """Split a 64-bit seed into the two Philox key lanes ``(k0, k1)``."""
    seed = int(seed)
    return seed & MASK32, (seed >> 32) & MASK32


def u32_to_uniform(bits: torch.Tensor) -> torch.Tensor:
    """uint32 (in int64) -> float32 in [0, 1]: round to nearest, then
    times 2^-32.  ``0xFFFFFFFF`` rounds to 1.0, as in JAX and cuRAND's
    ``__uint2float_rn``."""
    return bits.to(torch.float32) * 2.3283064365386963e-10
