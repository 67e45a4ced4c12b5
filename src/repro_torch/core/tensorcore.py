"""Tensor-core engine: neighbour sums as banded matrix products (paper S3.2).

Counterpart of ``repro.core.tensorcore``.  The lattice is held as four
interleaved planes ``sigma_xy[a, b] = full[2a + x, 2b + y]`` keyed
``'00'``, ``'01'``, ``'10'``, ``'11'`` (black = 00/11, white = 01/10).
Within a ``B x B`` block the neighbour sums of a plane are two products
against the banded matrix ``K`` (ones on the diagonal and the
superdiagonal); the block edges take one value from the adjacent block
(:func:`boundary_corrections`).

This module is the paper's unfused three-pass structure in plain
PyTorch: batched products (``torch.matmul`` in bf16, the values exact),
the boundary pass, the accept.  It is the plain version of the fused
CUDA kernel ``repro_torch.kernels.tensorcore.tensorcore_update``.

The accept is a lookup in ``metropolis.acceptance_table`` (see there),
and the uniforms are an argument: the JAX package draws them from
``jax.random`` keys, which this package does not reproduce; the engine
draws Philox lanes 0/1 as the fused kernel does.
"""
from __future__ import annotations

import torch

from . import lattice as lat
from . import rng

BLOCK = 128  # paper: 256x256 sub-lattices = four 128x128 same-colour blocks

PLANE_KEYS = ("00", "01", "10", "11")

#: the two target planes of each colour, lane 0 then lane 1 of the draw
COLOR_PLANES = {"black": ("00", "11"), "white": ("10", "01")}

#: plane positions per Philox chunk in :func:`philox_uniform_pair`
_CHUNK = 1 << 22


def make_kernel_matrix(block: int = BLOCK, dtype=torch.bfloat16,
                       device=None) -> torch.Tensor:
    """Banded K: ones on the diagonal and the superdiagonal (Eq. 2)."""
    k = torch.eye(block, dtype=dtype, device=device)
    return k + torch.diag(torch.ones(block - 1, dtype=dtype, device=device),
                          1)


def decompose(full: torch.Tensor) -> dict:
    """(N, M) full lattice -> four contiguous (N/2, M/2) planes."""
    return {"00": full[0::2, 0::2].contiguous(),
            "01": full[0::2, 1::2].contiguous(),
            "10": full[1::2, 0::2].contiguous(),
            "11": full[1::2, 1::2].contiguous()}


def recompose(planes: dict) -> torch.Tensor:
    """Inverse of :func:`decompose`."""
    h, w = planes["00"].shape
    full = torch.empty((2 * h, 2 * w), dtype=planes["00"].dtype,
                       device=planes["00"].device)
    full[0::2, 0::2] = planes["00"]
    full[0::2, 1::2] = planes["01"]
    full[1::2, 0::2] = planes["10"]
    full[1::2, 1::2] = planes["11"]
    return full


def init_planes(n: int, m: int, p_up: float, seed: int, device) -> dict:
    """Fresh int8 planes: :func:`decompose` of the package's single-lattice
    init (``lattice.init_row_chunks``), a block of rows at a time."""
    planes = {k: torch.empty((n // 2, m // 2), dtype=torch.int8,
                             device=device) for k in PLANE_KEYS}
    for r0, r1, draws in lat.init_row_chunks(n, m, seed, device):
        full = torch.where(lat.spin_up(draws[0][0], p_up), 1, -1).to(
            torch.int8)
        for k, v in decompose(full).items():   # r0 is even
            planes[k][r0 // 2:r1 // 2] = v
    return planes


def _blk(p: torch.Tensor, b: int) -> torch.Tensor:
    """(H, W) -> (H/b, W/b, b, b) block view."""
    h, w = p.shape
    return p.reshape(h // b, b, w // b, b).transpose(1, 2)


def _unblk(p: torch.Tensor) -> torch.Tensor:
    nb, mb, b, _ = p.shape
    return p.transpose(1, 2).reshape(nb * b, mb * b)


#: per target plane: (right operand plane, K or K^T on its right), (K or
#: K^T on the left, left operand plane) -- the formulas of Eq. 3-6
_PRODUCTS = {
    "00": (("01", "k"), ("kt", "10")),   # s01 K   + K^T s10
    "11": (("10", "kt"), ("k", "01")),   # s10 K^T + K   s01
    "10": (("11", "k"), ("k", "00")),    # s11 K   + K   s00
    "01": (("00", "kt"), ("kt", "11")),  # s00 K^T + K^T s11
}


def local_nn_sums(planes: dict, block: int = BLOCK,
                  keys=PLANE_KEYS) -> dict:
    """Block-local neighbour sums of the planes ``keys`` as batched
    products: bf16 operands (the spins and K are exact), float32 sums."""
    device = planes["00"].device
    k = make_kernel_matrix(block, device=device)
    mats = {"k": k, "kt": k.T}
    blocked = {}

    def blk(key):
        if key not in blocked:
            blocked[key] = _blk(planes[key].to(torch.bfloat16), block)
        return blocked[key]

    out = {}
    for key in keys:
        (right, rm), (lm, left) = _PRODUCTS[key]
        nn = torch.matmul(blk(right), mats[rm]).to(torch.float32)
        nn += torch.matmul(mats[lm], blk(left)).to(torch.float32)
        out[key] = _unblk(nn)
    return out


def boundary_corrections(planes: dict, block: int = BLOCK,
                         keys=PLANE_KEYS) -> dict:
    """Cross-block (and periodic-wrap) terms the block-local sums miss:
    an edge row or column of a block takes one neighbour from the
    adjacent block."""
    h, w = planes["00"].shape
    device = planes["00"].device
    col = torch.arange(w, device=device) % block
    row = torch.arange(h, device=device) % block
    first_c, last_c = (col == 0)[None, :], (col == block - 1)[None, :]
    first_r, last_r = (row == 0)[:, None], (row == block - 1)[:, None]

    def f32(key):
        return planes[key].to(torch.float32)

    def left(key):    # p[a, b-1] with wrap
        return torch.roll(f32(key), 1, dims=1)

    def right(key):
        return torch.roll(f32(key), -1, dims=1)

    def up(key):
        return torch.roll(f32(key), 1, dims=0)

    def down(key):
        return torch.roll(f32(key), -1, dims=0)

    terms = {
        "00": lambda: first_c * left("01") + first_r * up("10"),
        "11": lambda: last_c * right("10") + last_r * down("01"),
        "10": lambda: first_c * left("11") + last_r * down("00"),
        "01": lambda: last_c * right("00") + first_r * up("11"),
    }
    return {key: terms[key]() for key in keys}


def neighbor_sums_tc(planes: dict, block: int = BLOCK,
                     keys=PLANE_KEYS) -> dict:
    """Complete float32 neighbour sums of the planes ``keys``: block-local
    products plus boundary corrections."""
    nn = local_nn_sums(planes, block, keys)
    bc = boundary_corrections(planes, block, keys)
    return {k: nn[k] + bc[k] for k in keys}


def update_color_tc(planes: dict, color: str, uniforms, table,
                    block: int = BLOCK) -> dict:
    """Metropolis half-sweep of ``color``'s two planes with the given
    uniforms (one plane each, in :data:`COLOR_PLANES` order): flip iff
    ``u < table[s, nn]``.  Returns a new dict; the inputs stay as they
    were."""
    targets = COLOR_PLANES[color]
    nn = neighbor_sums_tc(planes, block, targets)
    out = dict(planes)
    for key, u in zip(targets, uniforms):
        t = planes[key]
        index = (t > 0).to(torch.int64) * 5 + (nn[key].to(torch.int64)
                                               + 4) // 2
        accept = table.to(u.device)[index]
        out[key] = torch.where(u < accept, -t, t)
    return out


def philox_uniform_pair(h: int, w: int, seed: int, offset: int, device):
    """The two (h, w) float32 uniform planes of one fused half-sweep:
    lanes 0 and 1 of Philox at counter ``(offset, 0, gi*w + gj, 0)`` with
    key ``(seed mod 2^32, 0)`` -- the fused kernel's key, not
    ``seed_keys``."""
    u = torch.empty((2, h * w), dtype=torch.float32, device=device)
    key = int(seed) & rng.MASK32
    for s0 in range(0, h * w, _CHUNK):
        s1 = min(h * w, s0 + _CHUNK)
        idx = torch.arange(s0, s1, dtype=torch.int64, device=device)
        r = rng.philox4x32(offset, 0, idx & rng.MASK32, 0, key, 0)
        u[0, s0:s1] = rng.u32_to_uniform(r[0])
        u[1, s0:s1] = rng.u32_to_uniform(r[1])
    return u[0].reshape(h, w), u[1].reshape(h, w)

