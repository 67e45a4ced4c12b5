"""CRC32C (Castagnoli), numpy only: the checksum behind ``state_digest``.

Copied from the JAX package's ``resilience/integrity.py`` so that this
package imports nothing of it: a slicing-by-8 table walk for short
inputs and a vectorized GF(2) reduction ladder for long ones.  Both give
the same value as the reference, which the tests check.
"""
from __future__ import annotations

import numpy as np

_POLY = 0x82F63B78  # CRC-32C (Castagnoli), reflected


def _make_tables():
    t0 = []
    for i in range(256):
        c = i
        for _ in range(8):
            c = (c >> 1) ^ (_POLY if c & 1 else 0)
        t0.append(c)
    tables = [t0]
    for _ in range(7):
        prev = tables[-1]
        tables.append([t0[prev[i] & 0xFF] ^ (prev[i] >> 8)
                       for i in range(256)])
    return tables


_T = _make_tables()


#: below this length the scalar slicing-by-8 walk beats numpy setup
_NUMPY_THRESHOLD = 2048


def crc32c(data, value: int = 0) -> int:
    """CRC32C of ``data`` (bytes-like); pass a previous ``value`` to
    checksum incrementally: ``crc32c(b, crc32c(a)) == crc32c(a + b)``.

    Inputs of 2 KiB and more take the vectorized ladder
    (:func:`_crc32c_numpy`); the scalar walk is the oracle it is tested
    against.
    """
    if len(memoryview(data)) * memoryview(data).itemsize \
            >= _NUMPY_THRESHOLD:
        return _crc32c_numpy(data, value)
    return _crc32c_scalar(data, value)


def _crc32c_scalar(data, value: int = 0) -> int:
    crc = (value ^ 0xFFFFFFFF) & 0xFFFFFFFF
    mv = memoryview(data)
    if mv.ndim != 1 or mv.itemsize != 1:
        mv = mv.cast("B")
    t0, t1, t2, t3, t4, t5, t6, t7 = _T
    n = len(mv)
    i = 0
    # slicing-by-8: one table walk per 8 input bytes
    for i in range(0, n - 7, 8):
        crc ^= mv[i] | (mv[i + 1] << 8) | (mv[i + 2] << 16) \
            | (mv[i + 3] << 24)
        crc = (t7[crc & 0xFF] ^ t6[(crc >> 8) & 0xFF]
               ^ t5[(crc >> 16) & 0xFF] ^ t4[(crc >> 24) & 0xFF]
               ^ t3[mv[i + 4]] ^ t2[mv[i + 5]]
               ^ t1[mv[i + 6]] ^ t0[mv[i + 7]])
    for j in range(n - n % 8, n):
        crc = t0[(crc ^ mv[j]) & 0xFF] ^ (crc >> 8)
    return crc ^ 0xFFFFFFFF


# -- vectorized CRC ladder ---------------------------------------------------
#
# The byte-at-a-time recurrence crc' = (crc >> 8) ^ T[(crc ^ b) & 0xFF]
# splits, because T is a table of a GF(2)-LINEAR map on the low byte,
# into  crc' = L(crc) ^ T[b]  with  L(c) = (c >> 8) ^ T[c & 0xFF]  also
# linear.  Unrolling:  crc_n = L^n(init) ^ XOR_i L^(n-1-i)(T[b_i]).
# The XOR sum is an associative reduction -- combine(x, y) over a
# right half of length 2^k is L^(2^k)(x) ^ y -- so it evaluates as a
# log-depth numpy tree: one vectorized 4-table lookup per level, with
# the per-level operator L^(2^k) built once by self-composition and
# cached.  Front-padding with zero *bytes* is free (T[0] = 0 and the
# position weights count from the END), which keeps every level's
# element lengths equal.

_T0_NP = np.array(_T[0], dtype=np.uint32)


def _op_apply_np(op: np.ndarray, v: np.ndarray) -> np.ndarray:
    """Apply a linear op (4 x 256 uint32 byte tables) elementwise."""
    return (op[0][v & 0xFF] ^ op[1][(v >> 8) & 0xFF]
            ^ op[2][(v >> 16) & 0xFF] ^ op[3][v >> 24])


def _make_l1() -> np.ndarray:
    q = np.arange(256, dtype=np.uint32)
    op = np.zeros((4, 256), np.uint32)
    op[0] = _T0_NP                      # L(q)       = T[q]
    for p in range(1, 4):               # L(q << 8p) = q << 8(p-1)
        op[p] = q << (8 * (p - 1))
    return op


#: _LEVELS[k] = byte tables of L^(2^k); grown on demand, process-cached
_LEVELS = [_make_l1()]


def _level(k: int) -> np.ndarray:
    while len(_LEVELS) <= k:
        prev = _LEVELS[-1]
        _LEVELS.append(np.stack([_op_apply_np(prev, prev[p])
                                 for p in range(4)]))
    return _LEVELS[k]


def _crc32c_numpy(data, value: int = 0) -> int:
    d = np.frombuffer(memoryview(data).cast("B"), dtype=np.uint8)
    n = d.size
    if n == 0:
        return value
    e = _T0_NP[d]
    size = 1 << (n - 1).bit_length()
    if size != n:  # zero-pad at the FRONT: weights count from the end
        e = np.concatenate([np.zeros(size - n, np.uint32), e])
    k = 0
    while e.size > 1:
        e = _op_apply_np(_level(k), e[0::2]) ^ e[1::2]
        k += 1
    red = int(e[0])
    # init-register contribution L^n(init), by binary exponentiation
    state = (value ^ 0xFFFFFFFF) & 0xFFFFFFFF
    k, nn = 0, n
    while nn:
        if nn & 1:
            op = _level(k)
            state = int(op[0][state & 0xFF] ^ op[1][(state >> 8) & 0xFF]
                        ^ op[2][(state >> 16) & 0xFF]
                        ^ op[3][state >> 24])
        nn >>= 1
        k += 1
    return (state ^ red) ^ 0xFFFFFFFF


def crc32c_hex(data, value: int = 0) -> str:
    return f"{crc32c(data, value):08x}"
