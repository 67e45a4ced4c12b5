"""The port's per-half-sweep sweep wrappers (``repro_torch.kernels.
{stencil,multispin,bitplane}.ops``) on the CPU against the JAX package's
``run_sweeps_*`` with ``interpret=True``, bit for bit: T = 2.2 (where the
port's table and thresholds are JAX's, asserted first), seeds below 2^31
(JAX's per-half-sweep multispin kernel keys on the seed's low 32 bits),
``start_offset`` 0 and 7, ``n_sweeps`` 1 and 3."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import bitplane as jbp
from repro.core import multispin as jms
from repro.kernels.bitplane.ops import \
    run_sweeps_bitplane_kernel as jax_bitplane
from repro.kernels.multispin.ops import run_sweeps_multispin as jax_multispin
from repro.kernels.stencil.ops import run_sweeps_stencil as jax_stencil
from repro_torch.core import metropolis
from repro_torch.core import multispin as ms
from repro_torch.kernels.bitplane import (bitplane_update,
                                          run_sweeps_bitplane_kernel)
from repro_torch.kernels.multispin import (multispin_update,
                                           run_sweeps_multispin)
from repro_torch.kernels.stencil import run_sweeps_stencil, stencil_update

T = 2.2
BETA = 1 / T
SEEDS = (5, 2 ** 31 - 3)
CASES = [(seed, start, n_sweeps) for seed in SEEDS for start in (0, 7)
         for n_sweeps in (1, 3)]
N, M = 16, 64


def pm1(shape, seed):
    r = np.random.default_rng(seed)
    return np.where(r.random(shape) < 0.5, 1, -1).astype(np.int8)


def to_port(words):
    """uint32 numpy/JAX words -> the port's int32 word tensor."""
    return torch.from_numpy(np.asarray(words).view(np.int32).copy())


def as_u32(words: torch.Tensor) -> np.ndarray:
    return words.numpy().view(np.uint32)


def test_port_table_and_thresholds_are_jax_at_t_2_2():
    args = jnp.asarray(metropolis.acceptance_arguments(BETA))
    np.testing.assert_array_equal(metropolis.acceptance_table(BETA).numpy(),
                                  np.asarray(jnp.exp(args)))
    np.testing.assert_array_equal(
        ms.acceptance_thresholds(BETA).numpy(),
        np.asarray(jms.acceptance_thresholds(jnp.float32(BETA)))
        .astype(np.int64))


@pytest.mark.parametrize("seed,start,n_sweeps", CASES)
def test_run_sweeps_stencil_equals_jax(seed, start, n_sweeps):
    b, w = pm1((N, M // 2), seed % 97), pm1((N, M // 2), seed % 97 + 1)
    want = jax_stencil(jnp.asarray(b), jnp.asarray(w), jnp.float32(BETA),
                       n_sweeps, seed=seed, start_offset=start,
                       block_rows=8, interpret=True)
    tb, tw = torch.from_numpy(b.copy()), torch.from_numpy(w.copy())
    before = stencil_update.launches
    got = run_sweeps_stencil(tb, tw, BETA, n_sweeps, seed=seed,
                             start_offset=start)
    assert got[0] is tb and got[1] is tw           # in place
    assert stencil_update.launches == before       # the CPU launches none
    for x, y in zip(want, got):
        np.testing.assert_array_equal(np.asarray(x), y.numpy())


@pytest.mark.parametrize("seed,start,n_sweeps", CASES)
def test_run_sweeps_multispin_equals_jax(seed, start, n_sweeps):
    jb, jw = jms.pack_lattice(jnp.asarray(pm1((N, M // 2), seed % 89)),
                              jnp.asarray(pm1((N, M // 2), seed % 89 + 1)))
    tb, tw = to_port(jb), to_port(jw)
    want = jax_multispin(jb, jw, jnp.float32(BETA), n_sweeps, seed=seed,
                         start_offset=start, block_rows=8, interpret=True)
    before = multispin_update.launches
    got = run_sweeps_multispin(tb, tw, BETA, n_sweeps, seed=seed,
                               start_offset=start)
    assert got[0] is tb and got[1] is tw
    assert multispin_update.launches == before
    for x, y in zip(want, got):
        np.testing.assert_array_equal(as_u32(y), np.asarray(x))


@pytest.mark.parametrize("seed,start,n_sweeps", CASES)
def test_run_sweeps_bitplane_kernel_equals_jax(seed, start, n_sweeps):
    stack = pm1((jbp.N_REPLICAS, N, M), seed % 83)
    jb, jw = jbp.pack_lattices(jnp.asarray(stack))
    tb, tw = to_port(jb), to_port(jw)
    want = jax_bitplane(jb, jw, jnp.float32(BETA), n_sweeps, seed=seed,
                        start_offset=start, block_rows=8, interpret=True)
    before = bitplane_update.launches
    got = run_sweeps_bitplane_kernel(tb, tw, BETA, n_sweeps, seed=seed,
                                     start_offset=start)
    assert got[0] is tb and got[1] is tw
    assert bitplane_update.launches == before
    for x, y in zip(want, got):
        np.testing.assert_array_equal(as_u32(y), np.asarray(x))


@pytest.mark.parametrize("run", [run_sweeps_stencil, run_sweeps_multispin,
                                 run_sweeps_bitplane_kernel])
def test_sweeps_continue_from_their_offset(run):
    """n sweeps from offset s then m from s + 2n (half-sweeps) equal n + m
    from s: the wrappers' offsets are half_sweep_offset's."""
    words = run is not run_sweeps_stencil
    planes = [torch.from_numpy(pm1((N, M // 2), s)) for s in (1, 2)]
    if words:
        planes = list(ms.pack_lattice(*planes))
    a = [p.clone() for p in planes]
    run(*a, BETA, 3, seed=9, start_offset=4)
    b = [p.clone() for p in planes]
    run(*b, BETA, 1, seed=9, start_offset=4)
    run(*b, BETA, 2, seed=9, start_offset=6)
    for x, y in zip(a, b):
        assert torch.equal(x, y)
