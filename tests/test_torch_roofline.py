"""The port's flip-cost model (``repro_torch.launch.roofline``) against the
JAX package's: the same rows, the same CPU bounds and readings, and the
card's row from its named figures."""
import numpy as np
import pytest

from repro.launch import roofline as jrl
from repro_torch.launch import roofline as rl

ENGINES = sorted(jrl.ISING_FLIP_COSTS)

#: item 1's predicted bounds (flips/ns): the k-sweep tier's k = 2,
#: tensorcore's one tier k = 1
CUDA_BOUNDS = {("stencil_pallas", 2): 2233.3333333333335,
               ("multispin_pallas", 2): 4466.666666666667,
               ("bitplane_pallas", 2): 17866.666666666668,
               ("tensorcore", 1): 670.0}


def test_flip_cost_rows_are_the_jax_rows():
    assert sorted(rl.ISING_FLIP_COSTS) == ENGINES
    for engine in ENGINES:
        j, p = jrl.flip_cost(engine), rl.flip_cost(engine)
        assert (p.bytes_per_flip, p.flops_per_flip, p.replicas) == \
            (j.bytes_per_flip, j.flops_per_flip, j.replicas)
    with pytest.raises(KeyError):
        rl.flip_cost("wolff")


@pytest.mark.parametrize("k", range(1, 9))
@pytest.mark.parametrize("engine", ENGINES)
def test_cpu_row_bounds_and_readings_equal_jax(engine, k):
    assert rl.roofline_flips_per_ns(engine, "cpu", k=k) == \
        jrl.roofline_flips_per_ns(engine, "cpu", k=k)
    rates = np.random.default_rng(k).uniform(1e-3, 30.0, size=4)
    for rate in rates:
        assert rl.pct_of_roofline(float(rate), engine, "cpu", k=k) == \
            jrl.pct_of_roofline(float(rate), engine, "cpu", k=k)


@pytest.mark.parametrize("engine,k", sorted(CUDA_BOUNDS))
def test_cuda_row_gives_the_predicted_bounds(engine, k):
    got = rl.roofline_flips_per_ns(engine, "cuda", k=k)
    assert got == pytest.approx(CUDA_BOUNDS[engine, k], rel=1e-9)


def test_cuda_row_is_derived_from_the_named_h100_figures():
    peaks = rl.BACKEND_PEAKS["cuda"]
    assert peaks["mem_bw"] == rl.H100_HBM_BYTES_PER_S == 3.35e12
    assert peaks["flops"] == (rl.H100_PIPE_PER_CLOCK_PER_SM["tensor"]
                              * rl.H100_SMS * rl.H100_BOOST_MHZ * 1e6)
    assert peaks["flops"] == pytest.approx(989.4e12, rel=1e-4)
    # only the port's two rows: no TPU or V100 figure
    assert sorted(rl.BACKEND_PEAKS) == ["cpu", "cuda"]
    assert rl.BACKEND_PEAKS["cpu"] == jrl.BACKEND_PEAKS["cpu"]
    for name in ("PEAK_FLOPS", "HBM_BW", "ICI_BW"):
        assert not hasattr(rl, name)


def test_readings_outside_the_model_are_none():
    assert rl.roofline_flips_per_ns("wolff", "cuda") is None
    assert rl.pct_of_roofline(1.0, "multispin", "tpu") is None
    assert rl.pct_of_roofline(1.0, "wolff", "cpu") is \
        jrl.pct_of_roofline(1.0, "wolff", "cpu")


def test_k_divides_only_the_memory_term():
    # tensorcore is memory-bound on the card at k = 1; at large k its
    # compute term (flops / 128) takes over, as in JAX's model
    mem = rl.roofline_flips_per_ns("tensorcore", "cuda", k=1)
    compute = rl.BACKEND_PEAKS["cuda"]["flops"] / 128.0 / 1e9
    assert mem < compute
    assert rl.roofline_flips_per_ns("tensorcore", "cuda", k=64) == \
        pytest.approx(compute)
