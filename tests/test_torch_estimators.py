"""The port's estimators (``repro_torch.analysis.estimators``) against the
JAX package's on the same seeded numpy arrays: the same float64
arithmetic, so the results are equal exactly."""
import numpy as np
import pytest

from repro.analysis import estimators as jest
from repro_torch.analysis import estimators as est

N = 4096


def ar1(phi: float, n: int = N, seed: int = 0) -> np.ndarray:
    """An AR(1) series with coefficient ``phi``."""
    r = np.random.default_rng(seed)
    noise = r.standard_normal(n)
    x = np.empty(n)
    x[0] = noise[0]
    for i in range(1, n):
        x[i] = phi * x[i - 1] + noise[i]
    return x


SERIES = {
    "ar1-0.9": lambda: ar1(0.9, seed=1),
    "ar1-0.5": lambda: ar1(0.5, n=1000, seed=2),
    "gaussian": lambda: np.random.default_rng(3).normal(0.3, 2.0, N),
    "spins": lambda: np.where(np.random.default_rng(4).random(N) < 0.7,
                              1.0, -1.0),
    "constant": lambda: np.full(64, 0.25),
    "short": lambda: np.array([0.5, -0.25, 0.75]),
}

ESTIMATORS = {
    "autocorrelation": lambda m, x: m.autocorrelation(x),
    "autocorrelation-lag": lambda m, x: m.autocorrelation(x, max_lag=17),
    "tau_int": lambda m, x: m.tau_int(x),
    "tau_int-c4": lambda m, x: m.tau_int(x, c=4.0),
    "effective_samples": lambda m, x: m.effective_samples(x),
    "blocking_sems": lambda m, x: m.blocking_sems(x),
    "blocking_error": lambda m, x: m.blocking_error(x),
    "blocking_error-4": lambda m, x: m.blocking_error(x, min_blocks=4),
    "jackknife-mean": lambda m, x: m.jackknife(x),
    "jackknife-binder": lambda m, x: m.jackknife(x, stat=m.binder,
                                                 n_blocks=10),
    "binder": lambda m, x: m.binder(x),
    "binder_from_moments": lambda m, x: m.binder_from_moments(
        float((x ** 2).mean()), float((x ** 4).mean())),
    "susceptibility": lambda m, x: m.susceptibility(x, 2.3, 1024),
    "specific_heat": lambda m, x: m.specific_heat(x, 2.3, 1024),
}


@pytest.mark.parametrize("series", sorted(SERIES))
@pytest.mark.parametrize("estimator", sorted(ESTIMATORS))
def test_estimator_equals_jax(series, estimator):
    x = SERIES[series]()
    got = ESTIMATORS[estimator](est, x)
    want = ESTIMATORS[estimator](jest, x)
    np.testing.assert_array_equal(np.asarray(got), np.asarray(want))


@pytest.mark.parametrize("phi", [0.0, 0.5, 0.8])
def test_tau_int_of_ar1_is_its_closed_form(phi):
    """tau_int of AR(1)(phi) is (1 + phi) / (1 - phi) within its
    noise."""
    want = (1 + phi) / (1 - phi)
    assert est.tau_int(ar1(phi, n=1 << 15, seed=5)) == pytest.approx(
        want, rel=0.15)


def _welford_state(w):
    return (w.n, w.mean, w._m2, w.abs_mean, w.sq_mean, w.quad_mean)


@pytest.mark.parametrize("series", ["ar1-0.9", "gaussian", "spins"])
@pytest.mark.parametrize("chunks", [1, 3, 7])
def test_welford_push_and_merge_equal_jax(series, chunks):
    """Pushing the series in chunks, and merging accumulators of halves,
    give the JAX accumulator's state and estimates exactly, and the
    whole series' moments."""
    x = SERIES[series]()
    parts = np.array_split(x, chunks)
    ours, theirs = est.Welford(), jest.Welford()
    for p in parts:
        ours.push(p)
        theirs.push(p)
    assert _welford_state(ours) == _welford_state(theirs)
    assert (ours.var, ours.std, ours.sem, ours.binder(),
            ours.susceptibility(2.2, 256)) == (
        theirs.var, theirs.std, theirs.sem, theirs.binder(),
        theirs.susceptibility(2.2, 256))
    assert ours.n == x.size
    assert ours.mean == pytest.approx(x.mean(), rel=1e-12, abs=1e-12)
    assert ours.var == pytest.approx(x.var(ddof=1), rel=1e-10)
    left, right = est.Welford(), est.Welford()
    jleft, jright = jest.Welford(), jest.Welford()
    for p in parts[:len(parts) // 2]:
        left.push(p)
        jleft.push(p)
    for p in parts[len(parts) // 2:]:
        right.push(p)
        jright.push(p)
    assert _welford_state(left.merge(right)) == \
        _welford_state(jleft.merge(jright))
    assert left.var == pytest.approx(x.var(ddof=1), rel=1e-10)


def test_welford_of_nothing_and_empty_merges():
    w = est.Welford()
    assert (w.var, w.sem) == (0.0, 0.0)
    w.push([])
    w.merge(est.Welford())
    assert w.n == 0
    w.merge(est.Welford().push([1.0, -1.0]))
    assert _welford_state(w) == _welford_state(
        jest.Welford().merge(jest.Welford().push([1.0, -1.0])))


@pytest.mark.parametrize("case", ["one", "two", "none", "unsorted"])
def test_binder_crossing_equals_jax(case):
    t = np.array([1.8, 2.0, 2.2, 2.3, 2.5, 2.7])
    small = np.array([0.60, 0.55, 0.45, 0.40, 0.25, 0.10])
    large = {"one": [0.66, 0.62, 0.50, 0.35, 0.10, 0.02],
             "two": [0.66, 0.50, 0.50, 0.35, 0.30, 0.02],
             "none": [0.50, 0.45, 0.40, 0.30, 0.20, 0.05],
             "unsorted": [0.66, 0.62, 0.50, 0.35, 0.10, 0.02]}[case]
    order = np.arange(t.size)[::-1] if case == "unsorted" else \
        np.arange(t.size)
    got = est.binder_crossing(t[order], small[order],
                              np.asarray(large)[order])
    assert got == jest.binder_crossing(t[order], small[order],
                                       np.asarray(large)[order])
    assert (got is None) == (case == "none")
