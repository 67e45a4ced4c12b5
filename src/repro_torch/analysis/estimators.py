"""Streaming and resampling estimators for Monte Carlo observables.

Counterpart of ``repro.analysis.estimators``, the same functions on the
same float64 numpy arithmetic, so that equal samples give equal
estimates in both packages: Welford streaming moments,
Flyvbjerg-Petersen blocking, delete-one-block jackknife, the integrated
autocorrelation time tau_int with Sokal's automatic windowing, and the
paper's S5.3 physics estimators -- susceptibility, specific heat, Binder
cumulant and the Binder-crossing T_c estimator.

Everything here is host-side post-processing of the sample trajectories
of ``repro_torch.analysis.measure``, which come off the device once, at
the end of a trajectory; all functions accept any array-like and
compute in float64.

Conventions:

* ``tau_int = 1 + 2 sum_{t>=1} rho(t)`` -- iid data gives tau_int = 1 and
  the effective sample size is ``N / tau_int``; an AR(1) series with
  coefficient ``phi`` has ``tau_int = (1 + phi) / (1 - phi)``.
* ``chi = beta * N * (<m^2> - <|m|>^2)`` (per-spin m; paper Fig. 5 regime)
  and ``C_v = beta^2 * N * (<e^2> - <e>^2)`` (per-spin e) -- both are
  variances scaled by positive factors, hence non-negative.
"""
from __future__ import annotations

import math
from typing import Callable, Optional, Sequence, Tuple

import numpy as np


# ---------------------------------------------------------------------------
# streaming moments
# ---------------------------------------------------------------------------

class Welford:
    """Streaming mean/variance plus the |x|, x^2, x^4 moment means.

    Classic Welford/Chan update: ``push`` accepts scalars or arrays (any
    shape; flattened), ``merge`` combines two accumulators exactly as if
    their streams were concatenated -- so per-shard accumulators can be
    reduced across a fleet.  The higher moments feed the Binder cumulant
    and susceptibility without a second pass over the samples.
    """

    __slots__ = ("n", "mean", "_m2", "abs_mean", "sq_mean", "quad_mean")

    def __init__(self):
        self.n = 0
        self.mean = 0.0
        self._m2 = 0.0          # sum of squared deviations from the mean
        self.abs_mean = 0.0     # <|x|>
        self.sq_mean = 0.0      # <x^2>
        self.quad_mean = 0.0    # <x^4>

    def push(self, x) -> "Welford":
        x = np.asarray(x, np.float64).ravel()
        if x.size == 0:
            return self
        other = Welford()
        other.n = int(x.size)
        other.mean = float(x.mean())
        other._m2 = float(((x - x.mean()) ** 2).sum())
        other.abs_mean = float(np.abs(x).mean())
        other.sq_mean = float((x ** 2).mean())
        other.quad_mean = float((x ** 4).mean())
        return self.merge(other)

    def merge(self, other: "Welford") -> "Welford":
        """Chan's parallel combine; returns self for chaining."""
        if other.n == 0:
            return self
        if self.n == 0:
            for s in self.__slots__:
                setattr(self, s, getattr(other, s))
            return self
        n = self.n + other.n
        delta = other.mean - self.mean
        self._m2 += other._m2 + delta * delta * self.n * other.n / n
        w_self, w_other = self.n / n, other.n / n
        self.mean = self.mean * w_self + other.mean * w_other
        self.abs_mean = self.abs_mean * w_self + other.abs_mean * w_other
        self.sq_mean = self.sq_mean * w_self + other.sq_mean * w_other
        self.quad_mean = (self.quad_mean * w_self
                          + other.quad_mean * w_other)
        self.n = n
        return self

    @property
    def var(self) -> float:
        """Sample variance (ddof=1)."""
        return self._m2 / (self.n - 1) if self.n > 1 else 0.0

    @property
    def std(self) -> float:
        return math.sqrt(self.var)

    @property
    def sem(self) -> float:
        """Naive standard error of the mean (iid assumption)."""
        return self.std / math.sqrt(self.n) if self.n else 0.0

    def binder(self) -> float:
        """U = 1 - <x^4> / (3 <x^2>^2) from the streamed moments."""
        return binder_from_moments(self.sq_mean, self.quad_mean)

    def susceptibility(self, temperature: float, n_spins: int) -> float:
        """chi = beta N (<x^2> - <|x|>^2) from the streamed moments."""
        return (n_spins / temperature
                * max(self.sq_mean - self.abs_mean ** 2, 0.0))


# ---------------------------------------------------------------------------
# autocorrelation
# ---------------------------------------------------------------------------

def autocorrelation(x, max_lag: Optional[int] = None) -> np.ndarray:
    """Normalized autocorrelation rho(t), t = 0..max_lag (FFT, O(N log N))."""
    x = np.asarray(x, np.float64).ravel()
    n = x.size
    if max_lag is None:
        max_lag = n - 1
    max_lag = min(max_lag, n - 1)
    x = x - x.mean()
    f = np.fft.rfft(x, 2 * n)
    acov = np.fft.irfft(f * np.conj(f))[:max_lag + 1] / n
    if acov[0] <= 0:
        return np.concatenate([[1.0], np.zeros(max_lag)])
    return acov / acov[0]


def tau_int(x, c: float = 6.0) -> float:
    """Integrated autocorrelation time with Sokal's automatic window.

    ``tau(W) = 1 + 2 sum_{t=1}^{W} rho(t)``, evaluated at the smallest
    window ``W >= c * tau(W)`` (c ~ 6 balances truncation bias against
    the noise of summing long-lag rho).  iid -> 1; AR(1)(phi) ->
    (1 + phi) / (1 - phi).
    """
    x = np.asarray(x, np.float64).ravel()
    if x.size < 4 or np.ptp(x) == 0:
        return 1.0
    rho = autocorrelation(x)
    tau = 1.0
    for w in range(1, rho.size):
        tau += 2.0 * rho[w]
        if w >= c * max(tau, 1e-12):
            break
    return max(tau, 1e-12)


def effective_samples(x, c: float = 6.0) -> float:
    """N_eff = N / tau_int: the iid-equivalent sample count."""
    x = np.asarray(x, np.float64).ravel()
    return x.size / tau_int(x, c)


# ---------------------------------------------------------------------------
# error bars: blocking + jackknife
# ---------------------------------------------------------------------------

def blocking_sems(x) -> np.ndarray:
    """Flyvbjerg-Petersen blocking: naive SEM at each pair-halving level.

    Level 0 is the raw (iid-assumption) SEM; each level averages adjacent
    pairs, halving the series.  For correlated data the SEM grows with
    level until blocks exceed the correlation length, then plateaus.
    """
    x = np.asarray(x, np.float64).ravel()
    sems = []
    while x.size >= 2:
        sems.append(x.std(ddof=1) / math.sqrt(x.size))
        x = (x[: 2 * (x.size // 2)].reshape(-1, 2)).mean(axis=1)
    return np.asarray(sems)


def blocking_error(x, min_blocks: int = 16) -> float:
    """Blocking SEM: the plateau (max) over levels with >= min_blocks
    blocks -- levels with fewer blocks are too noisy to trust."""
    x = np.asarray(x, np.float64).ravel()
    sems = blocking_sems(x)
    if sems.size == 0:
        return 0.0
    # level l has n / 2^l blocks
    usable = [s for l, s in enumerate(sems)
              if x.size / (1 << l) >= min_blocks]
    return float(max(usable) if usable else sems[-1])


def jackknife(x, stat: Callable[[np.ndarray], float] = np.mean,
              n_blocks: int = 20) -> Tuple[float, float]:
    """Delete-one-block jackknife estimate and error of ``stat``.

    Blocking absorbs autocorrelation (choose blocks >> tau_int);
    jackknifing propagates errors through *nonlinear* statistics (Binder
    cumulant, chi) where naive SEM formulas do not apply.  Returns
    ``(stat(x), err)``.
    """
    x = np.asarray(x, np.float64).ravel()
    full = float(stat(x))  # the point estimate uses every sample
    nb = max(2, min(n_blocks, x.size))
    m = nb * (x.size // nb)
    if m < nb:  # fewer samples than blocks
        return full, 0.0
    blocks = x[:m].reshape(nb, -1)  # only the error bar truncates to blocks
    mask = ~np.eye(nb, dtype=bool)
    theta = np.array([float(stat(blocks[mask[i]].ravel()))
                      for i in range(nb)])
    err = math.sqrt((nb - 1) / nb * ((theta - theta.mean()) ** 2).sum())
    return full, err


# ---------------------------------------------------------------------------
# physics estimators (paper S5.3)
# ---------------------------------------------------------------------------

def binder_from_moments(m2: float, m4: float) -> float:
    """U = 1 - <m^4> / (3 <m^2>^2)."""
    return 1.0 - m4 / (3.0 * m2 * m2) if m2 > 0 else 0.0


def binder(m_samples) -> float:
    m = np.asarray(m_samples, np.float64).ravel()
    return binder_from_moments(float((m ** 2).mean()),
                               float((m ** 4).mean()))


def susceptibility(m_samples, temperature: float, n_spins: int) -> float:
    """chi = beta N (<m^2> - <|m|>^2) >= 0 (per-spin magnetization)."""
    m = np.asarray(m_samples, np.float64).ravel()
    var_abs = float((m ** 2).mean() - np.abs(m).mean() ** 2)
    return n_spins / temperature * max(var_abs, 0.0)


def specific_heat(e_samples, temperature: float, n_spins: int) -> float:
    """C_v = beta^2 N (<e^2> - <e>^2) >= 0 (per-spin energy)."""
    e = np.asarray(e_samples, np.float64).ravel()
    return n_spins / temperature ** 2 * max(float(e.var()), 0.0)


def binder_crossing(temps: Sequence[float], u_small: Sequence[float],
                    u_large: Sequence[float]) -> Optional[float]:
    """T_c from the crossing of two lattice sizes' Binder curves.

    Below T_c the larger lattice's U is higher (closer to 2/3), above it
    lower (closer to 0), so ``d = U_large - U_small`` crosses zero from
    above at T_c.  Linear interpolation at every +- sign change of d;
    multiple (noise-induced) crossings average.  None if no crossing.
    """
    t = np.asarray(temps, np.float64)
    d = np.asarray(u_large, np.float64) - np.asarray(u_small, np.float64)
    assert t.ndim == 1 and t.shape == d.shape, (t.shape, d.shape)
    order = np.argsort(t)
    t, d = t[order], d[order]
    crossings = []
    for i in range(t.size - 1):
        if d[i] > 0.0 >= d[i + 1]:
            frac = d[i] / (d[i] - d[i + 1])
            crossings.append(t[i] + frac * (t[i + 1] - t[i]))
    return float(np.mean(crossings)) if crossings else None
