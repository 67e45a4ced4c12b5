"""Measurement and host-side analysis (counterpart of ``repro.analysis``).

* ``measure``    -- MeasurementPlan / measure_scan: observables sampled
  along a trajectory, on the card each sample's observables a replay of
  one captured CUDA graph;
* ``estimators`` -- Welford moments, blocking/jackknife error bars,
  tau_int, susceptibility, specific heat, Binder crossing;
* ``recorder``   -- RunRecorder: the EXPERIMENTS.md CSV/JSON records;
* ``figures``    -- the paper's Fig. 5/6 temperature scan
  (``python -m repro_torch.analysis.figures``).
"""
from .estimators import (Welford, autocorrelation, binder, binder_crossing,
                         blocking_error, blocking_sems, effective_samples,
                         jackknife, specific_heat, susceptibility, tau_int)
from .measure import MeasurementPlan, measure_scan, measure_scan_batched
from .recorder import RunRecorder, parse_derived

__all__ = [
    "MeasurementPlan", "measure_scan", "measure_scan_batched",
    "Welford", "autocorrelation", "binder", "binder_crossing",
    "blocking_error", "blocking_sems", "effective_samples", "jackknife",
    "specific_heat", "susceptibility", "tau_int",
    "RunRecorder", "parse_derived",
]
