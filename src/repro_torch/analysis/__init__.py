"""Measurement: observables sampled along a trajectory."""
from .measure import MeasurementPlan, measure_scan, measure_scan_batched

__all__ = ["MeasurementPlan", "measure_scan", "measure_scan_batched"]
