"""Measurement: observables sampled along a trajectory."""
from .measure import MeasurementPlan, measure_scan

__all__ = ["MeasurementPlan", "measure_scan"]
