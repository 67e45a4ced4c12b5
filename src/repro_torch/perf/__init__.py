"""repro_torch.perf -- the performance contract (counterpart of
``repro.perf``).

* :mod:`repro_torch.perf.schema` -- what a valid perf record looks like
  (``run --record`` and ``dist.weakscale --json`` validate theirs);
* :mod:`repro_torch.perf.gate` -- the statistical regression gate:
  candidate vs baseline per row using the baseline's *recorded* noise
  band (median +- noise_mult * IQR, floored) instead of a flat
  threshold, plus absolute flips/ns floors from a budgets file.

CLI: ``python -m repro_torch.perf.gate BASELINE CANDIDATE [--budgets
FILE]`` (exit 1 on a statistically real regression; ``--advisory``
reports without failing).
"""
import importlib

_GATE = ("GateConfig", "GateResult", "RowVerdict", "classify", "gate",
         "load_budgets", "make_budgets", "row_stats", "throughput",
         "tolerance")
_SCHEMA = ("SchemaError", "validate_record", "validate_row")

__all__ = list(_GATE + _SCHEMA)


def __getattr__(name):
    # lazy re-exports: `python -m repro_torch.perf.gate` must not trigger
    # an eager package-level import of the same module (runpy warning).
    # import_module, not `from . import gate`: "gate" names the function
    # and the module, and the relative form would look the name up here
    # again before the module is imported
    if name in _GATE:
        return getattr(importlib.import_module(f"{__name__}.gate"), name)
    if name in _SCHEMA:
        return getattr(importlib.import_module(f"{__name__}.schema"), name)
    raise AttributeError(name)
