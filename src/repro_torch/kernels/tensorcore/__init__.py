"""The fused tensor-core kernel: one half-sweep of two sublattice planes."""
from .ops import run_sweeps_tensorcore
from .tensorcore import tensorcore_update, tensorcore_update_plain

__all__ = ["tensorcore_update", "tensorcore_update_plain",
           "run_sweeps_tensorcore"]
