"""The stencil kernel pair: one half-sweep, and k sweeps per launch, each
also over an ensemble's members in one launch."""
from .ops import run_sweeps_stencil
from .resident import (stencil_sweeps_resident,
                       stencil_sweeps_resident_batched,
                       stencil_sweeps_resident_batched_plain,
                       stencil_sweeps_resident_plain)
from .stencil import (stencil_update, stencil_update_batched,
                      stencil_update_batched_plain, stencil_update_plain)

__all__ = ["stencil_update", "stencil_update_plain",
           "stencil_update_batched", "stencil_update_batched_plain",
           "stencil_sweeps_resident", "stencil_sweeps_resident_plain",
           "stencil_sweeps_resident_batched",
           "stencil_sweeps_resident_batched_plain",
           "run_sweeps_stencil"]
