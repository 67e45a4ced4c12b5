"""The stencil kernel pair: one half-sweep, and k sweeps per launch."""
from .resident import stencil_sweeps_resident, stencil_sweeps_resident_plain
from .stencil import stencil_update, stencil_update_plain

__all__ = ["stencil_update", "stencil_update_plain",
           "stencil_sweeps_resident", "stencil_sweeps_resident_plain"]
