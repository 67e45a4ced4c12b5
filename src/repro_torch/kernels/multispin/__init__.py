"""The multispin kernel pair: one packed half-sweep, and k sweeps per
launch."""
from .multispin import multispin_update, multispin_update_plain
from .resident import (multispin_sweeps_resident,
                       multispin_sweeps_resident_plain)

__all__ = ["multispin_update", "multispin_update_plain",
           "multispin_sweeps_resident", "multispin_sweeps_resident_plain"]
