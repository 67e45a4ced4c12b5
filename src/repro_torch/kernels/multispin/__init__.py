"""The multispin kernel pair: one packed half-sweep, and k sweeps per
launch, each also over an ensemble's members in one launch."""
from .multispin import (multispin_update, multispin_update_batched,
                        multispin_update_batched_plain,
                        multispin_update_plain)
from .ops import run_sweeps_multispin
from .resident import (multispin_sweeps_resident,
                       multispin_sweeps_resident_batched,
                       multispin_sweeps_resident_batched_plain,
                       multispin_sweeps_resident_plain)

__all__ = ["multispin_update", "multispin_update_plain",
           "multispin_update_batched", "multispin_update_batched_plain",
           "multispin_sweeps_resident", "multispin_sweeps_resident_plain",
           "multispin_sweeps_resident_batched",
           "multispin_sweeps_resident_batched_plain",
           "run_sweeps_multispin"]
