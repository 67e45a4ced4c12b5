"""The bitplane kernel pair: one half-sweep of 32 replicas, and k sweeps
per launch, each also over an ensemble's members in one launch; and the
counts of the replicas' observables in one pass."""
from .bitplane import (bitplane_update, bitplane_update_batched,
                       bitplane_update_batched_plain, bitplane_update_plain)
from .counts import bitplane_counts, bitplane_counts_plain
from .ops import run_sweeps_bitplane_kernel
from .resident import (bitplane_sweeps_resident,
                       bitplane_sweeps_resident_batched,
                       bitplane_sweeps_resident_batched_plain,
                       bitplane_sweeps_resident_plain)

__all__ = ["bitplane_update", "bitplane_update_plain",
           "bitplane_update_batched", "bitplane_update_batched_plain",
           "bitplane_sweeps_resident", "bitplane_sweeps_resident_plain",
           "bitplane_sweeps_resident_batched",
           "bitplane_sweeps_resident_batched_plain",
           "run_sweeps_bitplane_kernel", "bitplane_counts",
           "bitplane_counts_plain"]
