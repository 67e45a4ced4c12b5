"""``repro_torch.dist`` -- the sharded resident tier (counterpart of
``repro.dist``).

Instead of exchanging 1-wide halos every half-sweep
(``repro_torch.core.distributed``), each shard gathers a halo ring of
width ``h = 2k`` once, and a per-shard kernel runs k full sweeps on the
extended plane; wrong values creep inward one ring per half-sweep, so
the owned interior is exact.  The draws are keyed on global positions,
so a sharded run is the single-device run bit for bit on any mesh, and
checkpoints restore across mesh shapes.

* :mod:`repro_torch.dist.planner` -- fit, halo and k per shard
  (:func:`plan_shard_resident`, :func:`shard_decision_attrs`);
* :mod:`repro_torch.dist.kernels` -- the per-shard CUDA kernels and
  their plain versions;
* :mod:`repro_torch.dist.driver` -- the step (:func:`make_resident_step`)
  with its halo gather.
"""
from __future__ import annotations

from .driver import make_resident_step
from .planner import ShardPlan, plan_shard_resident, shard_decision_attrs

__all__ = [
    "ShardPlan", "plan_shard_resident", "shard_decision_attrs",
    "make_resident_step",
]
