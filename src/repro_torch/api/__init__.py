"""repro_torch.api: ``RunSpec``, ``Session``, ``describe`` and
``load_spec``."""
from .session import Session, describe, load_spec
from .spec import (BatchSpec, EngineSpec, LatticeSpec, MeshSpec, RunSpec,
                   SweepSpec)

__all__ = ["RunSpec", "LatticeSpec", "EngineSpec", "SweepSpec", "BatchSpec",
           "MeshSpec", "Session", "describe", "load_spec"]
