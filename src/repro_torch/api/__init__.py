"""repro_torch.api: ``RunSpec`` and the single-mode ``Session``."""
from .session import Session
from .spec import (BatchSpec, EngineSpec, LatticeSpec, MeshSpec, RunSpec,
                   SweepSpec)

__all__ = ["RunSpec", "LatticeSpec", "EngineSpec", "SweepSpec", "BatchSpec",
           "MeshSpec", "Session"]
