"""``SimConfig``: the engine construction config a ``RunSpec`` lowers to."""
from __future__ import annotations

import dataclasses


@dataclasses.dataclass
class SimConfig:
    n: int = 512
    m: int = 512
    temperature: float = 2.0
    seed: int = 1234
    engine: str = "multispin"
    tc_block: int = 128
    # 0.5 = random (hot) start; 1.0 = ordered start, for steady-state
    # runs below Tc (cold random starts can stripe-lock)
    init_p_up: float = 0.5
    # spin glass only: probability that a quenched bond is ferromagnetic
    p_ferro: float = 0.5

    @property
    def inv_temp(self) -> float:
        return 1.0 / self.temperature
