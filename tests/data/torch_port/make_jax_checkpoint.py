"""Write a ``basic_philox`` checkpoint with the JAX package, and its
digests, for the port to continue where JAX cannot run (the card).

    PYTHONPATH=src JAX_PLATFORMS=cpu \
        python tests/data/torch_port/make_jax_checkpoint.py

A 512^2 run from a hot start at T = 2.2 (a temperature whose acceptance
tables the two packages share), seed 2^33 + 5, saved after 5 sweeps to
``basic_philox_512.npz``; ``basic_philox_512.json`` holds the spec, the
saved digest and the digest after 20 more sweeps.  ``chip_smoke.py``
phase 9 restores the file on the card and must reach that digest;
``tests/test_torch_engines.py`` checks the file against the JAX package
and the port's plain versions on the CPU.
"""
import json
from pathlib import Path

import repro.api as japi

HERE = Path(__file__).resolve().parent
N = 512
PRE, RUN = 5, 20


def spec():
    return japi.RunSpec(lattice=japi.LatticeSpec(N, N),
                        engine=japi.EngineSpec("basic_philox"),
                        temperature=2.2, seed=2 ** 33 + 5)


def run():
    """The JAX session saved after PRE sweeps: ``(session, record)``."""
    s = japi.Session.open(spec())
    s.run(PRE)
    record = {"spec": spec().to_dict(), "step_count": PRE,
              "saved_digest": s.state_digest(), "sweeps": RUN}
    return s, record


def main():
    s, record = run()
    s.save(str(HERE / "basic_philox_512.npz"))
    s.run(RUN)
    record["digest"] = s.state_digest()
    (HERE / "basic_philox_512.json").write_text(
        json.dumps(record, indent=1, sort_keys=True) + "\n")
    print(json.dumps(record))


if __name__ == "__main__":
    main()
