"""Quickstart: one typed ``RunSpec`` + ``Session`` drives every engine,
validated against Onsager's exact solution, plus the raw per-half-sweep
kernel path (counterpart of the JAX package's ``examples/quickstart.py``).

Run:  python -m repro_torch.examples.quickstart [--device cpu]
"""
from __future__ import annotations

import argparse

import torch

from repro_torch.api import EngineSpec, LatticeSpec, RunSpec, Session
from repro_torch.api.session import resolve_device
from repro_torch.core import lattice as lat
from repro_torch.core import multispin as ms
from repro_torch.core import observables as obs
from repro_torch.kernels.multispin import multispin_update
from repro_torch.kernels.multispin.ops import run_sweeps_multispin

T = 1.8  # below Tc = 2.269: the lattice must order
N = 64
ENGINES = ("basic", "basic_philox", "multispin", "tensorcore")
TC_BLOCK = 8
ENGINE_SWEEPS, KERNEL_SWEEPS = 300, 100


def main(argv=None) -> dict:
    """Run the quickstart; returns ``{"engines": {name: |m|}, "spec",
    "kernel_m", "kernel_launches"}`` (launches of ``multispin_update`` by
    the kernel part: 0 on the CPU)."""
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.examples.quickstart",
        description="every engine against Onsager, and the raw kernel")
    ap.add_argument("--device", default="",
                    help="torch device, e.g. cpu (default: the CUDA card)")
    args = ap.parse_args(argv)
    device = resolve_device(args.device or None)
    onsager = obs.onsager_magnetization(T)

    print(f"== engines at T={T} (Onsager |m| = {onsager:.4f}) ==")
    engines = {}
    for engine in ENGINES:
        params = {"tc_block": TC_BLOCK} if engine == "tensorcore" else {}
        spec = RunSpec(lattice=LatticeSpec(n=N, m=N),
                       engine=EngineSpec(engine, params=params),
                       temperature=T, seed=3)
        session = Session.open(spec, device)
        session.run(ENGINE_SWEEPS)
        engines[engine] = abs(session.magnetization())
        print(f"  {engine:14s} |m| = {engines[engine]:.4f}")

    # the spec is one serializable blob: the same JSON drives
    # `python -m repro_torch run` and rides inside every checkpoint
    print("== spec round trip ==")
    print(f"  {spec.to_json()[:72]}...")
    if RunSpec.from_json(spec.to_json()) != spec:
        raise AssertionError("the spec does not survive its JSON")

    print(f"== multispin kernel, per half-sweep ({device.type}) ==")
    # start from the ground state: cold random starts can fall into the
    # striped metastable states the paper reports in S5.3
    full = torch.ones((N, N), dtype=torch.int8, device=device)
    bw, ww = ms.pack_lattice(*lat.split_checkerboard(full))
    before = multispin_update.launches
    bw, ww = run_sweeps_multispin(bw, ww, 1 / T, KERNEL_SWEEPS, seed=5)
    launches = multispin_update.launches - before
    b, w = ms.unpack_lattice(bw, ww)
    m = float(obs.magnetization(b, w).abs())
    print(f"  kernel steady-state |m| = {m:.4f} (Onsager {onsager:.4f}); "
          f"{launches} launches of multispin_update")
    print("ok")
    return {"engines": engines, "spec": spec, "kernel_m": m,
            "kernel_launches": launches}


if __name__ == "__main__":
    main()
