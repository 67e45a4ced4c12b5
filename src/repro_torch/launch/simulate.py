"""Ising simulation driver (the paper's workload).

Counterpart of ``repro.launch.simulate``, on the CUDA card unless
``--device`` names another device:

    python -m repro_torch.launch.simulate --size 512 --temp 2.0 --sweeps 2000

Single run: picks the engine, runs sweeps with a magnetization line every
``--measure-every`` sweeps and an atomic checkpoint there (``--ckpt``;
``--restore`` continues it, the ``m=`` lines those of an uninterrupted
run), and reports flips/ns and |m| against Onsager's value.  The rate
counts the sweeps this process ran, on the host clock between two reads
that wait for the card.  ``--distributed`` runs the per-half-sweep
distributed step over a (cards, 1) mesh (one shard with ``--device
cpu``): the multispin engine's word step, else the int8 step.
"""
import argparse
import time

import torch

from repro_torch.core import observables as obs
from repro_torch.core.engine import ENGINES
from repro_torch.core.sim import SimConfig, Simulation


def _sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.launch.simulate")
    ap.add_argument("--size", type=int, default=512)
    ap.add_argument("--temp", type=float, default=2.0)
    ap.add_argument("--sweeps", type=int, default=1000)
    ap.add_argument("--measure-every", type=int, default=100)
    ap.add_argument("--engine", default="multispin", choices=sorted(ENGINES))
    ap.add_argument("--seed", type=int, default=1234)
    ap.add_argument("--ckpt", default="")
    ap.add_argument("--restore", action="store_true")
    ap.add_argument("--distributed", action="store_true")
    ap.add_argument("--device", default="",
                    help="torch device, e.g. cpu (default: the CUDA card)")
    args = ap.parse_args(argv)
    device = args.device or None

    if args.distributed:
        return _run_distributed(args, device)

    if args.restore and args.ckpt:
        sim = Simulation.restore(args.ckpt, device)
        print(f"restored at sweep {sim.step_count}")
    else:
        sim = Simulation(SimConfig(n=args.size, m=args.size,
                                   temperature=args.temp, seed=args.seed,
                                   engine=args.engine), device)
    start = done = sim.step_count
    _sync(sim._session.device)
    t0 = time.time()
    while done < args.sweeps:
        chunk = min(args.measure_every, args.sweeps - done)
        sim.run(chunk)
        done = sim.step_count
        m = sim.magnetization()   # waits for the card
        print(f"sweep {done:7d} m={m:+.4f}")
        if args.ckpt:
            sim.save(args.ckpt)
    m = sim.magnetization()
    dt = time.time() - t0
    flips = sim.config.n * sim.config.m * (done - start)
    exact = float(obs.onsager_magnetization(sim.config.temperature))
    print(f"flips/ns={flips / dt / 1e9:.4f}  |m|={abs(m):.4f} "
          f"onsager={exact:.4f}")
    return 0


def _run_distributed(args, device) -> int:
    from repro_torch.api.session import resolve_device
    from repro_torch.core import distributed as dist
    from repro_torch.core.engine import make_engine
    from repro_torch.launch.mesh import make_mesh
    n = args.size
    resolve_device(device)  # no card and no device named: raise
    rows = 1 if device else torch.cuda.device_count()
    mesh = make_mesh((rows, 1), ("data", "model"), device)
    packed = args.engine == "multispin"
    engine = make_engine(SimConfig(n=n, m=n, temperature=args.temp,
                                   seed=args.seed,
                                   engine="multispin" if packed
                                   else "basic_philox"), mesh.devices[0])
    grid = dist.ShardGrid.of(mesh, n, n // engine.col_divisor)
    d = engine.col_divisor
    black, white = [], []
    for i in range(mesh.size):
        r0, c0 = grid.origin(i)
        b, w = engine.init_block((r0, r0 + grid.n_loc),
                                 (c0 * d, (c0 + grid.w_loc) * d),
                                 mesh.device_of(i))
        black.append(b)
        white.append(w)
    # the word step takes its start in half-sweep units, the int8 step in
    # sweeps
    factory, scale = (dist.make_packed_ising_step, 2) if packed \
        else (dist.make_ising_step, 1)
    step = factory(mesh, n=n, m=n, seed=args.seed)
    table = engine.sweep_context(engine.cfg.inv_temp)
    for dev in mesh.devices:
        _sync(dev)
    t0 = time.time()
    for s in range(0, args.sweeps, args.measure_every):
        k = min(args.measure_every, args.sweeps - s)
        black, white = step(black, white, table, scale * s, k)
    for dev in mesh.devices:
        _sync(dev)
    dt = time.time() - t0
    print(f"{mesh.size} devices: flips/ns={n * n * args.sweeps / dt / 1e9:.4f}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
