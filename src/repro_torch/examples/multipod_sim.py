"""Distributed Ising on a mesh: the paper's multi-GPU slab decomposition
as shards with exchanged halos, bit for bit the single-device engine
(counterpart of the JAX package's ``examples/multipod_sim.py``).

The JAX script builds its mesh from the devices there are.  The port
runs a 2 x 2 mesh whatever the machine: its shards go to the cards there
are, several to a card where there are fewer (``launch.mesh``), which
changes no result, since the draws are keyed on global lattice
positions.  The step is ``core.distributed.make_ising_step``, its draws
on the card from the ``philox_fill`` kernel, one launch a shard a
half-sweep.

Run:  python -m repro_torch.examples.multipod_sim [--device cpu]
"""
from __future__ import annotations

import argparse

import torch

from repro_torch.core import distributed as dist
from repro_torch.core import lattice as lat
from repro_torch.core import metropolis as metro
from repro_torch.launch.mesh import make_mesh

N = 64
MESH_SHAPE, MESH_AXES = (2, 2), ("data", "model")
TEMPERATURE, INIT_SEED, SEED, SWEEPS = 2.0, 7, 5, 50


def main(argv=None) -> dict:
    """Run the mesh and the single device; returns ``{"m", "same"}``.
    Raises ``AssertionError`` unless the planes are bit-equal."""
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.examples.multipod_sim",
        description="the distributed step against one device, bit for bit")
    ap.add_argument("--device", default="",
                    help="torch device, e.g. cpu (default: the CUDA cards)")
    args = ap.parse_args(argv)
    mesh = make_mesh(MESH_SHAPE, MESH_AXES, args.device or None)
    print(f"devices={len(mesh.devices)} mesh="
          f"{dict(zip(mesh.axis_names, mesh.shape))}")

    b, w = lat.init_planes(N, N, 0.5, INIT_SEED, mesh.devices[0])
    table = metro.acceptance_table(1 / TEMPERATURE)
    grid = dist.ShardGrid.of(mesh, N, N // 2)

    step = dist.make_ising_step(mesh, n=N, m=N, seed=SEED)
    b1, w1 = step(grid.split(b), grid.split(w), table, 0, SWEEPS)
    m = float(dist.magnetization_dist("basic", b1, w1))
    print(f"distributed m after {SWEEPS} sweeps: {m:+.4f}")

    # single-device reference, same Philox stream -> identical trajectory
    br, wr = metro.run_sweeps_philox(b, w, table, SWEEPS, seed=SEED)
    same = (torch.equal(grid.gather(b1), br)
            and torch.equal(grid.gather(w1), wr))
    print(f"bit-exact vs single device: {same}")
    if not same:
        raise AssertionError("the mesh's planes differ from one device's")
    return {"m": m, "same": same}


if __name__ == "__main__":
    main()
