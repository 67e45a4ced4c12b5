"""End-to-end LM training driver with fault tolerance (counterpart of
``repro.launch.train``).

``python -m repro_torch.launch.train --arch internlm2-1.8b --smoke --steps 200``

Runs the sharded train step on every CUDA card there is, as JAX's
driver runs it on whatever devices exist: ``make_debug_mesh()`` over
the cards (one card: one shard), the parameters placed on it through
``param_shardings`` (``repro_torch.train.sharding.place``).
``--device`` names one device instead (``--device cpu``: one shard on
the CPU).  With: deterministic restart-exact data skip, periodic async
checkpoints, auto-restore from the latest checkpoint, and optional
simulated preemption (``--die-at``, exit 42) to demonstrate the restart
path end-to-end.  Checkpoints hold ``{"params", "opt"}`` in the JAX
package's layout (``params_to_jax``, ``opt_to_jax``: the pieces
gathered), so either package resumes the other's, on any mesh.

``--deterministic`` runs under ``torch.use_deterministic_algorithms``
(on the card set ``CUBLAS_WORKSPACE_CONFIG=:4096:8`` in the environment
first), so that a restarted run's parameters equal a straight run's bit
for bit there too.
"""
import argparse
import time

import torch

from repro_torch.api.session import resolve_device
from repro_torch.ckpt import Checkpointer
from repro_torch.configs import SHAPES, get_config, get_smoke_config
from repro_torch.data import DataIterator
from repro_torch.launch.mesh import make_debug_mesh
from repro_torch.models import init_model
from repro_torch.models.convert import params_from_jax, params_to_jax
from repro_torch.train import OptConfig, make_train_step, opt_init
from repro_torch.train.optim import opt_from_jax, opt_to_jax
from repro_torch.train.sharding import param_shardings, place


def state_tree(cfg, params, opt_state) -> dict:
    """The checkpointed tree, in JAX's layout."""
    return {"params": params_to_jax(cfg, params),
            "opt": opt_to_jax(cfg, opt_state)}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="internlm2-1.8b")
    ap.add_argument("--smoke", action="store_true",
                    help="reduced config (CPU-runnable)")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-3)
    ap.add_argument("--ckpt-dir", default="")
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--die-at", type=int, default=0,
                    help="simulate a node failure after this step")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--device", default=None,
                    help="one torch device (default: every CUDA card)")
    ap.add_argument("--deterministic", action="store_true",
                    help="torch.use_deterministic_algorithms(True)")
    args = ap.parse_args(argv)

    if args.deterministic:
        torch.use_deterministic_algorithms(True)
    device = resolve_device(args.device)
    cfg = get_smoke_config(args.arch) if args.smoke else get_config(
        args.arch)
    mesh = make_debug_mesh(device=device if args.device else None)
    print(f"arch={cfg.name} mesh={dict(zip(mesh.axis_names, mesh.shape))} "
          f"devices={len(mesh.devices)}")

    params = init_model(cfg, args.seed, device=mesh.device_of(0))
    p_sh = param_shardings(cfg, params, mesh)
    params = place(params, p_sh)
    opt_state = opt_init(params)

    ocfg = OptConfig(lr=args.lr, warmup=min(20, args.steps // 5 + 1),
                     total_steps=args.steps)
    step_fn = make_train_step(cfg, ocfg, mesh=mesh)

    start_step = 0
    ckpt = None
    if args.ckpt_dir:
        ckpt = Checkpointer(args.ckpt_dir)
        if ckpt.latest_step() is not None:
            start_step, restored = ckpt.restore(
                state_tree(cfg, params, opt_state))
            params = params_from_jax(cfg, restored["params"],
                                     shardings=p_sh)
            opt_state = opt_from_jax(cfg, restored["opt"], shardings=p_sh)
            print(f"restored checkpoint at step {start_step}")

    it = DataIterator(cfg, SHAPES["train_4k"], seed=args.seed,
                      batch_override=args.batch, seq_override=args.seq,
                      device=mesh.device_of(0))
    it.skip_to(start_step)

    t0 = time.time()
    for _ in range(start_step, args.steps):
        step, batch = next(it)
        params, opt_state, metrics = step_fn(params, opt_state, batch)
        if (step + 1) % args.log_every == 0 or step == start_step:
            print(f"step {step + 1:5d} loss={float(metrics['loss']):.4f} "
                  f"gnorm={float(metrics['grad_norm']):.3f} "
                  f"lr={float(metrics['lr']):.2e} "
                  f"({(time.time() - t0):.1f}s)")
        if ckpt and (step + 1) % args.ckpt_every == 0:
            ckpt.save_async(step + 1, state_tree(cfg, params, opt_state))
        if args.die_at and step + 1 == args.die_at:
            if ckpt:
                ckpt.wait()
            print(f"simulated failure at step {step + 1}; restart me")
            return 42
    if ckpt:
        # the last save_async may be writing this very step: JAX's driver
        # saves over it unwaited, and the two writers collide
        ckpt.wait()
        ckpt.save(args.steps, state_tree(cfg, params, opt_state))
    print("done")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
