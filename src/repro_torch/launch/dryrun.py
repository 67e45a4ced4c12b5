"""Multi-pod dry-run: build and count every (arch x shape x mesh) cell
on the meta device (counterpart of ``repro.launch.dryrun``).

The JAX package lowers and compiles each cell's step for the (16, 16)
and (2, 16, 16) production meshes on 512 forced host devices.  The port
has no compiler to ask, so it runs the step itself on meta tensors,
which carry shapes and dtypes and no memory: the parameters, the AdamW
state, the batch (``make_batch(..., abstract=True)``) and the decode
cache, each with its partition spec from ``repro_torch.train.sharding``.
A cell is "ok" when every spec is valid for its leaf and the step runs
once under :class:`~repro_torch.launch.roofline.OpCounter`.

Per cell the record holds, per device: ``flops`` and ``bytes`` (the whole
step's count divided by ``chips``: an even split, which leaves out that
replicated leaves are updated on every device), ``memory`` (argument,
output and donated bytes from the specs' shard shapes), ``collectives``
(:func:`~repro_torch.launch.roofline.collective_bytes`, from the specs)
and the three roofline terms on the H100 row.  The port has no layer
scan, so every layer runs and is counted: JAX's unroll-and-difference
correction has nothing to correct.

Ising cells count one shard's step (every shard does the same work) on
the shard's plane, cut by ``ShardGrid.of`` over the whole mesh, and
report the shard, its state and halo bytes, the plan the sharded
resident tier would run there (``repro_torch.dist.planner``) and the
flip-cost model's bytes a flip beside the counted ones.

Usage (no card: the counts are operations and bytes, not times)::

  python -m repro_torch.launch.dryrun --arch all --shape all --mesh both
  python -m repro_torch.launch.dryrun --arch ising-multispin --mesh multi

The default ``--out`` is ``results/dryrun_torch.json``, beside (never
over) the JAX package's ``results/dryrun.json``.
"""
import argparse
import json
import os
import time
import traceback
from typing import Dict

import torch

from repro_torch.configs import ARCH_IDS, SHAPES, get_config, \
    get_smoke_config
from repro_torch.configs.base import shape_applicable
from repro_torch.data.pipeline import make_batch
from repro_torch.launch import roofline
from repro_torch.launch.mesh import make_mesh, make_production_mesh
from repro_torch.models import init_cache, init_model
from repro_torch.train import OptConfig, make_prefill_step, \
    make_serve_step, make_train_step, opt_init
from repro_torch.train.sharding import (P, NamedSharding, batch_specs,
                                        cache_specs, mesh_axes,
                                        param_shardings)

ISING_SHAPES = {
    # (rows, cols) of the full lattice
    "lat_256k": (262144, 262144),     # 6.9e10 spins
    "lat_1m": (1048576, 1048576),     # 1.1e12 spins: the 512-chip cell
}

#: Ising engine -> (per-half-sweep factory of ``core.distributed``,
#: lattice columns a plane cell, plane dtype, the sharded resident
#: tier's family)
ISING_ENGINES = {
    "multispin": ("make_packed_ising_step", 16, torch.int32, "multispin"),
    "bitplane": ("make_bitplane_ising_step", 2, torch.int32, "bitplane"),
    "basic": ("make_ising_step", 2, torch.int8, "stencil"),
}

#: the products whose output is the residual stream: where the model
#: axis holds a dim of their contraction, each output is reduced over it
_RESIDUAL_OUT = ("attn/wo", "mlp/wo", "moe/shared_wo", "mamba/out_proj",
                 "cell/wo")

META = torch.device("meta")


# ---------------------------------------------------------------------------
# LM cells
# ---------------------------------------------------------------------------

def auto_fsdp(params, mesh) -> bool:
    """FSDP weight all-gathers are pure collective waste when params +
    optimizer state already fit under TP alone.  Enable FSDP only when
    the TP-sharded state (16 bytes/param: f32 master + grad + 2 Adam
    moments) would exceed ~6 GB/device."""
    n_params = sum(float(p.numel()) for p in params.parameters())
    tp = mesh.axis_size(mesh_axes(mesh)[1])
    return n_params * 16.0 / tp > 6e9


def _pairs(shardings: Dict[str, NamedSharding], params) -> list:
    """``(sharding, leaf)`` of each leaf of a tree, matched by path."""
    leaves = dict(params.named_parameters())
    return [(sh, leaves[path.replace("/", ".")])
            for path, sh in shardings.items()]


def _tree_pairs(mesh, specs, tree) -> list:
    """``(sharding, leaf)`` of each tensor of a dict/list tree and the
    matching tree of specs."""
    if isinstance(tree, dict):
        return [x for k in tree for x in _tree_pairs(mesh, specs[k], tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for s, t in zip(specs, tree)
                for x in _tree_pairs(mesh, s, t)]
    if isinstance(tree, torch.Tensor):
        return [(NamedSharding(mesh, specs), tree)]
    return []


def _moe_dispatch_bytes(cfg, shape, b_loc: int) -> float:
    """One device's bytes of one MoE layer's dispatch buffer (bf16,
    (experts, capacity, d_model)): the global buffer over its tokens in
    training, one buffer a sequence for inference (capacity factor 1.25,
    dropless in decode), as ``models.moe`` sizes them."""
    e, k = cfg.n_routed, cfg.top_k
    if shape.kind == "train":
        cap = int(k * b_loc * shape.seq_len * 1.25 / e) + 1
        return float(e * cap * cfg.d_model * 2)
    s, cf = (1, float(e)) if shape.kind == "decode" else (shape.seq_len,
                                                          1.25)
    cap = int(k * s * cf / e) + 1
    return float(b_loc * e * cap * cfg.d_model * 2)


def lm_collectives(cfg, shape, mesh, p_sh, params) -> dict:
    """One device's collective bytes of one LM step from its specs
    (:func:`roofline.collective_bytes`).  A train step with remat runs
    each layer's forward twice and its backward once: the FSDP weights
    are gathered twice, and each residual reduction and MoE dispatch
    happens three times (forward, recompute, backward); an inference
    step once.  A residual reduction is the f32 product output of the
    device's tokens (a decode step: one a sequence); an encoder layer's
    are its frames', and a decode step runs no encoder.  The hybrid
    family's shared attention counts once a layer that runs it.  Train
    and prefill steps are sequence parallel (JAX's ``sp=True``), decode
    steps not."""
    dp_axes, tp_axes = mesh_axes(mesh)
    dp = mesh.axis_size(dp_axes)
    b = shape.global_batch
    b_loc = b // dp if b % dp == 0 else b
    seq = 1 if shape.kind == "decode" else shape.seq_len
    passes = 3 if shape.kind == "train" else 1
    tokens = {"enc_blocks": 0 if shape.kind == "decode"
              else b_loc * cfg.enc_seq}
    residual = dispatch = 0.0
    for path, sh in p_sh.items():
        top = path.split("/")[0]
        n_tok = tokens.get(top, b_loc * seq)
        uses = (cfg.n_layers // cfg.attn_every
                if top == "shared_attn" else 1)
        if any(p in path for p in _RESIDUAL_OUT) \
                and any(tp_axes[0] in (e if isinstance(e, tuple) else (e,))
                        for e in sh.spec[:-1] if e is not None):
            residual += passes * uses * n_tok * cfg.d_model * 4
        if "moe/wi" in path and sh.spec and sh.spec[0] is not None:
            dispatch += passes * 2 * _moe_dispatch_bytes(cfg, shape, b_loc)
    return roofline.collective_bytes(
        mesh, _pairs(p_sh, params), train=shape.kind == "train",
        gathers=2 if shape.kind == "train" else 1, residual=residual,
        sp=shape.kind != "decode", dispatch=dispatch)


def _check_all(pairs) -> None:
    for sh, leaf in pairs:
        sh.check(leaf.shape)


def lower_lm_cell(arch: str, shape_name: str, mesh, *, fsdp=None,
                  smoke: bool = False):
    """Build one (arch, shape, mesh) cell on meta and count its step.
    Returns ``(cell, None)``, ``cell`` a dict of the counter, the memory
    and the collectives, or ``(None, why)`` where the shape does not
    apply.  ``fsdp``: True/False to force, None = :func:`auto_fsdp`."""
    cfg = get_smoke_config(arch) if smoke else get_config(arch)
    shape = SHAPES[shape_name]
    ok, why = shape_applicable(cfg, shape)
    if not ok:
        return None, why
    sliding = cfg.long_sliding_window if shape.name == "long_500k" else 0

    params = init_model(cfg, device=META)
    if fsdp is None:
        fsdp = auto_fsdp(params, mesh)
    p_sh = param_shardings(cfg, params, mesh, fsdp=fsdp)
    p_pairs = _pairs(p_sh, params)
    counter = roofline.OpCounter()
    info = {"fsdp": fsdp}

    if shape.kind in ("train", "prefill"):
        batch = make_batch(cfg, shape, abstract=True)
        specs = batch_specs(cfg, mesh, global_batch=shape.global_batch)
        if shape.kind == "prefill":
            batch.pop("labels")
        b_pairs = _tree_pairs(mesh, {k: specs[k] for k in batch}, batch)
        _check_all(p_pairs + b_pairs)
        if shape.kind == "train":
            opt = opt_init(params)
            o_pairs = (_pairs(p_sh, opt["mu"]) + _pairs(p_sh, opt["nu"])
                       + [(NamedSharding(mesh, P()), opt["count"])])
            # gradient accumulation bounds live activation memory; 4
            # microbatches for full-size train cells (smoke stays at 1)
            mb = 1 if smoke or shape.global_batch % 4 else 4
            step = make_train_step(cfg, OptConfig(), remat=True,
                                   sliding_window=sliding, microbatches=mb)
            with counter:
                _, _, metrics = step(params, opt, batch)
            scalar = NamedSharding(mesh, P())
            state = p_pairs + o_pairs
            memory = roofline.memory_per_device(
                state + b_pairs,
                state + [(scalar, v) for v in metrics.values()], state)
            info["microbatches"] = mb
        else:
            with counter:
                logits = make_prefill_step(cfg, sliding_window=sliding)(
                    params, batch)
            out = NamedSharding(mesh, P(specs["tokens"][0], None, None))
            memory = roofline.memory_per_device(p_pairs + b_pairs,
                                                [(out, logits)])
    else:
        b = shape.global_batch
        cache = init_cache(cfg, b, shape.seq_len, window=sliding,
                           device=META)
        c_pairs = _tree_pairs(mesh, cache_specs(cfg, cache, mesh, batch=b),
                              cache)
        dp = mesh.axis_size(mesh_axes(mesh)[0])
        tok_spec = P(batch_specs(cfg, mesh, global_batch=b)["tokens"][0]
                     if b % dp == 0 else None, None)
        tokens = torch.empty((b, 1), dtype=torch.int32, device=META)
        t_pairs = [(NamedSharding(mesh, tok_spec), tokens)]
        _check_all(p_pairs + c_pairs + t_pairs)
        with counter:
            nxt, _ = make_serve_step(cfg, sliding_window=sliding)(
                params, cache, tokens)
        memory = roofline.memory_per_device(
            p_pairs + c_pairs + t_pairs,
            [(NamedSharding(mesh, tok_spec), nxt)] + c_pairs, c_pairs)
    info.update(counter=counter, memory=memory,
                collectives=lm_collectives(cfg, shape, mesh, p_sh, params))
    return info, None


# ---------------------------------------------------------------------------
# Ising cells (the paper's workload on the production mesh)
# ---------------------------------------------------------------------------

def lower_ising_cell(shape_name: str, mesh, engine: str = "multispin"):
    """One distributed sweep of ``engine``'s per-half-sweep step (packed
    uint32 words, 32 replica bitplanes, or int8 planes), pencil-cut over
    the whole mesh by ``ShardGrid.of``: one shard's step counted on its
    plane (a one-shard mesh on meta runs the same ops as any shard of
    the whole mesh).  Returns ``(cell, None)``."""
    from repro_torch.core import distributed as dist
    from repro_torch.core import metropolis, multispin
    from repro_torch.dist.planner import plan_shard_resident

    factory, per_cell, dtype, family = ISING_ENGINES[engine]
    n, m = ISING_SHAPES[shape_name]
    grid = dist.ShardGrid.of(mesh, n, m // per_cell)
    n_loc, w_loc = grid.n_loc, grid.w_loc
    one = make_mesh((1, 1), ("data", "model"), META)
    step = getattr(dist, factory)(one, n=n_loc, m=w_loc * per_cell, seed=0)
    # the acceptance table stays on the host, as a session's does until
    # a step takes it (the bitplane accept reads its thresholds there)
    table = (metropolis.acceptance_table(0.44) if engine == "basic"
             else multispin.acceptance_thresholds(0.44))
    black = [torch.empty((n_loc, w_loc), dtype=dtype, device=META)]
    white = [torch.empty((n_loc, w_loc), dtype=dtype, device=META)]
    counter = roofline.OpCounter()
    with counter:
        step(black, white, table, 0, 1)
    cell = torch.empty((), dtype=dtype).element_size()
    state = 2 * n_loc * w_loc * cell
    # each half-sweep extends the opposite plane by one cell a side
    halo = 2 * ((n_loc + 2) * (w_loc + 2) - n_loc * w_loc) * cell
    plan = plan_shard_resident(family, n, m, grid.rows_devs, grid.cols_devs)
    plan_rec = None
    if plan is not None:
        plan_rec = {"family": family, "k": plan.k, "halo": plan.halo,
                    "extended": [n_loc + 2 * plan.halo,
                                 w_loc + 2 * plan.halo],
                    "tile": [plan.tile_rows, plan.tile_cols, plan.threads],
                    "smem_bytes": plan.smem_bytes,
                    "halo_bytes_per_exchange": plan.halo_bytes_per_exchange
                    // mesh.size}
    table_bytes = table.numel() * table.element_size()
    return {"counter": counter, "shard": [n_loc, w_loc],
            "grid": [grid.rows_devs, grid.cols_devs],
            "state_bytes": state, "halo_bytes": halo, "plan": plan_rec,
            "memory": {"argument_size_in_bytes": state + table_bytes,
                       "output_size_in_bytes": state,
                       "alias_size_in_bytes": 0},
            "collectives": roofline.collective_bytes(halo=halo)}, None


# ---------------------------------------------------------------------------
# cell runner
# ---------------------------------------------------------------------------

def run_cell(arch: str, shape_name: str, mesh_kind: str, *,
             fsdp=None, smoke: bool = False,
             verbose: bool = True) -> Dict:
    mesh = make_production_mesh(multi_pod=(mesh_kind == "multi"),
                                device=META)
    rec: Dict = {"arch": arch, "shape": shape_name, "mesh": mesh_kind,
                 "chips": mesh.size}
    t0 = time.time()
    ising = arch.startswith("ising")
    engine = (arch.split("-", 1)[1] if "-" in arch else "multispin") \
        if ising else None
    try:
        if ising:
            cell, skip = lower_ising_cell(shape_name, mesh, engine)
            n, m = ISING_SHAPES[shape_name]
            rec["spins"] = float(n) * m
        else:
            cell, skip = lower_lm_cell(arch, shape_name, mesh, fsdp=fsdp,
                                       smoke=smoke)
        if cell is None:
            rec["status"] = "skipped"
            rec["skip_reason"] = skip
            return rec
        rec["compile_s"] = round(time.time() - t0, 1)
        counter, coll, mem = (cell.pop("counter"), cell.pop("collectives"),
                              cell.pop("memory"))
        if ising:
            cost = {"flops": float(counter.flops),
                    "bytes": float(counter.bytes)}
        else:
            cost = {"flops": counter.flops / mesh.size,
                    "bytes": counter.bytes / mesh.size}
        terms = roofline.roofline_terms(cost["flops"], cost["bytes"], coll,
                                        mesh.size)
        rec.update(status="ok", **cost, collectives=coll, **terms,
                   memory=mem, cost_correction="none: every layer counted",
                   **cell)
        if ising:
            # the flip-cost model's bytes/flip of the engine's state
            # layout next to what the counted step moves, and the
            # flips/ns the H100 row admits
            fc = roofline.flip_cost(engine)
            flips_per_dev = rec["spins"] * fc.replicas / mesh.size
            rec["engine"] = engine
            rec["model_bytes_per_flip"] = fc.bytes_per_flip
            rec["counted_bytes_per_flip"] = cost["bytes"] / flips_per_dev
            rec["peak_flips_per_ns_per_device"] = \
                roofline.roofline_flips_per_ns(engine, "cuda")
        if verbose:
            print(f"-- {arch} x {shape_name} x {mesh_kind} "
                  f"({rec['compile_s']}s)")
            print(f"   memory: {mem}")
            print(f"   counted: flops={cost['flops']:.3e} "
                  f"bytes={cost['bytes']:.3e}")
            print(f"   collectives: { {k: v for k, v in coll.items() if v} }")
            print(f"   roofline: compute={terms['t_compute_s']:.4f}s "
                  f"memory={terms['t_memory_s']:.4f}s "
                  f"collective={terms['t_collective_s']:.4f}s "
                  f"dominant={terms['dominant']}")
    except Exception as e:  # a failing cell is a bug; record and continue
        rec["status"] = "error"
        rec["error"] = f"{type(e).__name__}: {e}"
        rec["traceback"] = traceback.format_exc()[-2000:]
        if verbose:
            print(f"-- {arch} x {shape_name} x {mesh_kind} FAILED: "
                  f"{rec['error']}")
    return rec


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="all",
                    help="arch id | all | ising-multispin | "
                         "ising-bitplane | ising-basic")
    ap.add_argument("--shape", default="all")
    ap.add_argument("--mesh", default="both",
                    choices=["single", "multi", "both"])
    ap.add_argument("--out", default="results/dryrun_torch.json")
    ap.add_argument("--no-fsdp", action="store_true",
                    help="force FSDP off (default: auto policy)")
    ap.add_argument("--smoke", action="store_true",
                    help="reduced configs (CI sanity of the harness)")
    args = ap.parse_args(argv)

    archs = list(ARCH_IDS) if args.arch == "all" else [args.arch]
    meshes = (["single", "multi"] if args.mesh == "both" else [args.mesh])

    results = []
    if os.path.exists(args.out):
        with open(args.out) as f:
            results = json.load(f)
    done = {(r["arch"], r["shape"], r["mesh"]) for r in results
            if r.get("status") in ("ok", "skipped")}

    for arch in archs:
        shapes = (list(ISING_SHAPES) if arch.startswith("ising")
                  else list(SHAPES))
        if args.shape != "all":
            shapes = [args.shape]
        for shape in shapes:
            for mk in meshes:
                if (arch, shape, mk) in done:
                    continue
                rec = run_cell(arch, shape, mk,
                               fsdp=False if args.no_fsdp else None,
                               smoke=args.smoke)
                results = [r for r in results
                           if (r["arch"], r["shape"], r["mesh"])
                           != (arch, shape, mk)]
                results.append(rec)
                os.makedirs(os.path.dirname(args.out) or ".",
                            exist_ok=True)
                with open(args.out, "w") as f:
                    json.dump(results, f, indent=1)
    bad = [r for r in results if r.get("status") == "error"]
    print(f"\n{len(results)} cells, {len(bad)} errors")
    return 1 if bad else 0


if __name__ == "__main__":
    raise SystemExit(main())
