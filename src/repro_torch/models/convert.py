"""The JAX package's LM parameter trees in the port, and back.

JAX stacks each family's layers on a leading axis (``blocks``,
``dense_blocks``, ``moe_blocks``, ``enc_blocks``, ``dec_blocks``); the
port holds one :class:`~repro_torch.models.layers.Params` a layer in an
``nn.ModuleList``.  The hybrid family's ``shared_attn`` is one block in
both, shared by every layer that runs it, and xLSTM's ``blocks_list`` is
a list in both.  Trees travel as nested dicts (and lists) of numpy
arrays: ``jax.tree.map(np.asarray, params)`` on the JAX side.

A tree on a mesh of several shards
(:class:`~repro_torch.models.shards.Sharded`) travels whole: its pieces
are gathered into JAX's full arrays, and a full tree is scattered onto
a mesh by the parameters' shardings, so a checkpoint has JAX's layout
whatever mesh wrote it and restores on any other.
"""
from __future__ import annotations

import numpy as np
import torch
from torch import nn

from repro_torch.api.session import resolve_device
from repro_torch.configs.base import ArchConfig

from .layers import Params
from .shards import Sharded

#: the tree's keys whose arrays carry a leading layer axis in JAX
STACKED = ("blocks", "dense_blocks", "moe_blocks", "enc_blocks",
           "dec_blocks")


def _stack_sizes(cfg: ArchConfig) -> dict:
    if cfg.family in ("dense", "vlm", "hybrid"):
        return {"blocks": cfg.n_layers}
    if cfg.family == "moe":
        return {"dense_blocks": cfg.first_dense,
                "moe_blocks": cfg.n_layers - cfg.first_dense}
    if cfg.family == "audio":
        return {"enc_blocks": cfg.enc_layers, "dec_blocks": cfg.n_layers}
    return {}


def _node(tree, device) -> Params:
    return Params({k: _node(v, device) if isinstance(v, dict)
                   else nn.ModuleList([_node(x, device) for x in v])
                   if isinstance(v, (list, tuple))
                   else torch.tensor(np.asarray(v, np.float32),
                                     device=device)
                   for k, v in tree.items()})


def _layer(tree, i: int) -> dict:
    return {k: _layer(v, i) if isinstance(v, dict) else v[i]
            for k, v in tree.items()}


def params_from_jax(cfg: ArchConfig, tree: dict, *, device=None,
                    shardings=None):
    """The port's parameter tree from a JAX one (nested dicts of numpy
    arrays), its stacks unstacked, on ``device`` (default the CUDA card;
    raises without one).  With ``shardings`` (``{path: NamedSharding}``,
    ``repro_torch.train.sharding.param_shardings``) it is laid out on
    their mesh instead, as ``place`` lays it: whole on the device of a
    mesh of one shard, else a :class:`Sharded` tree of each shard's
    pieces (cut from the host's arrays, ``device`` unused)."""
    if shardings:
        mesh = next(iter(shardings.values())).mesh
        if mesh.size > 1:
            return Sharded.scatter(params_from_jax(cfg, tree, device="cpu"),
                                   shardings)
        device = mesh.device_of(0)
    device = resolve_device(device)
    sizes = _stack_sizes(cfg)
    if set(sizes) != {k for k in tree if k in STACKED}:
        raise ValueError(f"a {cfg.family} tree has the stacks "
                         f"{sorted(sizes)}, got {sorted(tree)}")
    out = Params()
    for key, value in tree.items():
        if key in STACKED:
            n = len(next(iter(_leaves(value))))
            if n != sizes[key]:
                raise ValueError(f"{key}: {n} layers, {cfg.name} has "
                                 f"{sizes[key]}")
            out[key] = nn.ModuleList([_node(_layer(value, i), device)
                                      for i in range(n)])
        else:
            out[key] = _node({key: value}, device)[key]
    return out


def _leaves(tree):
    for v in tree.values():
        if isinstance(v, dict):
            yield from _leaves(v)
        else:
            yield v


def _host(t: torch.Tensor) -> np.ndarray:
    """A host copy (on the CPU too: not a view of a tensor that a
    training step updates in place)."""
    return t.detach().to("cpu", copy=True).numpy()


def _tree(node) -> dict:
    if isinstance(node, nn.ModuleList):
        return [_tree(x) for x in node]
    return {k: _tree(node[k]) if isinstance(node[k], nn.Module)
            else _host(node[k]) for k in node.keys()}


def params_to_jax(cfg: ArchConfig, params) -> dict:
    """The JAX layout of the port's tree: nested dicts of numpy arrays
    (host copies), each stack's layers stacked on a leading axis; a
    :class:`Sharded` tree's pieces gathered into whole arrays."""
    if isinstance(params, Sharded):
        params = params.tree("cpu")
    out = {}
    for key in params.keys():
        node = params[key]
        if key in STACKED:
            layers = [_tree(x) for x in node]
            out[key] = _stack(layers)
        else:
            out[key] = _tree(node) if isinstance(node, nn.Module) \
                else _host(node)
    if set(_stack_sizes(cfg)) != {k for k in out if k in STACKED}:
        raise ValueError(f"not a {cfg.family} tree: {sorted(out)}")
    return out


def _stack(layers: list) -> dict:
    first = layers[0]
    return {k: _stack([x[k] for x in layers]) if isinstance(first[k], dict)
            else np.stack([x[k] for x in layers]) for k in first}
