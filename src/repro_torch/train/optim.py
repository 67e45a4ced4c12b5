"""AdamW with global-norm clipping and a warmup-cosine schedule.

Counterpart of ``repro.train.optim``: plain functions on tensors (no
``torch.optim``).  The state is ``{"mu", "nu", "count"}``: f32 moments
shaped as the parameters (a :class:`~repro_torch.models.layers.Params`
tree for a model's, so :func:`opt_to_jax` maps them by the same paths as
``params_to_jax``) and a 0-d int32 ``count``, so a checkpoint's keys and
shapes are JAX's (``opt/mu/...``, ``opt/nu/...``, ``opt/count``).

A tree is a ``Params`` (its parameters in registration order), a dict
(its values by sorted key, as JAX flattens one), a list or tuple, or a
tensor; trees passed together have their leaves in the same order.

Weight decay applies to matrices only, by the JAX leaf's ``ndim``: JAX
stacks the layers of ``blocks``, ``dense_blocks``, ``moe_blocks``,
``enc_blocks`` and ``dec_blocks`` on a leading axis, so a stacked
layer's norm scale or bias is a matrix there and decays; the port holds
one ``Params`` a layer, and counts that axis in (:func:`decay_mask`).

A tree placed on a mesh of several shards
(:class:`~repro_torch.models.shards.Sharded`) updates piece by piece:
its leaves are every shard's pieces, shard by shard; the moments take
the same layout; the clip's global norm counts each element of the
whole tree once (a replicated block on its first holder alone), and a
replicated block's copies, taking the same gradient, stay equal.
"""
from __future__ import annotations

import dataclasses
import math
from typing import List

import torch
from torch import nn

from repro_torch.models.convert import STACKED, params_from_jax, \
    params_to_jax
from repro_torch.models.layers import Params
from repro_torch.models.shards import Sharded


@dataclasses.dataclass(frozen=True)
class OptConfig:
    lr: float = 3e-4
    warmup: int = 100
    total_steps: int = 10_000
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0


def leaves(tree) -> List[torch.Tensor]:
    """The tensors of a tree, in its order."""
    if isinstance(tree, Sharded):
        return tree.leaves()
    if isinstance(tree, nn.Module):
        return list(tree.parameters())
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in leaves(v)]
    return [tree]


def tree_map(fn, tree):
    """``tree`` with each tensor ``t`` replaced by ``fn(t)``; a ``Params``
    maps to a ``Params`` (an ``nn.ModuleList`` to one), a ``Sharded``
    to one of its layout."""
    if isinstance(tree, Sharded):
        return tree.map(fn)
    if isinstance(tree, Params):
        return Params({k: tree_map(fn, tree[k]) for k in tree.keys()})
    if isinstance(tree, nn.ModuleList):
        return nn.ModuleList([tree_map(fn, x) for x in tree])
    if isinstance(tree, dict):
        return {k: tree_map(fn, tree[k]) for k in sorted(tree)}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, v) for v in tree)
    return fn(tree)


def decay_mask(params) -> List[bool]:
    """Per leaf: whether weight decay applies (the JAX leaf's ``ndim`` is
    at least 2; a layer of a stack counts the stack's axis)."""
    if isinstance(params, Sharded):
        return [d for t in params.pieces for d in decay_mask(t)]
    if isinstance(params, nn.Module):
        return [p.dim() + (name.split(".")[0] in STACKED) >= 2
                for name, p in params.named_parameters()]
    return [p.dim() >= 2 for p in leaves(params)]


def schedule(cfg: OptConfig, step) -> torch.Tensor:
    """The learning rate at ``step`` (a tensor or an int), f32."""
    step = torch.as_tensor(step).to(torch.float32)
    warm = torch.clamp(step / max(cfg.warmup, 1), max=1.0)
    prog = torch.clamp((step - cfg.warmup)
                       / max(cfg.total_steps - cfg.warmup, 1), 0.0, 1.0)
    cos = 0.5 * (1.0 + torch.cos(math.pi * prog))
    return cfg.lr * warm * (0.1 + 0.9 * cos)


def init(params) -> dict:
    zeros = tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                           device=p.device), params)
    count_device = leaves(params)[0].device
    return {"mu": zeros,
            "nu": tree_map(torch.zeros_like, zeros),
            "count": torch.zeros((), dtype=torch.int32,
                                 device=count_device)}


def counted(tree) -> List[bool]:
    """Per leaf: whether :func:`global_norm` of a tree of its layout
    counts it (on a mesh, a block's first holder's piece alone)."""
    if isinstance(tree, Sharded):
        return tree.firsts()
    return [True] * len(leaves(tree))


def global_norm(tree, counts=None) -> torch.Tensor:
    """sqrt of the sum of every leaf's squares, in f32, over the leaves
    whose entry of ``counts`` is true (default all), on the first
    leaf's device."""
    xs = leaves(tree)
    if counts is not None:
        xs = [x for x, c in zip(xs, counts) if c]
    norms = torch._foreach_norm([x.float() for x in xs])
    device = norms[0].device
    return torch.linalg.vector_norm(torch.stack([n.to(device)
                                                 for n in norms]))


@torch.no_grad()
def update(cfg: OptConfig, grads, params, state):
    """Returns ``(params, state, metrics)``, ``params`` and ``state``
    updated in place and returned as the same objects (the PyTorch
    idiom; JAX returns new trees).  ``grads`` is left as it is.
    ``metrics`` holds ``grad_norm`` and ``lr`` as 0-d tensors."""
    g_leaves = leaves(grads)
    gnorm = global_norm(g_leaves, counted(params))
    scale = torch.clamp(cfg.clip_norm / (gnorm + 1e-9), max=1.0)

    state["count"].add_(1)
    count = state["count"].to(torch.float32)
    lr = schedule(cfg, count)
    b1c = 1.0 - torch.pow(cfg.b1, count)
    b2c = 1.0 - torch.pow(cfg.b2, count)
    on = {}     # the step's scalars on each piece's device

    for p, g, m, v, decay in zip(leaves(params), g_leaves,
                                 leaves(state["mu"]), leaves(state["nu"]),
                                 decay_mask(params)):
        if p.device not in on:
            on[p.device] = [x.to(p.device) for x in (scale, lr, b1c, b2c)]
        p_scale, p_lr, p_b1c, p_b2c = on[p.device]
        g = g.to(torch.float32) * p_scale
        m.mul_(cfg.b1).add_((1 - cfg.b1) * g)
        v.mul_(cfg.b2).add_((1 - cfg.b2) * g * g)
        upd = (m / p_b1c) / (torch.sqrt(v / p_b2c) + cfg.eps)
        if decay:  # decoupled weight decay on matrices only
            upd = upd + cfg.weight_decay * p.to(torch.float32)
        p.copy_(p.to(torch.float32) - p_lr * upd)
    return params, state, {"grad_norm": gnorm, "lr": lr}


def opt_to_jax(cfg, state) -> dict:
    """A model's optimizer state in JAX's layout (nested dicts of numpy
    arrays, the moments' stacks stacked, ``count`` an int32 scalar)."""
    return {"mu": params_to_jax(cfg, state["mu"]),
            "nu": params_to_jax(cfg, state["nu"]),
            "count": state["count"].detach().to("cpu", copy=True).numpy()}


def opt_from_jax(cfg, tree: dict, *, device=None, shardings=None) -> dict:
    """The port's optimizer state from JAX's layout, on ``device``
    (default the CUDA card; raises without one) or laid out by the
    parameters' ``shardings`` (``params_from_jax``'s)."""
    mu = params_from_jax(cfg, tree["mu"], device=device, shardings=shardings)
    return {"mu": mu, "nu": params_from_jax(cfg, tree["nu"], device=device,
                                            shardings=shardings),
            "count": torch.tensor(int(tree["count"]), dtype=torch.int32,
                                  device=leaves(mu)[0].device)}
