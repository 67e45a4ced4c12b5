"""A parameter tree on a mesh of several shards: each leaf as its pieces.

Counterpart of a JAX array that ``jax.device_put`` lays out by a
``NamedSharding``.  :class:`Sharded` holds one tree a shard
(``pieces[i]``, a :class:`~repro_torch.models.layers.Params` of JAX's
structure on ``mesh.device_of(i)``) whose leaf at each path is the block
``sharding.index(i, shape)`` of the whole leaf: a replicated entry a
whole copy.  On one device several shards still hold separate pieces,
as ``launch.roofline.memory_per_device`` counts a device's bytes.

The train step computes a shard's rows with the whole weights of a
layer, gathered on the shard's device from their pieces by
:class:`Gather` (FSDP's all-gather), whose backward cuts the cotangent
into every piece's block.  :class:`Spread` then gives each piece the
sum of its cuts over the computing shards, in shard order: a
reduce-scatter, and for a replicated block an all-reduce, so replicated
copies take the same gradient and stay equal, and the sum is the same
bit for bit whichever card's autograd thread finishes first.

Works with ``repro_torch.train.sharding.NamedSharding`` (``index``,
``mesh``) and ``repro_torch.launch.mesh.Mesh`` (``size``,
``device_of``), which it takes as given.
"""
from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

import torch
from torch import nn

from .layers import Params


def paths(tree: nn.Module) -> Dict[str, torch.Tensor]:
    """``{path: leaf}`` of a tree, ``/``-separated, in the tree's order."""
    return {name.replace(".", "/"): p for name, p in tree.named_parameters()}


def _rebuild(tree: nn.Module, leaf_of, prefix: str = "") -> Params:
    """A tree of ``tree``'s structure, ``leaf_of(path)`` at each leaf.
    (Recursive at module level: a nested recursive function is a
    reference cycle, and would hold ``leaf_of``'s tensors until the
    garbage collector runs.)"""
    if isinstance(tree, nn.ModuleList):
        return nn.ModuleList([_rebuild(m, leaf_of, f"{prefix}{i}/")
                              for i, m in enumerate(tree)])
    return Params({k: _rebuild(tree[k], leaf_of, f"{prefix}{k}/")
                   if isinstance(tree[k], nn.Module)
                   else leaf_of(prefix + k) for k in tree.keys()})


def _assemble(blocks, device, shape, pieces) -> torch.Tensor:
    """The whole leaf of ``shape`` on ``device``, each ``(idx, source)``
    of ``blocks`` copied from ``pieces[source]`` into ``idx``."""
    whole = torch.empty(shape, dtype=pieces[0].dtype, device=device)
    for idx, source in blocks:
        whole[idx] = pieces[source]
    return whole


class Spread(torch.autograd.Function):
    """``apply(sums, devices, *pieces)``: one empty ticket a shard, on
    ``devices[j]``, that shard ``j``'s :class:`Gather` of the leaf takes
    as its input.  Backward, which runs once every gather has: piece
    ``k``'s gradient is the sum of ``sums[j][k]`` over the shards ``j``
    in their order.  Each gather adds its cuts into its own shard's
    entry of ``sums``, so no two cards' autograd threads add into one
    tensor, and the reduction's order does not hang on which of them
    comes first: a step on several cards is bit for bit repeatable."""

    @staticmethod
    def forward(ctx, sums, devices, *pieces):
        ctx.sums = sums
        ctx.devices = [p.device for p in pieces]
        return tuple(torch.empty(0, device=d) for d in devices)

    @staticmethod
    def backward(ctx, *tickets):
        # the graph, and so ctx, lives on until the loss is dropped: keep
        # no cut past this call
        sums = list(ctx.sums)
        ctx.sums[:] = [None] * len(sums)
        grads = []
        for k, dev in enumerate(ctx.devices):
            total = None
            for cuts in sums:
                if cuts is not None:
                    g = cuts[k].to(dev)
                    total = g if total is None else total + g
            grads.append(total)
        return (None, None, *grads)


class Gather(torch.autograd.Function):
    """``apply(blocks, index, device, shape, pieces, sums, j, ticket)``:
    the whole leaf on shard ``j``'s ``device`` (:func:`_assemble`).
    Backward: the cotangent's block ``index[k]`` of every piece ``k``,
    added into ``sums[j]`` for :class:`Spread`, whose ``ticket`` ties
    this gather to it."""

    @staticmethod
    def forward(ctx, blocks, index, device, shape, pieces, sums, j, ticket):
        ctx.index, ctx.sums, ctx.j = index, sums, j
        return _assemble(blocks, device, shape, pieces)

    @staticmethod
    def backward(ctx, g):
        cuts = [g[idx] for idx in ctx.index]
        have = ctx.sums[ctx.j]
        ctx.sums[ctx.j] = cuts if have is None else [
            a + b for a, b in zip(have, cuts)]
        return (None,) * 7 + (g.new_zeros(0),)


class Sharded:
    """A tree laid out on a mesh: ``pieces[i]`` is shard ``i``'s tree.

    ``shardings``: ``{path: NamedSharding}`` of every leaf;
    ``shapes``: ``{path: whole shape}``.  Build one with
    :meth:`scatter` (``repro_torch.train.sharding.place``)."""

    def __init__(self, shardings, shapes, pieces: Sequence[Params]):
        self.shardings = dict(shardings)
        self.shapes = {p: tuple(s) for p, s in shapes.items()}
        self.mesh = next(iter(self.shardings.values())).mesh
        self.pieces = list(pieces)
        if len(self.pieces) != self.mesh.size:
            raise ValueError(f"{len(self.pieces)} pieces for a mesh of "
                             f"{self.mesh.size} shards")
        self._leaf = [paths(t) for t in self.pieces]
        # per path: each shard's block, and the shards holding each block
        self.index, self.holders, self._plans = {}, {}, {}
        for path, sh in self.shardings.items():
            idx = [sh.index(i, self.shapes[path])
                   for i in range(self.mesh.size)]
            held: Dict[tuple, List[int]] = {}
            for i, block in enumerate(idx):
                held.setdefault(_key(block), []).append(i)
            self.index[path], self.holders[path] = idx, held

    # -- making one ------------------------------------------------------

    @classmethod
    def scatter(cls, tree: nn.Module, shardings) -> "Sharded":
        """Each shard's blocks of the whole ``tree`` (on any device),
        copied onto its device."""
        whole = paths(tree)
        mesh = next(iter(shardings.values())).mesh
        for path, sh in shardings.items():
            sh.check(whole[path].shape)
        pieces = [_rebuild(tree, lambda p, i=i: whole[p].detach()[
            shardings[p].index(i, whole[p].shape)].to(
                mesh.device_of(i), copy=True))
            for i in range(mesh.size)]
        return cls(shardings, {p: whole[p].shape for p in whole}, pieces)

    def map(self, fn) -> "Sharded":
        """The same layout, ``fn(piece)`` at each piece (AdamW's
        moments)."""
        return Sharded(self.shardings, self.shapes,
                       [_rebuild(t, lambda p, i=i: fn(self._leaf[i][p]))
                        for i, t in enumerate(self.pieces)])

    # -- reading it ------------------------------------------------------

    def leaves(self) -> List[torch.Tensor]:
        """Every piece, shard by shard, each in the tree's order."""
        return [x for t in self.pieces for x in t.parameters()]

    def firsts(self) -> List[bool]:
        """Per entry of :meth:`leaves`: whether that shard is the first
        holder of its block (so a sum over those counts each element of
        the whole tree once)."""
        return [self.holders[p][_key(self.index[p][i])][0] == i
                for i, t in enumerate(self.pieces) for p in paths(t)]

    def whole(self, path: str, device) -> torch.Tensor:
        """A copy of the whole leaf at ``path`` on ``device`` (no
        gradient)."""
        out = torch.empty(self.shapes[path],
                          dtype=self._leaf[0][path].dtype, device=device)
        for block, (first, *_) in self.holders[path].items():
            out[self.index[path][first]] = self._leaf[first][path].detach()
        return out

    def tree(self, device="cpu") -> Params:
        """The whole tree as copies on ``device``."""
        return _rebuild(self.pieces[0], lambda p: self.whole(p, device))

    # -- the forward's view (repro_torch.models.model.forward_parts) --------

    def plan(self, path: str, j: int) -> list:
        """``(idx, source)`` per block of the leaf at ``path``: each block
        from shard ``j`` itself where it holds it, else from a holder on
        its device, else from the first holder."""
        blocks = self._plans.get((path, j))
        if blocks is None:
            device, idx = self.mesh.device_of(j), self.index[path]
            blocks = []
            for holders in self.holders[path].values():
                near = [i for i in holders
                        if self.mesh.device_of(i) == device]
                source = j if j in holders else (near or holders)[0]
                blocks.append((idx[source], source))
            self._plans[(path, j)] = blocks
        return blocks


class Reader:
    """One forward's view of a :class:`Sharded` tree (``count``,
    ``take``), with one :class:`Spread` a leaf that the forward gathers
    with a gradient, so its pieces' gradients are reduced once, in shard
    order, whatever the number of gathers (remat's recomputation gathers
    again and adds nothing)."""

    def __init__(self, tree: Sharded):
        self.tree = tree
        self._spreads: Dict[str, tuple] = {}

    def count(self, key: str) -> int:
        return len(self.tree.pieces[0][key])

    def take(self, j: int, *keys):
        """The node at ``keys`` (``"blocks", 3`` or ``"embed", "table"``)
        whole on shard ``j``'s device: a tensor at a leaf, else a nested
        dict of tensors, each gathered by :class:`Gather`."""
        node, prefix = self.tree.pieces[0], ""
        for k in keys:
            node = node[k]
            prefix += f"{k}/"
        if not isinstance(node, nn.Module):
            return self._gather(j, prefix[:-1])
        if isinstance(node, nn.ModuleList):
            raise ValueError(f"{prefix}: a list of layers, take one")
        return self._build(j, node, prefix)

    def _build(self, j: int, node: nn.Module, prefix: str) -> dict:
        return {k: self._build(j, node[k], f"{prefix}{k}/")
                if isinstance(node[k], nn.Module)
                else self._gather(j, prefix + k) for k in node.keys()}

    def _gather(self, j: int, path: str) -> torch.Tensor:
        tree = self.tree
        blocks, device = tree.plan(path, j), tree.mesh.device_of(j)
        shape, pieces = tree.shapes[path], tuple(t[path] for t in tree._leaf)
        if not (torch.is_grad_enabled()
                and any(p.requires_grad for p in pieces)):
            return _assemble(blocks, device, shape, pieces)
        if path not in self._spreads:
            sums = [None] * tree.mesh.size
            devices = [tree.mesh.device_of(i) for i in range(tree.mesh.size)]
            self._spreads[path] = sums, Spread.apply(sums, devices, *pieces)
        sums, tickets = self._spreads[path]
        return Gather.apply(blocks, tree.index[path], device, shape, pieces,
                            sums, j, tickets[j])


def split_rows(params, batch) -> list:
    """The ``(shard, rows)`` parts of ``batch`` that the shards compute:
    the whole batch on shard 0 for a tree on one device; for a
    :class:`Sharded` tree, contiguous blocks of rows, one a shard in the
    mesh's row-major order (the data axes first, as ``batch_specs`` cuts
    them, then each data group again over ``model``;
    ``torch.tensor_split``, so uneven blocks are allowed), each on its
    shard's device, the empty ones left out."""
    if not isinstance(params, Sharded):
        return [(0, batch)]
    mesh = params.mesh
    cut = {k: torch.tensor_split(v, mesh.size) for k, v in batch.items()}
    return [(i, {k: c[i].to(mesh.device_of(i)) for k, c in cut.items()})
            for i in range(mesh.size) if len(cut["tokens"][i])]


def weigh(parts, values, rows: int, device) -> torch.Tensor:
    """The sum over ``parts`` (:func:`split_rows`'s) of each part's entry
    of ``values`` (a mean over its rows) times its rows over ``rows``,
    on ``device``: the mean over the batch's ``rows``."""
    return sum(v.to(device) * (len(part["tokens"]) / rows)
               for (_, part), v in zip(parts, values))


def _key(block: Tuple[slice, ...]) -> tuple:
    return tuple((s.start, s.stop) for s in block)
