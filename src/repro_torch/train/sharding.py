"""Sharding rules: parameter, batch and cache trees -> partition specs.

Counterpart of ``repro.train.sharding``.  Parallelism:

* data parallel over ``(pod, data)`` (all mesh axes but the last),
* tensor parallel over ``model`` (heads / ffn-hidden / vocab / experts),
* expert parallel: MoE expert axis on ``model``,
* sequence parallel: activation constraints between blocks (train step),
* optional FSDP: weight d_model axes additionally sharded over the DP axes.

Rules are name-based with a divisibility guard: an axis is only sharded
when its size divides the mesh axis product (e.g. whisper's 20 heads and
51866 vocab fall back to replicated on a 16-wide model axis).  The rules
and their order are the JAX package's, substring match included
(``"attn/wq"`` also matches ``xattn/wq``).

JAX stacks each family's layers on a leading axis; the port holds one
:class:`~repro_torch.models.layers.Params` a layer, so a leaf's path
carries the layer's index (``blocks/3/attn/wq``) and its shape has no
stack axis.  :func:`param_shardings` matches a layer's leaf as JAX
matches the stacked one, on the stacked shape, and drops the stack's
entry: the port's spec is JAX's with its leading entry dropped.  That
matters where a template is as long as the stacked leaf: JAX's
``attn/wk`` rule also catches ``attn/wkr`` (MLA's rope key, 2-D a
layer), its 3-entry template then takes the stack axis for its first
entry, and ``wkr``'s d_model dim lands on the model axis.

:class:`P` is the counterpart of ``jax.sharding.PartitionSpec``: a tuple
with one entry a leading dim, ``None`` (whole), an axis name or a tuple
of names (sharded over their product); dims past its end are whole.
:class:`NamedSharding` pairs a spec with a
:class:`~repro_torch.launch.mesh.Mesh` and gives shard shapes and
indices.  :func:`place` lays a tree out on a mesh as ``jax.device_put``
lays it out by these shardings: each shard holds its ``index`` block of
each leaf (:class:`~repro_torch.models.shards.Sharded`).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Tuple

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.models.convert import STACKED
from repro_torch.models.shards import Sharded


class P(tuple):
    """A partition spec: ``P("model", None)``, ``P(("pod", "data"),
    None)``; ``P()`` replicates."""

    def __new__(cls, *entries):
        return super().__new__(cls, entries)

    def __repr__(self) -> str:
        return "P(" + ", ".join(repr(e) for e in self) + ")"


def _entry_axes(entry) -> Tuple[str, ...]:
    if entry is None:
        return ()
    return (entry,) if isinstance(entry, str) else tuple(entry)


@dataclasses.dataclass(frozen=True)
class NamedSharding:
    """``spec`` over ``mesh``: dim ``d`` of a leaf is cut into
    ``mesh.axis_size(axes)`` equal blocks along the entry's axes."""

    mesh: object
    spec: P

    def check(self, global_shape) -> None:
        """Raises ValueError unless the spec fits a leaf of this shape:
        no more entries than dims, known axes, no axis twice, and every
        sharded dim divisible by its axes' product."""
        shape = tuple(global_shape)
        if len(self.spec) > len(shape):
            raise ValueError(f"{self.spec} has more entries than the "
                             f"{len(shape)} dims of {shape}")
        seen = []
        for dim, entry in zip(shape, self.spec):
            axes = _entry_axes(entry)
            for a in axes:
                if a not in self.mesh.axis_names:
                    raise ValueError(f"{self.spec}: no mesh axis {a!r} in "
                                     f"{self.mesh.axis_names}")
                if a in seen:
                    raise ValueError(f"{self.spec}: axis {a!r} twice")
                seen.append(a)
            if dim % self.mesh.axis_size(axes):
                raise ValueError(f"{self.spec}: dim {dim} of {shape} does "
                                 f"not divide {axes}")

    def shard_shape(self, global_shape) -> Tuple[int, ...]:
        """The shape of each shard of a leaf of ``global_shape``."""
        self.check(global_shape)
        shape = list(global_shape)
        for d, entry in enumerate(self.spec):
            shape[d] //= self.mesh.axis_size(_entry_axes(entry))
        return tuple(shape)

    def index(self, i: int, global_shape) -> Tuple[slice, ...]:
        """The block of the leaf that shard ``i`` of the mesh holds."""
        local = self.shard_shape(global_shape)
        out = []
        for d, size in enumerate(local):
            axes = _entry_axes(self.spec[d]) if d < len(self.spec) else ()
            start = self.mesh.axis_index(i, axes) * size if axes else 0
            out.append(slice(start, start + size))
        return tuple(out)

    def shard_bytes(self, leaf: torch.Tensor) -> int:
        """Bytes of one shard of ``leaf`` (a tensor on any device)."""
        n = 1
        for d in self.shard_shape(leaf.shape):
            n *= d
        return n * leaf.element_size()


def mesh_axes(mesh) -> Tuple[Tuple[str, ...], Tuple[str, ...]]:
    """(dp_axes, tp_axes): all-but-last vs last mesh axis."""
    names = tuple(mesh.axis_names)
    return names[:-1], names[-1:]


# (substring, spec template) -- axis entries: "tp" / "dp" / None; the
# template is positional over the trailing dims of the weight
_RULES = [
    ("embed/table", ("tp", "dp_fsdp")),
    # heads on tp; if the head count doesn't divide the model axis
    # (phi4: 24, whisper: 20), fall back to sharding head_dim
    ("attn/wq", ("dp_fsdp", "tp|alt", "alt")),
    ("attn/wk", ("dp_fsdp", "tp|alt", "alt")),
    ("attn/wv", ("dp_fsdp", "tp|alt", "alt")),
    ("attn/wo", ("tp|alt", "alt", "dp_fsdp")),
    ("attn/wdkv", ("dp_fsdp", None)),
    ("attn/wkr", ("dp_fsdp", None)),
    ("attn/wuk", (None, "tp", None)),
    ("attn/wuv", (None, "tp", None)),
    ("xattn/wq", ("dp_fsdp", "tp|alt", "alt")),
    ("xattn/wk", ("dp_fsdp", "tp|alt", "alt")),
    ("xattn/wv", ("dp_fsdp", "tp|alt", "alt")),
    ("xattn/wo", ("tp|alt", "alt", "dp_fsdp")),
    ("mlp/wi", ("dp_fsdp", "tp")),
    ("mlp/wg", ("dp_fsdp", "tp")),
    ("mlp/wo", ("tp", "dp_fsdp")),
    ("moe/router", (None, None)),
    ("moe/wi", ("tp", "dp_fsdp", None)),     # expert parallel
    ("moe/wg", ("tp", "dp_fsdp", None)),
    ("moe/wo", ("tp", "dp_fsdp", None)),
    ("moe/shared_wi", ("dp_fsdp", "tp")),
    ("moe/shared_wg", ("dp_fsdp", "tp")),
    ("moe/shared_wo", ("tp", "dp_fsdp")),
    ("mamba/in_proj", ("dp_fsdp", "tp")),
    ("mamba/out_proj", ("tp", "dp_fsdp")),
    ("cell/wqkv", ("dp_fsdp", None, None, "tp")),
    ("cell/ogate", ("dp_fsdp", "tp")),
    ("cell/wo", ("tp", "dp_fsdp")),
    ("cell/wx", ("dp_fsdp", None, "tp")),
    ("cell/wh", ("dp_fsdp", None, "tp")),
]


def _single(axes: Tuple[str, ...]):
    """An entry for ``axes``: the name alone where there is one."""
    return axes if len(axes) > 1 else axes[0]


def param_spec(path_str: str, shape, mesh, *, fsdp: bool) -> P:
    """The spec of the leaf at ``path_str`` (``/``-separated) with
    ``shape``: the first rule whose pattern is a substring of the path."""
    dp_axes, tp_axes = mesh_axes(mesh)
    tp = mesh.axis_size(tp_axes)
    dp = mesh.axis_size(dp_axes)
    for pat, template in _RULES:
        if pat in path_str:
            nt = len(template)
            lead = len(shape) - nt
            if lead < 0:
                return P()
            entries = [None] * lead
            dims = shape[lead:]
            tp_entry = _single(tp_axes)
            # 'tp|alt' shards on tp when divisible; otherwise the 'alt'
            # position (head_dim) takes the model axis instead
            primary_ok = any(isinstance(r, str) and r.startswith("tp")
                             and d % tp == 0
                             for d, r in zip(dims, template))
            for dim, role in zip(dims, template):
                role = role or ""
                if role.startswith("tp") and dim % tp == 0:
                    entries.append(tp_entry)
                elif role == "alt" and not primary_ok and dim % tp == 0:
                    entries.append(tp_entry)
                elif role == "dp_fsdp" and fsdp and dim % dp == 0:
                    entries.append(_single(dp_axes))
                else:
                    entries.append(None)
            return P(*entries)
    return P()  # norms, scalars, biases: replicated


def leaf_paths(params) -> Dict[str, torch.Tensor]:
    """``{path: leaf}`` of a parameter tree, paths ``/``-separated
    (``blocks/3/attn/wq``), in the tree's order."""
    return {name.replace(".", "/"): p
            for name, p in params.named_parameters()}


def layer_spec(path_str: str, shape, mesh, *, fsdp: bool,
               stack: int = 0) -> P:
    """The spec of a port leaf: :func:`param_spec` itself, or for a
    layer of a JAX stack of ``stack`` layers, the spec of the stacked
    leaf ``(stack, *shape)`` with its leading entry dropped."""
    if not stack:
        return param_spec(path_str, shape, mesh, fsdp=fsdp)
    return P(*param_spec(path_str, (stack, *shape), mesh, fsdp=fsdp)[1:])


def param_shardings(cfg: ArchConfig, params, mesh, *,
                    fsdp: bool = False) -> Dict[str, NamedSharding]:
    """``{path: NamedSharding}`` of every leaf of ``params`` (a
    ``Params`` tree on any device, ``meta`` too), in the tree's order;
    an AdamW moment tree takes the same."""
    out = {}
    for path, leaf in leaf_paths(params).items():
        top = path.split("/")[0]
        stack = len(params[top]) if top in STACKED else 0
        out[path] = NamedSharding(mesh, layer_spec(
            path, tuple(leaf.shape), mesh, fsdp=fsdp, stack=stack))
    return out


def batch_specs(cfg: ArchConfig, mesh, *, global_batch: int) -> dict:
    """Partition specs for a training batch dict."""
    dp_axes, _ = mesh_axes(mesh)
    dp = mesh.axis_size(dp_axes)
    b = _single(dp_axes) if global_batch % dp == 0 else None
    specs = {"tokens": P(b, None), "labels": P(b, None)}
    if cfg.family == "vlm":
        specs["patch_emb"] = P(b, None, None)
    if cfg.family == "audio":
        specs["frames"] = P(b, None, None)
    return specs


def _tree_map(fn, tree):
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_tree_map(fn, v) for v in tree)
    return fn(tree)


def cache_specs(cfg: ArchConfig, cache, mesh, *, batch: int):
    """Partition specs for a decode cache tree: batch on DP axes when it
    divides, heads/state channels on the model axis when they divide.
    The cache's ``length`` (a Python int) and any 0-d leaf take ``P()``.

    A heuristic, as JAX's: the batch axis is the first of the leading two
    dims equal to ``batch``, and every dim of 4096 or more counts as a
    sequence axis and stays whole."""
    dp_axes, tp_axes = mesh_axes(mesh)
    dp = mesh.axis_size(dp_axes)
    tp = mesh.axis_size(tp_axes)
    bax = _single(dp_axes) if batch % dp == 0 else None
    tax = _single(tp_axes)

    def f(leaf):
        if not isinstance(leaf, torch.Tensor) or leaf.dim() == 0:
            return P()
        shape = tuple(leaf.shape)
        entries = [None] * len(shape)
        # find the batch dim: first dim equal to batch (after optional
        # layer-stack leading dim)
        for i, d in enumerate(shape[:2]):
            if d == batch:
                entries[i] = bax
                bidx = i
                break
        else:
            bidx = -1
        # shard the first post-batch dim divisible by tp (heads/channels),
        # skipping sequence-length dims (they must stay whole for decode
        # writes) -- heuristically: dims >= 4096 are sequence dims.
        for i in range(bidx + 1, len(shape)):
            d = shape[i]
            if d >= 4096:
                continue
            if d % tp == 0 and d > 1 and entries[i] is None:
                entries[i] = tax
                break
        return P(*entries)

    return _tree_map(f, cache)


def activation_spec(mesh, *, sp: bool = False) -> P:
    """(B, S, D) activation constraint between blocks (SP shards S)."""
    dp_axes, tp_axes = mesh_axes(mesh)
    s = _single(tp_axes) if sp else None
    return P(_single(dp_axes), s, None)


def place(params, shardings: Dict[str, NamedSharding]):
    """Put each leaf of ``params`` where its sharding says.  On a mesh of
    one shard: its whole self on the shard's device (moved in place, the
    tree returned).  On a mesh of ``n`` shards: a
    :class:`~repro_torch.models.shards.Sharded` tree whose shard ``i``
    holds the block ``sharding.index(i, shape)`` of each leaf on
    ``mesh.device_of(i)`` (a replicated entry a whole copy; several
    shards on one device hold separate copies); ``params`` is left as it
    is.  ``shardings`` covers every leaf, on one mesh."""
    paths = leaf_paths(params)
    if set(shardings) != set(paths):
        raise ValueError("the shardings do not cover the tree's leaves")
    meshes = {sh.mesh for sh in shardings.values()}
    if len(meshes) != 1:
        raise ValueError(f"the shardings name {len(meshes)} meshes")
    (mesh,) = meshes
    for path, sh in shardings.items():
        sh.check(paths[path].shape)
    if mesh.size > 1:
        return Sharded.scatter(params, shardings)
    for leaf in paths.values():
        leaf.data = leaf.data.to(mesh.device_of(0))
    return params
