"""Train, prefill and serve step builders (counterpart of
``repro.train.step``): ``make_train_step`` is one AdamW step of the
loss's gradient (autograd), ``make_prefill_step`` the forward-only
prefill, ``make_serve_step`` one KV-cached decode iteration.  The last
two run without autograd.  All run on the device of the parameters
they are given.

The train step runs on a mesh of any shape, as JAX's ``pjit`` step runs
on whatever devices exist: ``repro_torch.train.sharding.place`` lays
the parameters out by JAX's specs (each shard holds its
``NamedSharding.index`` piece of each leaf), and the step cuts each
microbatch's rows into contiguous blocks, one a shard in the mesh's
row-major order (``torch.tensor_split``: uneven blocks allowed, an
empty one computes nothing).  Layer by layer, each shard gathers the
layer's weights whole on its device and computes its rows; the
gather's backward cuts the cotangent into the pieces' blocks, and each
piece takes the sum of its cuts over the shards in shard order, so a
step on several cards is bit for bit repeatable
(:mod:`repro_torch.models.shards`).  Each shard's loss is
weighted by its rows over all rows, so the sum is the batch's mean.
GSPMD splits the products over ``model``; here ``model`` splits rows
too: another schedule of the same arithmetic.  ``mesh`` and ``sp``
change no value, as JAX's constraints change none; a step built for a
mesh of several shards refuses parameters that are not placed on it.
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.models import decode_step, forward
from repro_torch.models.model import forward_parts
from repro_torch.models.shards import Sharded, split_rows, weigh

from . import optim


def cross_entropy(logits, labels):
    """Stable CE in f32; logits (B, S, V), labels (B, S) int32.

    JAX's form: the max detached, the gold logit taken with an iota
    mask (JAX's choice for a vocab-sharded axis; on one device it
    selects the same f32 value a gather would, and its backward is
    element-wise, with no scatter of atomic adds)."""
    logits = logits.to(torch.float32)
    m = logits.amax(dim=-1, keepdim=True).detach()
    shifted = logits - m
    lse = torch.log(torch.sum(torch.exp(shifted), dim=-1))
    vocab = torch.arange(logits.shape[-1], dtype=torch.int32,
                         device=logits.device)
    gold_mask = vocab == labels[..., None]
    gold = torch.sum(torch.where(gold_mask, shifted, 0.0), dim=-1)
    return (lse - gold).mean()


def _check_layout(mesh, params) -> None:
    """Raises ValueError unless ``params`` lie on ``mesh`` (None: any
    layout): a tree on one device for a mesh of one shard, else a
    :class:`Sharded` tree of that mesh."""
    if mesh is None:
        return
    got = params.mesh if isinstance(params, Sharded) else None
    if mesh.size > 1 and got != mesh:
        raise ValueError(f"a step for a mesh of {mesh.size} shards "
                         f"{dict(zip(mesh.axis_names, mesh.shape))} takes "
                         f"parameters placed on it "
                         f"(repro_torch.train.sharding.place)")
    if mesh.size == 1 and got is not None:
        raise ValueError("parameters placed on another mesh")


def make_loss_fn(cfg: ArchConfig, *, remat: bool = True,
                 sliding_window: int = 0, aux_weight: float = 0.01,
                 mesh=None, sp: bool = False):
    """``loss_fn(params, batch) -> (loss + aux_weight * aux, (loss,
    aux))``, on the device of shard 0.  ``params``: a tree on one device
    or placed on a mesh (the module's docstring); each shard's loss and
    aux weighted by its rows.  ``mesh`` checks the layout
    (:func:`_check_layout`); ``sp`` changes nothing."""

    def loss_fn(params, batch):
        _check_layout(mesh, params)
        parts = split_rows(params, batch)
        outs = forward_parts(cfg, params, parts, remat=remat,
                             sliding_window=sliding_window)
        if not isinstance(params, Sharded):
            ((logits, aux),) = outs
            loss = cross_entropy(logits, batch["labels"])
            return loss + aux_weight * aux, (loss, aux)
        device, rows = params.mesh.device_of(0), len(batch["labels"])
        loss = weigh(parts, [cross_entropy(logits, part["labels"])
                             for (_, part), (logits, _) in zip(parts, outs)],
                     rows, device)
        aux = weigh(parts, [a for _, a in outs], rows, device)
        return loss + aux_weight * aux, (loss, aux)
    return loss_fn


def make_train_step(cfg: ArchConfig, opt_cfg: optim.OptConfig, *,
                    remat: bool = True, sliding_window: int = 0,
                    mesh=None, sp: bool = False, grad_sync=None,
                    microbatches: int = 1, loss_fn=None):
    """``train_step(params, opt_state, batch) -> (params, opt_state,
    metrics)``.  It turns on gradients for ``params``, updates
    ``params`` and ``opt_state`` in place and returns the same objects;
    ``metrics`` holds ``loss``, ``aux``, ``total``, ``grad_norm`` and
    ``lr`` as 0-d tensors on the device (read them when needed: no step
    waits for the card).  ``params`` lie on one device or on a mesh
    (``repro_torch.train.sharding.place``, with ``opt_state`` from
    ``opt_init`` of them); ``mesh`` checks that layout.

    grad_sync: optional fn(grads) -> grads on the list of gradients
    (``optim.leaves(params)``'s order) before the update, e.g. a
    compressed data-parallel sum.  On a mesh that list holds every
    shard's pieces, shard by shard, each already the whole batch's
    gradient of its block (the reduce-scatter done), as JAX's pjit path
    hands ``grad_sync`` the reduced gradient.

    microbatches > 1: gradient accumulation -- the batch is split into
    equal parts along its leading axis (each then cut over the shards),
    their gradients summed in f32 (each ``backward`` adds into the f32
    ``.grad``) and scaled by ``1 / microbatches``, so live activation
    memory scales with the microbatch (JAX's H9 lever for the train_4k
    cells); ``loss``, ``aux`` and ``total`` are the parts' means.
    """
    if loss_fn is None:
        loss_fn = make_loss_fn(cfg, remat=remat,
                               sliding_window=sliding_window,
                               mesh=mesh, sp=sp)

    def train_step(params, opt_state, batch):
        _check_layout(mesh, params)
        plist = optim.leaves(params)
        for p in plist:
            p.requires_grad_(True)
            p.grad = None
        parts = [batch]
        if microbatches > 1:
            parts = [{k: v.reshape(microbatches, v.shape[0] // microbatches,
                                   *v.shape[1:])[i]
                      for k, v in batch.items()}
                     for i in range(microbatches)]
        tot = loss = aux = 0.0
        with torch.enable_grad():
            for part in parts:
                t, (l, a) = loss_fn(params, part)
                t.backward()
                tot, loss, aux = (tot + t.detach(), loss + l.detach(),
                                  aux + a.detach())
        grads = [p.grad if p.grad is not None else torch.zeros_like(p)
                 for p in plist]
        if microbatches > 1:
            inv = 1.0 / microbatches
            torch._foreach_mul_(grads, inv)
            tot, loss, aux = tot * inv, loss * inv, aux * inv
        if grad_sync is not None:
            grads = grad_sync(grads)
        params, opt_state, om = optim.update(opt_cfg, grads, params,
                                             opt_state)
        for p in plist:
            p.grad = None
        metrics = {"loss": loss, "aux": aux, "total": tot, **om}
        return params, opt_state, metrics

    return train_step


def make_prefill_step(cfg: ArchConfig, *, sliding_window: int = 0):
    """Forward-only prefill (the prefill_32k shape): batch -> logits."""
    def prefill(params, batch):
        with torch.no_grad():
            logits, _ = forward(cfg, params, batch, remat=False,
                                sliding_window=sliding_window)
        return logits
    return prefill


def make_serve_step(cfg: ArchConfig, *, sliding_window: int = 0,
                    temperature: float = 0.0):
    """One decode iteration: (params, cache, tokens (B,1)) ->
    (next_tokens (B,1), cache), the cache written in place
    (:func:`repro_torch.models.decode.decode_step`).

    Greedy at ``temperature`` 0 (the first of equal logits, as JAX's
    argmax).  Above it, a draw from softmax(logits / temperature) by a
    torch generator seeded with the cache's length before the step: the
    same skip-ahead keying as JAX's ``fold_in(PRNGKey(0), length)``, not
    its stream.
    """
    def serve_step(params, cache, tokens):
        length = int(cache["length"])
        logits, new_cache = decode_step(cfg, params, cache, tokens,
                                        sliding_window=sliding_window)
        last = logits[:, -1]
        if temperature > 0.0:
            gen = torch.Generator(device=last.device).manual_seed(length)
            probs = torch.softmax(last / temperature, dim=-1)
            nxt = torch.multinomial(probs, 1, generator=gen)
        else:
            nxt = torch.argmax(last, dim=-1)[:, None]
        return nxt.to(tokens.dtype), new_cache
    return serve_step
