"""Train, prefill and serve step builders (counterpart of
``repro.train.step``): ``make_train_step`` is one AdamW step of the
loss's gradient (autograd), ``make_prefill_step`` the forward-only
prefill, ``make_serve_step`` one KV-cached decode iteration.  The last
two run without autograd.  All run on the device of the parameters
they are given.  The port runs the LM step on one card: ``mesh`` and
``sp`` are JAX's, and a mesh of one shard constrains nothing, as JAX's
constraints do nothing there; a larger mesh raises ValueError (its
specs are ``repro_torch.train.sharding``'s, and the dry-run counts its
cells on the meta device: ``repro_torch.launch.dryrun``).
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.models import decode_step, forward

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


def one_shard(mesh) -> None:
    """Raises ValueError unless ``mesh`` is None or has one shard."""
    if mesh is not None and mesh.size != 1:
        shape = dict(zip(mesh.axis_names, mesh.shape))
        raise ValueError(f"a mesh of {mesh.size} shards {shape}: the port "
                         f"runs the LM step on one card (a mesh of one "
                         f"shard)")


def make_loss_fn(cfg: ArchConfig, *, remat: bool = True,
                 sliding_window: int = 0, aux_weight: float = 0.01,
                 mesh=None, sp: bool = False):
    """``loss_fn(params, batch) -> (loss + aux_weight * aux, (loss,
    aux))``.  ``mesh``: None or one shard (:func:`one_shard`); ``sp``
    then changes nothing."""
    one_shard(mesh)

    def loss_fn(params, batch):
        logits, aux = forward(cfg, params, batch, remat=remat,
                              sliding_window=sliding_window)
        loss = cross_entropy(logits, batch["labels"])
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
    waits for the card).  ``mesh``: None or a mesh of one shard
    (:func:`one_shard`).

    grad_sync: optional fn(grads) -> grads on the list of gradients (the
    parameters' order) before the update, e.g. a compressed
    data-parallel sum.

    microbatches > 1: gradient accumulation -- the batch is split into
    equal parts along its leading axis, their gradients summed in f32
    (each ``backward`` adds into the f32 ``.grad``) and scaled by
    ``1 / microbatches``, so live activation memory scales with the
    microbatch (JAX's H9 lever for the train_4k cells); ``loss``,
    ``aux`` and ``total`` are the parts' means.
    """
    one_shard(mesh)
    if loss_fn is None:
        loss_fn = make_loss_fn(cfg, remat=remat,
                               sliding_window=sliding_window,
                               mesh=mesh, sp=sp)

    def train_step(params, opt_state, batch):
        plist = list(params.parameters())
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
