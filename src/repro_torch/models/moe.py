"""Fine-grained MoE with shared experts (DeepSeekMoE-style).

Counterpart of ``repro.models.moe``: capacity-based dispatch, top-k
routing, per-expert capacity, scatter into a capacity buffer, dense
expert products, gather-combine weighted by the router gates; dropped
tokens skip the routed path (shared experts always apply); Switch-style
auxiliary load-balance loss.

Two dispatch layouts, as in JAX:

* ``per_sequence=False`` (the training default): one global (E, C, d)
  buffer, capacity positions from a cumsum over the flattened (token, k)
  order of the whole batch;
* ``per_sequence=True`` (inference, and every decode step): each batch
  element owns an (E, C_seq, d) buffer, positions from a cumsum over its
  own (token, k) order.

The two give different results where capacity drops tokens; the order
of the cumsum (token-major, then the k picks in ``topk``'s descending
order) is JAX's, so the same tokens are dropped.

On a mesh each shard computes a block of the batch's rows, and JAX's
training dispatch treats the batch as one: :func:`across_parts` routes
every block first (no gradient) and gives each block the capacity of
the whole batch, the count of each expert's picks in the blocks before
it (its slots follow theirs) and the whole batch's density for the aux
loss.  ``moe_block(..., across=...)`` then keeps the tokens that JAX's
global cumsum keeps, in a buffer of the block's own slots.  (The
per-sequence layout needs none of this: each row is dispatched on its
own.)  The scatter adds each kept token once into an empty slot (a
dropped one adds 0), so the bf16 buffer holds the tokens exactly
whatever order the card adds in.
"""
from __future__ import annotations

import torch
from torch.nn import functional as F

from .layers import Init, Params, mm, silu


def init_moe(init: Init, d_model, d_ff_expert, n_routed, n_shared,
             top_k) -> Params:
    p = Params({
        "router": init.dense((d_model, n_routed), d_model),
        "wi": init.dense((n_routed, d_model, d_ff_expert), d_model),
        "wg": init.dense((n_routed, d_model, d_ff_expert), d_model),
        "wo": init.dense((n_routed, d_ff_expert, d_model), d_ff_expert),
    })
    if n_shared:
        d_sh = d_ff_expert * n_shared
        p["shared_wi"] = init.dense((d_model, d_sh), d_model)
        p["shared_wg"] = init.dense((d_model, d_sh), d_model)
        p["shared_wo"] = init.dense((d_sh, d_model), d_sh)
    return p


def _expert_ffn(params, buf3, out_dtype):
    """(E, C, d) capacity buffer -> expert SwiGLU -> (E, C, d) f32."""
    h = mm(buf3, params["wi"])
    g = mm(buf3, params["wg"])
    h = (silu(g) * h).to(out_dtype)
    return mm(h, params["wo"])


def _shared_path(params, xf, out_dtype):
    sh_h = mm(xf, params["shared_wi"])
    sh_g = mm(xf, params["shared_wg"])
    sh = (silu(sh_g) * sh_h).to(out_dtype)
    return mm(sh, params["shared_wo"], out=out_dtype)


def _aux_loss(experts, probs, e, density=None):
    """JAX's Switch aux; ``density`` (no gradient) the whole batch's where
    ``probs`` are a block of it."""
    if density is None:
        lead = tuple(range(experts.dim() - 1))
        density = torch.mean(F.one_hot(experts[..., 0], e).float(),
                             dim=lead)
    router_mean = torch.mean(probs, dim=tuple(range(probs.dim() - 1)))
    return e * torch.sum(density * router_mean)


def _route(params, x, top_k):
    """Router probabilities (f32 x f32, as in JAX), the top-k experts in
    descending order and their renormalised gates."""
    probs = torch.softmax(x.float() @ params["router"], dim=-1)
    gates, experts = torch.topk(probs, top_k, dim=-1)
    gates = gates / (gates.sum(-1, keepdim=True) + 1e-9)
    return probs, gates, experts


def _positions(experts, e):
    """Capacity positions of each (token, k) pick within its expert: a
    cumsum over the (..., token * k) order of the picks."""
    lead = experts.shape[:-2]
    flat = F.one_hot(experts, e).reshape(*lead, -1, e)
    pos = torch.cumsum(flat, dim=-2) * flat - 1
    return pos.amax(dim=-1).reshape(experts.shape)


@torch.no_grad()
def across_parts(routers, xs, *, top_k: int,
                 capacity_factor: float) -> list:
    """JAX's training dispatch of a batch whose row blocks ``xs`` (each
    (b_i, S, D), on its own device, with its ``routers`` weight) are
    computed apart: ``(cap, prefix, density)`` a block, for
    ``moe_block``'s ``across``.  ``cap``: the whole batch's capacity;
    ``prefix`` (E,): each expert's picks in the blocks before this one;
    ``density`` (E,): the whole batch's first-pick density.  Each block
    is routed as ``moe_block`` routes it, so its recomputation picks the
    same."""
    counts, firsts, t = [], [], 0
    for router, x in zip(routers, xs):
        e = router.shape[1]
        _, _, experts = _route({"router": router},
                               x.reshape(-1, x.shape[-1]), top_k)
        counts.append(torch.bincount(experts.reshape(-1), minlength=e))
        firsts.append(torch.bincount(experts[:, 0], minlength=e))
        t += experts.shape[0]
    cap = int((top_k * t * capacity_factor) / e) + 1
    first = sum(f.to(firsts[0].device) for f in firsts)
    out, before = [], torch.zeros_like(counts[0])
    for count in counts:
        dev = count.device
        out.append((cap, before.to(dev),
                    (first.to(dev).float() / t)))
        before = before + count.to(before.device)
    return out


def moe_block(params, x, *, top_k: int, capacity_factor: float = 1.25,
              per_sequence: bool = False, shard_axes=None, across=None):
    """x: (B, S, D). Returns (y, aux_loss).  ``shard_axes`` is accepted
    for JAX's signature and does nothing here.  ``across`` (the training
    layout): ``x`` is a block of a batch's rows and this is its ``(cap,
    prefix, density)`` from :func:`across_parts`; the aux is then this
    block's share of JAX's.  None: ``x`` is the whole batch (its own
    capacity, no picks before it, its own density)."""
    b, s, d = x.shape
    e = params["router"].shape[1]

    if per_sequence:
        return _moe_per_sequence(params, x, top_k=top_k,
                                 capacity_factor=capacity_factor)

    t = b * s
    xt = x.reshape(t, d)
    probs, gates, experts = _route(params, xt, top_k)      # (t, k)
    pos = _positions(experts, e)
    if across is None:
        across = (int((top_k * t * capacity_factor) / e) + 1,
                  torch.zeros(e, dtype=pos.dtype, device=x.device), None)
    # the slot in the whole batch's buffer follows the earlier blocks'
    # picks; the block's buffer holds its own kept slots
    cap, prefix, density = across
    keep = pos + prefix[experts] < cap
    rows = min(cap, t * top_k)

    eidx = experts.reshape(-1)
    pidx = torch.where(keep, pos, rows - 1).reshape(-1)
    wgt = keep.float().reshape(-1)

    buf = torch.zeros((e, rows, d), dtype=xt.dtype, device=x.device)
    xk = xt[:, None, :].expand(t, top_k, d).reshape(-1, d)
    buf.index_put_((eidx, pidx), xk * wgt[:, None].to(xt.dtype),
                   accumulate=True)

    out_buf = _expert_ffn(params, buf, x.dtype)
    gathered = out_buf[eidx, pidx]                         # (t*k, d)
    gathered = gathered * (gates.reshape(-1) * wgt)[:, None]
    y = gathered.reshape(t, top_k, d).sum(dim=1).to(x.dtype)

    if "shared_wi" in params:
        y = y + _shared_path(params, xt, x.dtype)
    return y.reshape(b, s, d), _aux_loss(experts, probs, e, density)


def _moe_per_sequence(params, x, *, top_k: int, capacity_factor: float):
    """Inference dispatch: batch-local capacity buffers."""
    b, s, d = x.shape
    e = params["router"].shape[1]
    cap = int((top_k * s * capacity_factor) / e) + 1

    probs, gates, experts = _route(params, x, top_k)       # (b, s, k)
    pos = _positions(experts, e)                    # per sequence
    keep = pos < cap

    eidx = experts.reshape(b, -1)
    pidx = torch.where(keep, pos, cap - 1).reshape(b, -1)
    wgt = keep.float().reshape(b, -1)
    bidx = torch.arange(b, device=x.device)[:, None].expand(eidx.shape)

    xk = x[:, :, None, :].expand(b, s, top_k, d).reshape(b, -1, d)
    buf = torch.zeros((b, e, cap, d), dtype=x.dtype, device=x.device)
    buf.index_put_((bidx, eidx, pidx), xk * wgt[..., None].to(x.dtype),
                   accumulate=True)

    buf3 = buf.permute(1, 0, 2, 3).reshape(e, b * cap, d)
    out3 = _expert_ffn(params, buf3, x.dtype)
    out_buf = out3.reshape(e, b, cap, d).permute(1, 0, 2, 3)

    gathered = out_buf[bidx, eidx, pidx]
    gathered = gathered * (gates.reshape(b, -1) * wgt)[..., None]
    y = gathered.reshape(b, s, top_k, d).sum(dim=2).to(x.dtype)

    if "shared_wi" in params:
        y = y.reshape(b * s, d) + _shared_path(params, x.reshape(b * s, d),
                                               x.dtype)
        y = y.reshape(b, s, d)
    return y, _aux_loss(experts, probs, e)
