"""Decode path: cache construction + single-token decode_step per family.

Counterpart of ``repro.models.decode``, with JAX's cache layout: stacked
arrays with a leading layer axis, plus one ``length``.  KV caches are
bf16; SSM/recurrent states are f32.  ``length`` is a Python int here
(an int32 scalar in JAX).

Sliding-window long-context decode uses a RING-BUFFER cache of
``window`` slots (slot = position % window, keys roped at write time, so
slots carry absolute positions).

JAX returns a new cache from every step; :func:`decode_step` here writes
the cache it is given in place (each layer's slice of the stacked
arrays, the recurrent states copied over) and returns that same dict
with its ``length`` advanced.
"""
from __future__ import annotations

from typing import Any, Dict

import torch

from repro_torch.api.session import resolve_device
from repro_torch.configs.base import ArchConfig

from . import layers as L
from . import ssm as S
from .model import (_apply_attn_block, _apply_moe_block, _norm_apply,
                    _sinusoid, xlstm_kinds)

Cache = Dict[str, Any]


def _kv(n_layers, b, maxlen, g, hd, device):
    return {"k": torch.zeros((n_layers, b, maxlen, g, hd),
                             dtype=torch.bfloat16, device=device),
            "v": torch.zeros((n_layers, b, maxlen, g, hd),
                             dtype=torch.bfloat16, device=device)}


def init_cache(cfg: ArchConfig, batch_size: int, max_len: int,
               enc_out=None, params=None, window: int = 0, *,
               device=None) -> Cache:
    """``window > 0``: allocate attention KV as a ring buffer of
    min(max_len, window) slots (sliding-window decode).  ``device``
    defaults to the CUDA card (raises without one), or to ``enc_out``'s
    where it is given."""
    if device is None and enc_out is not None:
        device = enc_out.device
    device = resolve_device(device)
    b = batch_size
    if window:
        max_len = min(max_len, window)

    def zeros(*shape, dtype=torch.float32):
        return torch.zeros(shape, dtype=dtype, device=device)

    cache: Cache = {"length": 0}
    if cfg.family in ("dense", "vlm"):
        cache["kv"] = _kv(cfg.n_layers, b, max_len, cfg.n_kv_heads,
                          cfg.head_dim, device)
    elif cfg.family == "moe":
        if cfg.mla:
            def mla_c(n):
                return {"ckv": zeros(n, b, max_len, cfg.kv_lora,
                                     dtype=torch.bfloat16),
                        "kr": zeros(n, b, max_len, cfg.qk_rope,
                                    dtype=torch.bfloat16)}
            cache["dense_kv"] = mla_c(cfg.first_dense)
            cache["moe_kv"] = mla_c(cfg.n_layers - cfg.first_dense)
        else:
            cache["dense_kv"] = _kv(cfg.first_dense, b, max_len,
                                    cfg.n_kv_heads, cfg.head_dim, device)
            cache["moe_kv"] = _kv(cfg.n_layers - cfg.first_dense, b,
                                  max_len, cfg.n_kv_heads, cfg.head_dim,
                                  device)
    elif cfg.family == "hybrid":
        d_inner = cfg.mamba_expand * cfg.d_model
        nh = d_inner // cfg.mamba_head_dim
        cache["ssm"] = {
            "state": zeros(cfg.n_layers, b, nh, cfg.ssm_state,
                           cfg.mamba_head_dim),
            "conv_tail": zeros(cfg.n_layers, b, 3,
                               d_inner + 2 * cfg.ssm_state,
                               dtype=torch.bfloat16)}
        cache["kv"] = _kv(cfg.n_layers, b, max_len, cfg.n_kv_heads,
                          cfg.head_dim, device)
    elif cfg.family == "ssm":
        blocks = []
        for kind in xlstm_kinds(cfg):
            if kind == "slstm":
                blocks.append({"h": zeros(b, cfg.d_model),
                               "c": zeros(b, cfg.d_model),
                               "n": torch.ones((b, cfg.d_model),
                                               dtype=torch.float32,
                                               device=device)})
            else:
                blocks.append({"state": zeros(b, cfg.n_heads, cfg.head_dim,
                                              cfg.head_dim)})
        cache["blocks"] = blocks
    elif cfg.family == "audio":
        cache["kv"] = _kv(cfg.n_layers, b, max_len, cfg.n_kv_heads,
                          cfg.head_dim, device)
        # cross-attention k/v precomputed from the encoder output
        if enc_out is not None and params is not None:
            ks, vs = [], []
            for p in params["dec_blocks"]:
                k = L.project_heads(enc_out, p["xattn"]["wk"],
                                    out=torch.float32)
                v = L.project_heads(enc_out, p["xattn"]["wv"],
                                    out=torch.float32)
                if "bk" in p["xattn"]:
                    k = k + p["xattn"]["bk"]
                    v = v + p["xattn"]["bv"]
                ks.append(k.to(torch.bfloat16))
                vs.append(v.to(torch.bfloat16))
            cache["cross"] = {"k": torch.stack(ks), "v": torch.stack(vs)}
        else:
            cache["cross"] = _kv(cfg.n_layers, b, cfg.enc_seq,
                                 cfg.n_kv_heads, cfg.head_dim, device)
    return cache


@torch.no_grad()
def decode_step(cfg: ArchConfig, params, cache: Cache, tokens,
                *, sliding_window: int = 0, scan_unroll: int = 1):
    """tokens: (B, 1) int -> (logits (B,1,V) f32, cache).

    The returned cache is ``cache`` itself, written in place with its
    ``length`` advanced by one.  ``scan_unroll`` is JAX's layer-scan
    unroll and changes nothing here.
    """
    na = _norm_apply(cfg)
    # ring mode is a static property of the cache allocation
    ring = bool(sliding_window) and "kv" in cache \
        and cache["kv"]["k"].shape[2] <= sliding_window
    x = L.embed(params["embed"], tokens)
    length = int(cache["length"])
    positions = torch.arange(length, length + 1, device=x.device)

    def layer(stack, i):
        if "ckv" in stack:
            return {"attn": {"ckv": stack["ckv"][i], "kr": stack["kr"][i],
                             "length": length}}
        return {"attn": {"k": stack["k"][i], "v": stack["v"][i],
                         "length": length}}

    if cfg.family in ("dense", "vlm"):
        for i, p in enumerate(params["blocks"]):
            x, _ = _apply_attn_block(cfg, p, x, positions,
                                     cache=layer(cache["kv"], i),
                                     sliding_window=sliding_window,
                                     ring=ring)

    elif cfg.family == "moe":
        for i, p in enumerate(params["dense_blocks"]):
            x, _ = _apply_attn_block(cfg, p, x, positions,
                                     cache=layer(cache["dense_kv"], i))
        for i, p in enumerate(params["moe_blocks"]):
            x, _, _ = _apply_moe_block(cfg, p, x, positions,
                                       cache=layer(cache["moe_kv"], i))

    elif cfg.family == "hybrid":
        shared = params["shared_attn"]
        every = cfg.attn_every
        ssm = cache["ssm"]
        for idx, p in enumerate(params["blocks"]):
            h2, nc = S.mamba2_block(
                p["mamba"], na(p["norm1"], x), d_state=cfg.ssm_state,
                expand=cfg.mamba_expand, head_dim=cfg.mamba_head_dim,
                cache={"state": ssm["state"][idx],
                       "conv_tail": ssm["conv_tail"][idx]})
            ssm["state"][idx].copy_(nc["state"])
            ssm["conv_tail"][idx].copy_(nc["conv_tail"])
            x = x + h2
            if idx % every == every - 1:
                x, _ = _apply_attn_block(cfg, shared, x, positions,
                                         cache=layer(cache["kv"], idx),
                                         sliding_window=sliding_window,
                                         ring=ring)

    elif cfg.family == "ssm":
        for p, kind, bc in zip(params["blocks_list"], xlstm_kinds(cfg),
                               cache["blocks"]):
            h = na(p["norm1"], x)
            if kind == "slstm":
                y, nc = S.slstm_block(p["cell"], h, cache=bc)
            else:
                y, nc = S.mlstm_block(p["cell"], h, n_heads=cfg.n_heads,
                                      head_dim=cfg.head_dim, cache=bc)
            x = x + y
            for key, value in nc.items():
                bc[key].copy_(value)

    elif cfg.family == "audio":
        x = x + _sinusoid(positions, cfg.d_model).to(x.dtype)
        for i, p in enumerate(params["dec_blocks"]):
            x, _ = _apply_attn_block(
                cfg, p, x, positions, cache=layer(cache["kv"], i),
                enc_kv={"k": cache["cross"]["k"][i],
                        "v": cache["cross"]["v"][i]})

    cache["length"] = length + 1
    x = na(params["final_norm"], x)
    return L.unembed(params["embed"], x), cache
