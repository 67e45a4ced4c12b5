"""Model assembly: ArchConfig -> init / forward.

Counterpart of ``repro.models.model``.  Families: dense, moe (GQA or MLA),
hybrid (Mamba2 + one shared attention block), ssm (xLSTM), vlm (a stub
patch-embedding prefix + dense backbone), audio (whisper-style
encoder-decoder with a stub conv frontend).

JAX stacks each family's layers and runs ``lax.scan`` over them; here a
stack is an ``nn.ModuleList`` (one :class:`Params` a layer) and a loop.
The hybrid family's shared block is one ``Params`` that the loop runs
after every ``attn_every``-th Mamba2 block, chosen by the layer's index.
"""
from __future__ import annotations

import functools
from typing import Dict

import torch
from torch import nn
from torch.utils import checkpoint as _checkpoint

from repro_torch.api.session import resolve_device
from repro_torch.configs.base import ArchConfig

from . import layers as L
from . import moe as M
from . import ssm as S
from .layers import Init, Params
from .shards import Reader, Sharded, split_rows, weigh


def _norm_init(cfg):
    return (L.init_rmsnorm if cfg.norm == "rms" else L.init_layernorm)


def _norm_apply(cfg):
    return (L.rms_norm if cfg.norm == "rms" else L.layer_norm)


# ---------------------------------------------------------------------------
# per-kind block init
# ---------------------------------------------------------------------------

def _init_attn(cfg: ArchConfig, init: Init) -> Params:
    if cfg.mla:
        return L.init_mla(init, cfg.d_model, cfg.n_heads, cfg.kv_lora,
                          cfg.qk_nope, cfg.qk_rope, cfg.head_dim)
    return L.init_gqa(init, cfg.d_model, cfg.n_heads, cfg.n_kv_heads,
                      cfg.head_dim, cfg.attn_bias)


def _init_attn_block(cfg: ArchConfig, init: Init,
                     cross: bool = False) -> Params:
    p = Params({"norm1": _norm_init(cfg)(init, cfg.d_model),
                "norm2": _norm_init(cfg)(init, cfg.d_model),
                "attn": _init_attn(cfg, init)})
    if cross:
        p["norm_x"] = _norm_init(cfg)(init, cfg.d_model)
        p["xattn"] = L.init_gqa(init, cfg.d_model, cfg.n_heads,
                                cfg.n_kv_heads, cfg.head_dim, cfg.attn_bias)
    if cfg.d_ff:
        p["mlp"] = L.init_mlp(init, cfg.d_model, cfg.d_ff, cfg.gated_mlp)
    return p


def _init_moe_block(cfg: ArchConfig, init: Init) -> Params:
    return Params({"norm1": _norm_init(cfg)(init, cfg.d_model),
                   "norm2": _norm_init(cfg)(init, cfg.d_model),
                   "attn": _init_attn(cfg, init),
                   "moe": M.init_moe(init, cfg.d_model, cfg.d_ff_expert,
                                     cfg.n_routed, cfg.n_shared, cfg.top_k)})


def _init_mamba_block(cfg: ArchConfig, init: Init) -> Params:
    return Params({"norm1": _norm_init(cfg)(init, cfg.d_model),
                   "mamba": S.init_mamba2(init, cfg.d_model, cfg.ssm_state,
                                          cfg.mamba_expand,
                                          cfg.mamba_head_dim)})


# ---------------------------------------------------------------------------
# per-kind block apply (cache=None for train/prefill)
# ---------------------------------------------------------------------------

def _apply_attn_block(cfg, p, x, positions, cache=None, *, causal=True,
                      sliding_window=0, enc_kv=None, ring=False):
    na = _norm_apply(cfg)
    h = na(p["norm1"], x)
    if cfg.mla:
        y, new_attn = L.mla_attention(p["attn"], h, positions=positions,
                                      qk_nope=cfg.qk_nope,
                                      qk_rope=cfg.qk_rope,
                                      rope_theta=cfg.rope_theta,
                                      cache=None if cache is None
                                      else cache["attn"])
    else:
        y, new_attn = L.gqa_attention(
            p["attn"], h, positions=positions, causal=causal,
            rotary_frac=cfg.rotary_frac if cfg.use_rope else 0.0,
            rope_theta=cfg.rope_theta, sliding_window=sliding_window,
            cache=None if cache is None else cache["attn"], ring=ring)
    x = x + y
    new_cache = None if cache is None else {"attn": new_attn}
    if enc_kv is not None:
        h = na(p["norm_x"], x)
        # cross attention against precomputed encoder k/v
        q = L.project_heads(h, p["xattn"]["wq"])
        if "bq" in p["xattn"]:
            q = q + p["xattn"]["bq"].to(q.dtype)
        y = L.sdpa(q, enc_kv["k"], enc_kv["v"], causal=False)
        x = x + L.merge_heads(y, p["xattn"]["wo"], x.dtype)
    if cfg.d_ff and "mlp" in p:
        x = x + L.mlp(p["mlp"], na(p["norm2"], x), act=L.ACTS[cfg.act])
    return x, new_cache


def _apply_moe_block(cfg, p, x, positions, cache=None, dropless=False,
                     per_sequence=False, shard_axes=None):
    x, new_attn = _moe_attn(cfg, p, x, positions, cache)
    x, aux = _moe_ffn(cfg, p, x, cache=cache, dropless=dropless,
                      per_sequence=per_sequence, shard_axes=shard_axes)
    new_cache = None if cache is None else {"attn": new_attn}
    return x, aux, new_cache


def _moe_attn(cfg, p, x, positions, cache=None):
    """An MoE block's attention half: ``(x + attention, its cache)``."""
    h = _norm_apply(cfg)(p["norm1"], x)
    if cfg.mla:
        y, new_attn = L.mla_attention(p["attn"], h, positions=positions,
                                      qk_nope=cfg.qk_nope,
                                      qk_rope=cfg.qk_rope,
                                      rope_theta=cfg.rope_theta,
                                      cache=None if cache is None
                                      else cache["attn"])
    else:
        y, new_attn = L.gqa_attention(p["attn"], h, positions=positions,
                                      causal=True,
                                      rotary_frac=cfg.rotary_frac,
                                      rope_theta=cfg.rope_theta,
                                      cache=None if cache is None
                                      else cache["attn"])
    return x + y, new_attn


def _moe_capacity_factor(cfg, cache=None, dropless=False) -> float:
    # decode uses dropless capacity (cap >= T * top_k): per-step batches
    # are tiny and token drops would make decode diverge from prefill
    return float(cfg.n_routed) if (cache is not None or dropless) else 1.25


def _moe_ffn(cfg, p, x, *, cache=None, dropless=False, per_sequence=False,
             shard_axes=None, across=None):
    """An MoE block's expert half: ``(x + experts, aux)``; ``across`` as
    :func:`repro_torch.models.moe.moe_block`'s."""
    y, aux = M.moe_block(p["moe"], _norm_apply(cfg)(p["norm2"], x),
                         top_k=cfg.top_k,
                         capacity_factor=_moe_capacity_factor(cfg, cache,
                                                              dropless),
                         per_sequence=per_sequence or cache is not None,
                         shard_axes=shard_axes, across=across)
    return x + y, aux


# ---------------------------------------------------------------------------
# model init
# ---------------------------------------------------------------------------

def xlstm_kinds(cfg: ArchConfig):
    """Static block-kind pattern for the ssm family (not stored in params)."""
    return ["slstm" if cfg.slstm_every and
            (i % cfg.slstm_every == cfg.slstm_every - 1) else "mlstm"
            for i in range(cfg.n_layers)]


def init_model(cfg: ArchConfig, key=0, *, device=None) -> Params:
    """The parameter tree of ``cfg`` with JAX's layout and distributions,
    drawn from ``key``: a ``torch.Generator`` on ``device`` or a seed for
    one.  ``device`` defaults to the CUDA card (raises without one);
    ``"meta"`` makes shapes only.  Not JAX's values for the same seed:
    carry those with :func:`repro_torch.models.convert.params_from_jax`.
    """
    device = resolve_device(device)
    if device.type == "meta":
        generator = None
    elif isinstance(key, torch.Generator):
        generator = key
    else:
        generator = torch.Generator(device=device).manual_seed(int(key))
    init = Init(generator, device)
    params = Params({"embed": L.init_embed(init, cfg.vocab, cfg.d_model),
                     "final_norm": _norm_init(cfg)(init, cfg.d_model)})

    def stack(init_fn, n):
        return nn.ModuleList([init_fn() for _ in range(n)])

    if cfg.family in ("dense", "vlm"):
        params["blocks"] = stack(lambda: _init_attn_block(cfg, init),
                                 cfg.n_layers)
    elif cfg.family == "moe":
        params["dense_blocks"] = stack(lambda: _init_attn_block(cfg, init),
                                       cfg.first_dense)
        params["moe_blocks"] = stack(lambda: _init_moe_block(cfg, init),
                                     cfg.n_layers - cfg.first_dense)
    elif cfg.family == "hybrid":
        params["blocks"] = stack(lambda: _init_mamba_block(cfg, init),
                                 cfg.n_layers)
        params["shared_attn"] = _init_attn_block(cfg, init)
    elif cfg.family == "ssm":
        blocks = []
        for kind in xlstm_kinds(cfg):
            cell = (S.init_slstm(init, cfg.d_model, cfg.n_heads)
                    if kind == "slstm" else
                    S.init_mlstm(init, cfg.d_model, cfg.n_heads,
                                 cfg.head_dim))
            blocks.append(Params({"norm1": _norm_init(cfg)(init,
                                                           cfg.d_model),
                                  "cell": cell}))
        params["blocks_list"] = nn.ModuleList(blocks)
    elif cfg.family == "audio":
        params["enc_blocks"] = stack(lambda: _init_attn_block(cfg, init),
                                     cfg.enc_layers)
        params["dec_blocks"] = stack(
            lambda: _init_attn_block(cfg, init, cross=True), cfg.n_layers)
        params["enc_norm"] = _norm_init(cfg)(init, cfg.d_model)
    else:
        raise ValueError(cfg.family)
    return params


def param_count(params: nn.Module) -> int:
    """The number of parameters of a tree (on any device, meta too)."""
    return sum(p.numel() for p in params.parameters())


# ---------------------------------------------------------------------------
# sinusoidal positions (whisper)
# ---------------------------------------------------------------------------

def _sinusoid(positions, d_model):
    half = d_model // 2
    step = torch.log(torch.tensor(10000.0, device=positions.device)) \
        / (half - 1)
    freqs = torch.exp(-torch.arange(half, dtype=torch.float32,
                                    device=positions.device) * step)
    ang = positions[:, None].float() * freqs[None, :]
    return torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1)


# ---------------------------------------------------------------------------
# forward (train / prefill): batch -> logits, aux
# ---------------------------------------------------------------------------

def _checkpointed(remat: bool):
    """JAX's ``ck``: with ``remat`` and autograd on, ``f(*args)`` keeps
    none of its activations and recomputes them in the backward pass
    (``torch.utils.checkpoint``, non-reentrant); else ``f`` itself."""
    if not (remat and torch.is_grad_enabled()):
        return lambda f, *args: f(*args)
    return lambda f, *args: _checkpoint.checkpoint(f, *args,
                                                   use_reentrant=False)


class _Whole:
    """:func:`forward_parts`'s view of a tree on one device: its own
    nodes (:class:`~repro_torch.models.shards.Sharded` is the other)."""

    def __init__(self, params: Params):
        self.params = params

    def count(self, key: str) -> int:
        return len(self.params[key])

    def take(self, j: int, *keys):
        node = self.params
        for k in keys:
            node = node[k]
        return node


def forward(cfg: ArchConfig, params: Params, batch: Dict[str, torch.Tensor],
            *, remat: bool = True, sliding_window: int = 0,
            act_sharding=None, dropless_moe: bool = False,
            remat_policy: str = "none", scan_unroll: int = 1):
    """batch -> (logits (B, S, V) f32, aux f32 scalar), on the device of
    ``params`` and ``batch``.

    ``remat`` is JAX's rematerialization: in training (autograd on) each
    layer's body -- the bodies JAX's ``ck`` wraps, and the xLSTM cells
    too -- keeps no activations and is recomputed in the backward pass.
    Under ``torch.no_grad`` it changes nothing.  ``remat_policy="dots"``
    (JAX saves the products' outputs) is the same as ``"none"`` here:
    nothing is saved.  ``remat`` also sets what JAX's forward takes from
    it: the MoE dispatch layout, the global buffer when ``remat``
    (training) and the per-sequence one for inference (``remat=False``),
    which drop different tokens at capacity.  ``act_sharding`` and
    ``scan_unroll`` are JAX's sharding and compile knobs and change
    nothing on one device.  A tree on a mesh
    (:class:`~repro_torch.models.shards.Sharded`) computes each shard's
    rows (:func:`forward_parts`); the logits are gathered on shard 0's
    device and the parts' aux weighted by their rows (JAX's aux in the
    training layout; inference discards it).
    """
    parts = split_rows(params, batch)
    outs = forward_parts(cfg, params, parts, remat=remat,
                         sliding_window=sliding_window,
                         dropless_moe=dropless_moe)
    if len(outs) == 1 and parts[0][1] is batch:
        return outs[0]
    device = params.mesh.device_of(0)
    logits = torch.cat([lg.to(device) for lg, _ in outs])
    return logits, weigh(parts, [a for _, a in outs], len(batch["tokens"]),
                         device)


def forward_parts(cfg: ArchConfig, params, parts, *, remat: bool = True,
                  sliding_window: int = 0, dropless_moe: bool = False):
    """:func:`forward` of the blocks of rows that the shards of a mesh
    compute: ``parts`` is ``(shard, batch)`` pairs, each batch on its
    shard's device; ``params`` a ``Params`` tree (shard 0 alone) or a
    :class:`~repro_torch.models.shards.Sharded` one, whose layers each
    shard gathers whole inside the layer's checkpointed body (so remat's
    recomputation gathers again).  Returns ``(logits, aux)`` a part.

    Layer by layer, every part's layer ``l`` before any part's ``l + 1``.
    With more than one part, an MoE layer in the training layout first
    routes every part under no gradient and gives each JAX's dispatch of
    the whole batch (:func:`repro_torch.models.moe.across_parts`): the
    global capacity, the slots after the earlier parts' tokens, the
    global density of the aux loss; a part's aux is its share, so the
    parts' aux weighted by their tokens is JAX's.  The per-sequence
    (inference) layout dispatches each row on its own, so the parts
    drop the whole batch's tokens; each part's aux is then its own."""
    src = Reader(params) if isinstance(params, Sharded) else _Whole(params)
    if cfg.family == "audio":
        return _forward_audio(cfg, src, parts, remat=remat)
    na = _norm_apply(cfg)
    ck = _checkpointed(remat)

    xs, pos = [], []
    for j, batch in parts:
        x = L.embed(src.take(j, "embed"), batch["tokens"])
        if cfg.family == "vlm":
            x = torch.cat([batch["patch_emb"].to(x.dtype), x], dim=1)
        xs.append(x)
        pos.append(torch.arange(x.shape[1], device=x.device))
    aux = [torch.zeros((), dtype=torch.float32, device=x.device)
           for x in xs]

    def each(body, *extra):
        """``xs[i] = body(shard, positions, xs[i], *extra)`` a part,
        checkpointed."""
        for i, (j, _) in enumerate(parts):
            xs[i] = ck(functools.partial(body, j, pos[i]), xs[i], *extra)

    if cfg.family in ("dense", "vlm"):
        for l in range(src.count("blocks")):
            each(lambda j, positions, h, l=l: _apply_attn_block(
                cfg, src.take(j, "blocks", l), h, positions,
                sliding_window=sliding_window)[0])

    elif cfg.family == "moe":
        for l in range(src.count("dense_blocks")):
            each(lambda j, positions, h, l=l: _apply_attn_block(
                cfg, src.take(j, "dense_blocks", l), h, positions)[0])
        # inference (remat=False) uses the batch-local dispatch layout;
        # training keeps the global buffer
        per_sequence = not remat

        def half(j, l, *keys):
            return {k: src.take(j, "moe_blocks", l, k) for k in keys}
        for l in range(src.count("moe_blocks")):
            each(lambda j, positions, h, l=l: _moe_attn(
                cfg, half(j, l, "norm1", "attn"), h, positions)[0])
            across = [None] * len(parts)
            if len(parts) > 1 and not per_sequence:
                with torch.no_grad():
                    across = M.across_parts(
                        [src.take(j, "moe_blocks", l, "moe", "router")
                         for j, _ in parts],
                        [na(src.take(j, "moe_blocks", l, "norm2"), x)
                         for (j, _), x in zip(parts, xs)],
                        top_k=cfg.top_k,
                        capacity_factor=_moe_capacity_factor(
                            cfg, dropless=dropless_moe))

            def ffn_body(j, ac, h, l=l):
                return _moe_ffn(cfg, half(j, l, "norm2", "moe"), h,
                                dropless=dropless_moe,
                                per_sequence=per_sequence, across=ac)
            for i, (j, _) in enumerate(parts):
                xs[i], aux_l = ck(functools.partial(ffn_body, j, across[i]),
                                  xs[i])
                aux[i] = aux[i] + aux_l

    elif cfg.family == "hybrid":
        every = cfg.attn_every

        def mamba_body(j, positions, h, l):
            p = src.take(j, "blocks", l)
            h2, _ = S.mamba2_block(p["mamba"], na(p["norm1"], h),
                                   d_state=cfg.ssm_state,
                                   expand=cfg.mamba_expand,
                                   head_dim=cfg.mamba_head_dim)
            h = h + h2
            if l % every == every - 1:
                h, _ = _apply_attn_block(cfg, src.take(j, "shared_attn"), h,
                                         positions,
                                         sliding_window=sliding_window)
            return h
        for l in range(src.count("blocks")):
            each(lambda j, positions, h, l=l: mamba_body(j, positions, h, l))

    elif cfg.family == "ssm":
        def cell_body(j, positions, h, l, kind):
            p = src.take(j, "blocks_list", l)
            hn = na(p["norm1"], h)
            if kind == "slstm":
                y, _ = S.slstm_block(p["cell"], hn)
            else:
                y, _ = S.mlstm_block(p["cell"], hn, n_heads=cfg.n_heads,
                                     head_dim=cfg.head_dim)
            return h + y
        for l, kind in enumerate(xlstm_kinds(cfg)):
            each(lambda j, positions, h, l=l, kind=kind: cell_body(
                j, positions, h, l, kind))

    out = []
    for (j, _), x, a in zip(parts, xs, aux):
        x = na(src.take(j, "final_norm"), x)
        out.append((L.unembed(src.take(j, "embed"), x), a))
    return out


def encode_audio(cfg, params, frames, *, remat: bool = False):
    """Encoder-only forward (serving: run once, then cached decode);
    ``remat`` as :func:`forward`'s."""
    return _encode(cfg, _Whole(params), 0, frames, remat=remat)


def _encode(cfg, src, j, frames, *, remat: bool):
    na = _norm_apply(cfg)
    ck = _checkpointed(remat)
    enc = frames.to(torch.bfloat16)
    enc_pos = torch.arange(enc.shape[1], device=enc.device)
    enc = enc + _sinusoid(enc_pos, cfg.d_model).to(enc.dtype)

    def enc_body(l, h):
        return _apply_attn_block(cfg, src.take(j, "enc_blocks", l), h,
                                 enc_pos, causal=False)[0]
    for l in range(src.count("enc_blocks")):
        enc = ck(functools.partial(enc_body, l), enc)
    return na(src.take(j, "enc_norm"), enc)


def _forward_audio(cfg, src, parts, *, remat=True):
    """Whisper-style: frames (stub frontend output) -> encoder; tokens ->
    causal decoder with cross attention.  Each part's encoder, then each
    part's decoder, layer by layer."""
    na = _norm_apply(cfg)
    ck = _checkpointed(remat)
    encs = [_encode(cfg, src, j, batch["frames"], remat=remat)
            for j, batch in parts]

    xs, pos = [], []
    for j, batch in parts:
        x = L.embed(src.take(j, "embed"), batch["tokens"])
        positions = torch.arange(x.shape[1], device=x.device)
        xs.append(x + _sinusoid(positions, cfg.d_model).to(x.dtype))
        pos.append(positions)

    def dec_body(j, positions, l, h, enc):
        p = src.take(j, "dec_blocks", l)
        # per-layer cross k/v from the shared encoder output
        k = L.project_heads(enc, p["xattn"]["wk"])
        v = L.project_heads(enc, p["xattn"]["wv"])
        if "bk" in p["xattn"]:
            k = k + p["xattn"]["bk"].to(k.dtype)
            v = v + p["xattn"]["bv"].to(v.dtype)
        return _apply_attn_block(cfg, p, h, positions,
                                 enc_kv={"k": k, "v": v})[0]
    for l in range(src.count("dec_blocks")):
        for i, (j, _) in enumerate(parts):
            xs[i] = ck(functools.partial(dec_body, j, pos[i], l), xs[i],
                       encs[i])

    out = []
    for (j, _), x in zip(parts, xs):
        x = na(src.take(j, "final_norm"), x)
        out.append((L.unembed(src.take(j, "embed"), x), torch.zeros(
            (), dtype=torch.float32, device=x.device)))
    return out
