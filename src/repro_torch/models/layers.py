"""Core transformer layers: norms, RoPE, GQA / MLA attention, gated MLP.

Counterpart of ``repro.models.layers``.  The parameter tree is the JAX
package's, held as :class:`Params` modules read by key (``p["wq"]``,
``"bq" in p``), so every function here reads as its JAX counterpart does;
``init_*`` draw the JAX package's distributions from a torch generator
(:class:`Init`), not its streams.

The dtype contract is JAX's.  Params are stored f32 and cast to bf16 on
use; activations are bf16.  Every product takes bf16 operands and sums
in f32 (:func:`mm`): on the card ``torch.mm``/``torch.bmm`` with
``out_dtype=torch.float32`` (bf16 on the tensor cores, f32 sums), on the
CPU the bf16-rounded operands as f32 (their products exact) in an f32
product; both have JAX's gradient (:class:`CardProduct` on the card).
Where JAX casts a product to the activations' dtype
(``.astype(x.dtype)``), the caller passes ``out=x.dtype`` and the f32
sum is rounded once; where JAX keeps the f32 result (the attention
logits, the gated MLP's ``act(g) * h``, the logits, the expert outputs,
the SSM products) :func:`mm` returns f32.  A bf16 ``torch.matmul`` is
never used: it would round those f32 results to bf16 (and cuBLAS may
sum bf16 products in reduced precision).  The router and the recurrent
steps are f32 x f32 products, as in JAX (TF32 stays off:
``torch.backends.cuda.matmul.allow_tf32`` is False by default).

Attention is the plain masked softmax that JAX writes: masked logits
are ``-1e30``, not ``-inf``; empty ring slots and sliding windows are
masked through the keys' absolute positions ``kpos``.
"""
from __future__ import annotations

import functools
import math
from typing import Optional

import torch
from torch import nn
from torch.nn import functional as F

# ---------------------------------------------------------------------------
# the parameter tree and its initializer
# ---------------------------------------------------------------------------


class Params(nn.Module):
    """A node of the parameter tree: the JAX package's dict of arrays as a
    module whose parameters (f32 tensors) and children (``Params`` or an
    ``nn.ModuleList`` where JAX stacks layers) are read by key.  The
    parameters are made without ``requires_grad``, so inference builds
    no autograd graph; :func:`repro_torch.train.make_train_step` turns
    it on for the tree it trains."""

    def __init__(self, entries: Optional[dict] = None):
        super().__init__()
        for key, value in (entries or {}).items():
            self[key] = value

    def __setitem__(self, key: str, value) -> None:
        if isinstance(value, nn.Module):
            self.add_module(key, value)
        else:
            self.register_parameter(
                key, nn.Parameter(value, requires_grad=False))

    def __getitem__(self, key: str):
        if key in self._parameters:
            return self._parameters[key]
        if key in self._modules:
            return self._modules[key]
        raise KeyError(key)

    def __contains__(self, key: str) -> bool:
        return key in self._parameters or key in self._modules

    def keys(self) -> list:
        return [*self._parameters, *self._modules]


class Init:
    """Draws parameters on ``device`` from one torch ``generator``: the
    JAX package's distributions (a dense weight normal x 1/sqrt(fan_in),
    the embedding normal x 0.02), not its streams.  On the meta device it
    makes shapes only (parameter counts without memory)."""

    def __init__(self, generator: Optional[torch.Generator],
                 device: torch.device):
        self.generator, self.device = generator, device

    def normal(self, shape, scale: float) -> torch.Tensor:
        out = torch.empty(shape, dtype=torch.float32, device=self.device)
        if self.device.type != "meta":
            out.normal_(generator=self.generator).mul_(scale)
        return out

    def dense(self, shape, fan_in: int) -> torch.Tensor:
        return self.normal(shape, fan_in ** -0.5)

    def ones(self, shape) -> torch.Tensor:
        return torch.ones(shape, dtype=torch.float32, device=self.device)

    def zeros(self, shape) -> torch.Tensor:
        return torch.zeros(shape, dtype=torch.float32, device=self.device)


def cast_c(x: torch.Tensor) -> torch.Tensor:
    """compute-dtype cast"""
    return x.to(torch.bfloat16)


def _product(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """bf16 ``a @ b`` with f32 sums as f32, on the card: ``a`` (..., m,
    k), ``b`` (k, n) or (..., k, n) broadcasting over the batch."""
    if b.dim() == 2:
        y = torch.mm(a.reshape(-1, a.shape[-1]), b, out_dtype=torch.float32)
        return y.reshape(*a.shape[:-1], b.shape[-1])
    batch = torch.broadcast_shapes(a.shape[:-2], b.shape[:-2])
    a3 = a.expand(*batch, *a.shape[-2:]).reshape(-1, *a.shape[-2:])
    b3 = b.expand(*batch, *b.shape[-2:]).reshape(-1, *b.shape[-2:])
    return torch.bmm(a3, b3, out_dtype=torch.float32).reshape(
        *batch, a.shape[-2], b.shape[-1])


class CardProduct(torch.autograd.Function):
    """:func:`_product` with JAX's gradient.  ``torch.mm``/``bmm`` with
    ``out_dtype`` have no derivative of their own.

    JAX differentiates a bf16 ``einsum`` with ``preferred_element_type
    =float32`` by a ``dot_general`` of the f32 cotangent with the other
    bf16 operand (f32 sums), then a ``convert_element_type`` to bf16.
    Here each operand's gradient is the cotangent times the other
    operand, f32 sums, summed in f32 over the batch dims that operand
    was broadcast along, then rounded to bf16; the callers' casts carry
    it back to the f32 parameter.  The tensor cores take bf16 operands,
    so the cotangent is rounded to bf16 first: one bf16 pass, as JAX's
    own target (the TPU) multiplies f32 by bf16 at default precision.
    On the CPU :func:`mm`'s f32 product keeps the f32 cotangent (JAX's
    CPU semantics); it is the plain version this backward is held
    against."""

    @staticmethod
    def forward(ctx, a, b):
        ctx.save_for_backward(a, b)
        return _product(a, b)

    @staticmethod
    def backward(ctx, g):
        a, b = ctx.saved_tensors
        g = g.to(torch.bfloat16)
        ga = gb = None
        if ctx.needs_input_grad[0]:
            ga = _product(g, b.transpose(-1, -2))
            ga = ga.sum_to_size(a.shape).to(torch.bfloat16)
        if ctx.needs_input_grad[1]:
            if b.dim() == 2:
                gb = _product(a.reshape(-1, a.shape[-1]).t(),
                              g.reshape(-1, g.shape[-1]))
            else:
                gb = _product(a.transpose(-1, -2), g).sum_to_size(b.shape)
            gb = gb.to(torch.bfloat16)
        return ga, gb


def mm(a: torch.Tensor, b: torch.Tensor, out=torch.float32) -> torch.Tensor:
    """``a @ b`` with bf16 operands and f32 sums, as ``out``: ``a`` (...,
    m, k), ``b`` (k, n) or (..., k, n) broadcasting over the batch.
    Differentiable on either device with JAX's rule (:class:`CardProduct`).
    Meta tensors take the card's route, so that a step run on them (the
    dry-run's count) runs the card's ops."""
    a, b = cast_c(a), cast_c(b)
    if a.device.type in ("cuda", "meta"):
        y = CardProduct.apply(a, b)
    else:
        y = torch.matmul(a.float(), b.float())
    return y.to(out)


# ---------------------------------------------------------------------------
# norms
# ---------------------------------------------------------------------------

def init_rmsnorm(init: Init, d: int) -> Params:
    return Params({"scale": init.ones((d,))})


def rms_norm(params, x, eps=1e-5):
    xf = x.float()
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    y = xf * torch.rsqrt(var + eps) * params["scale"]
    return y.to(x.dtype)


def init_layernorm(init: Init, d: int) -> Params:
    return Params({"scale": init.ones((d,)), "bias": init.zeros((d,))})


def layer_norm(params, x, eps=1e-5):
    xf = x.float()
    mu = torch.mean(xf, dim=-1, keepdim=True)
    var = torch.mean((xf - mu) ** 2, dim=-1, keepdim=True)
    y = (xf - mu) * torch.rsqrt(var + eps) * params["scale"] \
        + params["bias"]
    return y.to(x.dtype)


# ---------------------------------------------------------------------------
# RoPE (half-split / NeoX convention; ``rotary_frac`` supports chatglm's
# 2d-RoPE = rotation of only the first half of head_dim)
# ---------------------------------------------------------------------------

def rope_freqs(head_dim_rot: int, theta: float = 10000.0, device=None):
    exps = torch.arange(0, head_dim_rot, 2, dtype=torch.float32,
                        device=device) / head_dim_rot
    return 1.0 / (theta ** exps)  # (head_dim_rot/2,)


def apply_rope(x, positions, rotary_frac: float = 1.0,
               theta: float = 10000.0):
    """x: (..., S, H, D). positions: broadcastable (..., S)."""
    d = x.shape[-1]
    d_rot = int(d * rotary_frac)
    d_rot -= d_rot % 2
    if d_rot == 0:
        return x
    inv = rope_freqs(d_rot, theta, x.device)
    ang = positions[..., None].float() * inv  # (..., S, d_rot/2)
    cos = torch.cos(ang)[..., None, :]
    sin = torch.sin(ang)[..., None, :]
    xr, xp = x[..., :d_rot], x[..., d_rot:]
    x1, x2 = xr[..., : d_rot // 2], xr[..., d_rot // 2:]
    r1 = x1 * cos - x2 * sin
    r2 = x2 * cos + x1 * sin
    return torch.cat([r1.to(x.dtype), r2.to(x.dtype), xp], dim=-1)


# ---------------------------------------------------------------------------
# attention core
# ---------------------------------------------------------------------------

def sdpa(q, k, v, *, causal: bool, q_offset=0, sliding_window: int = 0,
         scale: Optional[float] = None, kpos=None):
    """q: (B, Sq, H, D); k/v: (B, Sk, G, D) with H % G == 0 (GQA).

    ``q_offset`` is the absolute position of q[0] (decode: cache length).
    ``kpos``: optional (Sk,) absolute positions of the keys -- the
    ring-buffer windowed cache, where slot j holds a rotating absolute
    position; negative = empty slot.
    """
    b, sq, h, d = q.shape
    _, sk, g, _ = k.shape
    dv = v.shape[-1]
    rep = h // g
    scale = scale if scale is not None else 1.0 / (d ** 0.5)
    # (b, g, rep * sq, d) @ (b, g, d, sk): the einsum bqgrd,bkgd->bgrqk
    qg = q.reshape(b, sq, g, rep, d).permute(0, 2, 3, 1, 4)
    logits = mm(qg.reshape(b, g, rep * sq, d), k.permute(0, 2, 3, 1))
    logits = logits.reshape(b, g, rep, sq, sk) * scale
    qpos = q_offset + torch.arange(sq, device=q.device)[:, None]
    if kpos is None:
        kpos = torch.arange(sk, device=q.device)
    kpos = kpos[None, :]
    mask = kpos >= 0
    if causal:
        mask = mask & (kpos <= qpos)
    if sliding_window:
        mask = mask & (kpos > qpos - sliding_window)
    logits = torch.where(mask, logits, -1e30)
    probs = torch.softmax(logits, dim=-1)
    out = mm(probs.reshape(b, g, rep * sq, sk), v.permute(0, 2, 1, 3))
    out = out.reshape(b, g, rep, sq, dv).permute(0, 3, 1, 2, 4)
    return out.reshape(b, sq, h, dv).to(q.dtype)


def sdpa_chunked(q, k, v, *, causal: bool = True, q_offset=0,
                 sliding_window: int = 0, scale: Optional[float] = None,
                 q_chunk: int = 2048, kv_chunk: int = 2048):
    """Flash-style chunked attention: online softmax over KV blocks.

    Never materializes the (Sq, Sk) logits -- peak live memory is one
    (q_chunk, kv_chunk) tile per head group.  Used by gqa_attention and
    mla_attention at ``CHUNKED_ATTN_THRESHOLD`` tokens and more; the same
    f32 sums as :func:`sdpa`, rescaled online.  JAX's ``lax.scan`` over
    the KV blocks and ``lax.map`` over the query blocks are loops here.
    """
    b, sq, h, d = q.shape
    _, sk, g, _ = k.shape
    dv = v.shape[-1]  # may differ from d (MLA: k_eff wider than v)
    rep = h // g
    scale = scale if scale is not None else 1.0 / (d ** 0.5)
    q_chunk = min(q_chunk, sq)
    kv_chunk = min(kv_chunk, sk)
    if sq % q_chunk or sk % kv_chunk:
        raise ValueError(f"chunks ({q_chunk}, {kv_chunk}) do not tile "
                         f"({sq}, {sk})")
    nq, nk = sq // q_chunk, sk // kv_chunk
    qg = q.reshape(b, sq, g, rep, d).permute(0, 2, 3, 1, 4)  # b g r sq d
    kt = k.permute(0, 2, 3, 1)                                # b g d sk
    vg = v.permute(0, 2, 1, 3)                                # b g sk dv
    out = torch.empty((b, g, rep, sq, dv), dtype=torch.float32,
                      device=q.device)
    for qi in range(nq):
        q_blk = qg[:, :, :, qi * q_chunk:(qi + 1) * q_chunk].reshape(
            b, g, rep * q_chunk, d)
        q_pos = q_offset + qi * q_chunk + torch.arange(
            q_chunk, device=q.device)[:, None]
        m_run = torch.full((b, g, rep, q_chunk), -math.inf,
                           dtype=torch.float32, device=q.device)
        l_run = torch.zeros_like(m_run)
        acc = torch.zeros((b, g, rep, q_chunk, dv), dtype=torch.float32,
                          device=q.device)
        for ki in range(nk):
            ks = slice(ki * kv_chunk, (ki + 1) * kv_chunk)
            logits = mm(q_blk, kt[..., ks]).reshape(
                b, g, rep, q_chunk, kv_chunk) * scale
            k_pos = ki * kv_chunk + torch.arange(
                kv_chunk, device=q.device)[None, :]
            mask = torch.ones((q_chunk, kv_chunk), dtype=torch.bool,
                              device=q.device)
            if causal:
                mask = mask & (k_pos <= q_pos)
            if sliding_window:
                mask = mask & (k_pos > q_pos - sliding_window)
            logits = torch.where(mask, logits, -1e30)
            m_new = torch.maximum(m_run, logits.amax(dim=-1))
            alpha = torch.exp(m_run - m_new)
            p = torch.exp(logits - m_new[..., None])
            l_run = l_run * alpha + p.sum(dim=-1)
            acc = acc * alpha[..., None] + mm(
                p.reshape(b, g, rep * q_chunk, kv_chunk),
                vg[:, :, ks]).reshape(b, g, rep, q_chunk, dv)
            m_run = m_new
        out[:, :, :, qi * q_chunk:(qi + 1) * q_chunk] = \
            acc / torch.clamp(l_run, min=1e-30)[..., None]
    out = out.permute(0, 3, 1, 2, 4).reshape(b, sq, h, dv)
    return out.to(q.dtype)


CHUNKED_ATTN_THRESHOLD = 8192  # use online-softmax attention at/above this


# ---------------------------------------------------------------------------
# GQA attention block
# ---------------------------------------------------------------------------

def init_gqa(init: Init, d_model, n_heads, n_kv, head_dim,
             bias: bool = False) -> Params:
    p = Params({
        "wq": init.dense((d_model, n_heads, head_dim), d_model),
        "wk": init.dense((d_model, n_kv, head_dim), d_model),
        "wv": init.dense((d_model, n_kv, head_dim), d_model),
        "wo": init.dense((n_heads, head_dim, d_model), n_heads * head_dim),
    })
    if bias:
        p["bq"] = init.zeros((n_heads, head_dim))
        p["bk"] = init.zeros((n_kv, head_dim))
        p["bv"] = init.zeros((n_kv, head_dim))
    return p


def project_heads(x, w, out=None):
    """The einsum ``bsd,dhk->bshk`` (cast to ``out``, by default x's
    dtype)."""
    b, s, _ = x.shape
    y = mm(x, w.reshape(w.shape[0], -1), out=out or x.dtype)
    return y.reshape(b, s, *w.shape[1:])


def merge_heads(y, wo, out):
    """The einsum ``bshk,hkd->bsd``."""
    b, s = y.shape[:2]
    return mm(y.reshape(b, s, -1), wo.reshape(-1, wo.shape[-1]), out=out)


def write_cache(buf, values, start: int) -> None:
    """Write ``values`` (B, S, ...) into ``buf`` (B, W, ...) at slot
    ``start`` along axis 1, in place; like ``dynamic_update_slice`` the
    start is clamped so that the values fit."""
    s = values.shape[1]
    start = max(0, min(int(start), buf.shape[1] - s))
    buf[:, start:start + s] = values.to(buf.dtype)


def gqa_attention(params, x, *, positions, causal=True, rotary_frac=1.0,
                  rope_theta=10000.0, sliding_window=0, cache=None,
                  ring=False):
    """cache: None (train/prefill) or dict(k, v, length) for decode, k and
    v one layer's (B, W, G, D) cache, written in place.

    ``ring=True``: the cache seq dim is a ring buffer of size
    ``sliding_window`` -- slot = position % window; keys are roped at
    write time so slots carry absolute positions.
    Returns (y, new_cache_or_None); new_cache holds the same k and v.
    """
    q = project_heads(x, params["wq"])
    k = project_heads(x, params["wk"])
    v = project_heads(x, params["wv"])
    if "bq" in params:
        q = q + params["bq"].to(q.dtype)
        k = k + params["bk"].to(k.dtype)
        v = v + params["bv"].to(v.dtype)
    q = apply_rope(q, positions, rotary_frac, rope_theta)
    k = apply_rope(k, positions, rotary_frac, rope_theta)

    new_cache = None
    q_offset = 0
    kpos = None
    if cache is not None:
        # decode: write this step's k/v at cache['length'] (or its ring slot)
        idx = int(cache["length"])
        w = cache["k"].shape[1]
        slot = idx % w if ring else idx
        write_cache(cache["k"], k, slot)
        write_cache(cache["v"], v, slot)
        k, v = cache["k"], cache["v"]
        q_offset = idx
        if ring:
            # slot j holds absolute position idx - ((idx - j) mod w);
            # not-yet-written slots come out negative => masked
            j = torch.arange(w, device=x.device)
            kpos = idx - ((idx - j) % w)
        new_cache = {"k": k, "v": v, "length": idx + q.shape[1]}
    if cache is None and q.shape[1] >= CHUNKED_ATTN_THRESHOLD:
        # long-sequence train/prefill: online-softmax chunked attention
        y = sdpa_chunked(q, k, v, causal=causal,
                         sliding_window=sliding_window)
    else:
        y = sdpa(q, k, v, causal=causal, q_offset=q_offset,
                 sliding_window=sliding_window, kpos=kpos)
    return merge_heads(y, params["wo"], x.dtype), new_cache


# ---------------------------------------------------------------------------
# MLA attention (DeepSeek-V2): low-rank KV compression; the decode cache
# holds only (c_kv, k_rope) -- the technique's memory win.
# ---------------------------------------------------------------------------

def init_mla(init: Init, d_model, n_heads, kv_lora, qk_nope=128,
             qk_rope=64, v_dim=128) -> Params:
    return Params({
        "wq": init.dense((d_model, n_heads, qk_nope + qk_rope), d_model),
        "wdkv": init.dense((d_model, kv_lora), d_model),
        "wkr": init.dense((d_model, qk_rope), d_model),
        "wuk": init.dense((kv_lora, n_heads, qk_nope), kv_lora),
        "wuv": init.dense((kv_lora, n_heads, v_dim), kv_lora),
        "wo": init.dense((n_heads, v_dim, d_model), n_heads * v_dim),
    })


def mla_attention(params, x, *, positions, qk_nope=128, qk_rope=64,
                  rope_theta=10000.0, cache=None):
    q = project_heads(x, params["wq"])
    qn, qr = q[..., :qk_nope], q[..., qk_nope:]
    qr = apply_rope(qr, positions, 1.0, rope_theta)

    ckv = mm(x, params["wdkv"], out=x.dtype)
    kr = mm(x, params["wkr"], out=x.dtype)
    kr = apply_rope(kr[:, :, None, :], positions, 1.0, rope_theta)[:, :, 0]

    q_offset = 0
    new_cache = None
    if cache is not None:
        idx = int(cache["length"])
        write_cache(cache["ckv"], ckv, idx)
        write_cache(cache["kr"], kr, idx)
        ckv, kr = cache["ckv"], cache["kr"]
        q_offset = idx
        new_cache = {"ckv": ckv, "kr": kr, "length": idx + x.shape[1]}

    # expand compressed cache to per-head keys/values
    kn = project_heads(ckv, params["wuk"])
    v = project_heads(ckv, params["wuv"])

    b, sq, h, _ = q.shape
    sk = kn.shape[1]
    scale = 1.0 / ((qk_nope + qk_rope) ** 0.5)
    if cache is None and sq >= CHUNKED_ATTN_THRESHOLD:
        # the two-term logits (nope + rope) fold into ONE effective dot --
        # q_eff = [qn, qr], k_eff = [kn, kr per head] -- so the chunked
        # path applies unchanged
        q_eff = torch.cat([qn, qr], dim=-1)
        kr_h = kr[:, :, None, :].expand(b, sk, h, kr.shape[-1]).to(kn.dtype)
        k_eff = torch.cat([kn, kr_h], dim=-1)
        y = sdpa_chunked(q_eff, k_eff, v, causal=True,
                         scale=scale).to(x.dtype)
    else:
        # bqhn,bkhn->bhqk + bqhr,bkr->bhqk
        logits = mm(qn.permute(0, 2, 1, 3), kn.permute(0, 2, 3, 1))
        logits = logits + mm(
            qr.permute(0, 2, 1, 3).reshape(b, h * sq, qk_rope),
            kr.transpose(1, 2)).reshape(b, h, sq, sk)
        logits = logits * scale
        qpos = q_offset + torch.arange(sq, device=x.device)[:, None]
        kpos = torch.arange(sk, device=x.device)[None, :]
        logits = torch.where(kpos <= qpos, logits, -1e30)
        probs = torch.softmax(logits, dim=-1)
        # bhqk,bkhd->bqhd
        y = mm(probs, v.permute(0, 2, 1, 3), out=x.dtype).permute(0, 2, 1, 3)
    return merge_heads(y, params["wo"], x.dtype), new_cache


# ---------------------------------------------------------------------------
# gated MLP (SwiGLU) / plain MLP
# ---------------------------------------------------------------------------

def sigmoid(x):
    """JAX's logistic, ``1 / (1 + exp(-x))`` a step at a time in x's
    dtype: in bf16 XLA rounds after each step, which ``torch.sigmoid``
    (one rounding) disagrees with on about a third of the values."""
    return 1 / (1 + torch.exp(-x))


def silu(x):
    """JAX's ``x * sigmoid(x)``."""
    return x * sigmoid(x)


#: the activations by config name; JAX's ``jax.nn.gelu`` is the tanh
#: approximation by default
ACTS = {"silu": silu, "gelu": functools.partial(F.gelu, approximate="tanh")}


def init_mlp(init: Init, d_model, d_ff, gated: bool = True) -> Params:
    p = Params({"wi": init.dense((d_model, d_ff), d_model),
                "wo": init.dense((d_ff, d_model), d_ff)})
    if gated:
        p["wg"] = init.dense((d_model, d_ff), d_model)
    return p


def mlp(params, x, act=silu):
    h = mm(x, params["wi"])                 # f32, as JAX keeps it
    if "wg" in params:
        g = mm(x, params["wg"])
        h = act(g) * h
    else:
        h = act(h)
    return mm(h.to(x.dtype), params["wo"], out=x.dtype)


# ---------------------------------------------------------------------------
# embedding / unembedding
# ---------------------------------------------------------------------------

def init_embed(init: Init, vocab, d_model) -> Params:
    return Params({"table": init.normal((vocab, d_model), 0.02)})


def embed(params, tokens):
    # JAX casts the table before its gather; the gathered rows cast after
    # it are the same values
    return cast_c(F.embedding(tokens, params["table"]))


def unembed(params, x):
    return mm(x, params["table"].t())
