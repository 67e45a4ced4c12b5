"""State-space / recurrent blocks: Mamba2 (SSD) and xLSTM (mLSTM + sLSTM).

Counterpart of ``repro.models.ssm``.  One chunked linear-attention core
serves both Mamba2's SSD recurrence and the mLSTM matrix memory:

    S_t = exp(log_a_t) * S_{t-1} + scale_t * (k_t outer v_t)
    y_t = q_t . S_t

computed chunk-parallel (intra-chunk products and a short loop over the
chunk states, JAX's ``lax.scan``); decode is the O(1) single-step
recurrence on a cached state.  The scans and the recurrent steps run in
f32, as JAX runs them; the chunk products take bf16 operands and f32
sums (:func:`repro_torch.models.layers.mm`).
"""
from __future__ import annotations

import torch
from torch.nn import functional as F

from .layers import Init, Params, cast_c, mm, silu


def _exact(*xs):
    """bf16-rounded operands as f32: a product of two (or a bf16 and a
    product of two) is exact in f32, so an f32 contraction of them sums
    exact products, as a bf16 product with f32 sums does."""
    return [cast_c(x).float() for x in xs]


# ---------------------------------------------------------------------------
# chunked linear attention core
# ---------------------------------------------------------------------------

def chunked_linear_attention(q, k, v, log_a, scale, state0=None,
                             chunk: int = 256):
    """q,k: (B,S,H,Dk); v: (B,S,H,Dv); log_a, scale: (B,S,H).

    Returns (y: (B,S,H,Dv) f32, final_state: (B,H,Dk,Dv) f32).
    """
    b, s, h, dk = q.shape
    dv = v.shape[-1]
    chunk = min(chunk, s)
    if s % chunk:
        raise ValueError(f"chunk {chunk} does not tile {s} steps")
    nc = s // chunk

    def r(x):
        return x.reshape(b, nc, chunk, *x.shape[2:])

    qc, kc, vc = r(q), r(k), r(v)
    la, sc = r(log_a), r(scale)

    cum = torch.cumsum(la, dim=2)                   # (b,nc,L,h)
    total = cum[:, :, -1]                           # (b,nc,h)

    # intra-chunk: y[i] += sum_{j<=i} exp(cum_i - cum_j) * sc_j * (q_i.k_j) v_j
    decay_ij = cum[:, :, :, None, :] - cum[:, :, None, :, :]   # (b,nc,i,j,h)
    ii = torch.arange(chunk, device=q.device)
    causal = (ii[:, None] >= ii[None, :])[None, None, :, :, None]
    w = torch.where(causal, torch.exp(decay_ij), 0.0)
    # bcihd,bcjhd->bcijh
    attn = mm(qc.permute(0, 1, 3, 2, 4), kc.permute(0, 1, 3, 4, 2))
    attn = attn.permute(0, 1, 3, 4, 2)
    wattn = attn * w * sc[:, :, None, :, :]
    # bcijh,bcjhv->bcihv
    y_intra = mm(wattn.permute(0, 1, 4, 2, 3), vc.permute(0, 1, 3, 2, 4))
    y_intra = y_intra.permute(0, 1, 3, 2, 4)

    # per-chunk state contribution: sum_j exp(total - cum_j) sc_j k_j (x) v_j
    wk = torch.exp(total[:, :, None, :] - cum) * sc          # (b,nc,L,h)
    chunk_state = torch.einsum("bcjh,bcjhd,bcjhv->bchdv",
                               *_exact(wk, kc, vc))

    # scan chunk states: s_c = exp(total_c) * s_{c-1} + chunk_state_c
    if state0 is None:
        state0 = torch.zeros((b, h, dk, dv), dtype=torch.float32,
                             device=q.device)
    state = state0.float()
    incoming = []                                    # the INCOMING states
    for c in range(nc):
        incoming.append(state)
        state = torch.exp(total[:, c])[:, :, None, None] * state \
            + chunk_state[:, c]
    incoming = torch.stack(incoming, dim=1)          # (b,nc,h,dk,dv)

    # inter-chunk: y[i] += exp(cum_i) * q_i . state_in   (bcihd,bchdv->bcihv)
    y_inter = mm(qc.permute(0, 1, 3, 2, 4), incoming).permute(0, 1, 3, 2, 4)
    y_inter = y_inter * torch.exp(cum)[..., None]

    y = (y_intra + y_inter).reshape(b, s, h, dv)
    return y, state


def linear_attention_step(q, k, v, log_a, scale, state):
    """Single decode step. q,k: (B,1,H,Dk) etc.; state: (B,H,Dk,Dv)."""
    a = torch.exp(log_a[:, 0])[:, :, None, None]             # (b,h,1,1)
    kv = torch.einsum("bhd,bhv->bhdv", k[:, 0].float(), v[:, 0].float())
    new_state = a * state + scale[:, 0][:, :, None, None] * kv
    y = torch.einsum("bhd,bhdv->bhv", q[:, 0].float(), new_state)
    return y[:, None].to(v.dtype), new_state


# ---------------------------------------------------------------------------
# Mamba2 block
# ---------------------------------------------------------------------------

def init_mamba2(init: Init, d_model, d_state=64, expand=2, head_dim=64,
                conv_width=4) -> Params:
    d_inner = expand * d_model
    n_heads = d_inner // head_dim
    return Params({
        # projections: z (gate), x, B, C, dt
        "in_proj": init.dense(
            (d_model, 2 * d_inner + 2 * d_state + n_heads), d_model),
        "conv_w": init.normal((conv_width, d_inner + 2 * d_state), 0.1),
        "a_log": init.zeros((n_heads,)),
        "d_skip": init.ones((n_heads,)),
        "dt_bias": init.zeros((n_heads,)),
        "out_proj": init.dense((d_inner, d_model), d_inner),
        "norm_scale": init.ones((d_inner,)),
    })


def _causal_conv(x, w, tail=None):
    """Depthwise causal conv, width W: x (B,S,C), w (W,C), in x's dtype.

    tail: (B, W-1, C) previous context for decode; returns (y, new_tail).
    """
    width = w.shape[0]
    if tail is None:
        tail = torch.zeros((x.shape[0], width - 1, x.shape[2]),
                           dtype=x.dtype, device=x.device)
    ext = torch.cat([tail, x], dim=1)
    y = sum(ext[:, i:i + x.shape[1]] * w[i].to(x.dtype)
            for i in range(width))
    new_tail = ext[:, -(width - 1):]
    return silu(y), new_tail


def mamba2_block(params, x, *, d_state=64, expand=2, head_dim=64,
                 chunk=256, cache=None):
    """x: (B,S,D). cache: None or {'state','conv_tail'}. -> (y, new_cache)
    (new_cache None without a cache)."""
    d_model = x.shape[-1]
    d_inner = expand * d_model
    n_heads = d_inner // head_dim
    proj = mm(x, params["in_proj"], out=x.dtype)
    z, xc, bc, cc, dt = torch.split(
        proj, [d_inner, d_inner, d_state, d_state, n_heads], dim=-1)

    conv_in = torch.cat([xc, bc, cc], dim=-1)
    conv_tail = cache["conv_tail"] if cache is not None else None
    conv_out, new_tail = _causal_conv(conv_in, params["conv_w"], conv_tail)
    xc = conv_out[..., :d_inner]
    bc = conv_out[..., d_inner:d_inner + d_state]
    cc = conv_out[..., d_inner + d_state:]

    b, s, _ = x.shape
    xh = xc.reshape(b, s, n_heads, head_dim)
    dt = F.softplus(dt.float() + params["dt_bias"])      # (b,s,h)
    a = -torch.exp(params["a_log"])                      # (h,)
    log_decay = a * dt                                   # (b,s,h)
    kq = bc[:, :, None, :].expand(b, s, n_heads, d_state)   # B -> k
    qq = cc[:, :, None, :].expand(b, s, n_heads, d_state)   # C -> q

    if cache is None:
        y, _ = chunked_linear_attention(qq, kq, xh, log_decay, dt,
                                        chunk=chunk)
        new_cache = None
    else:
        y, final = linear_attention_step(qq, kq, xh, log_decay, dt,
                                         cache["state"])
        new_cache = {"state": final, "conv_tail": new_tail}
    y = y + params["d_skip"][None, None, :, None] * xh.float()
    y = y.reshape(b, s, d_inner)
    # gated RMS norm
    yf = y * silu(z.float())
    var = torch.mean(yf * yf, dim=-1, keepdim=True)
    yf = yf * torch.rsqrt(var + 1e-5) * params["norm_scale"]
    out = mm(yf.to(x.dtype), params["out_proj"], out=x.dtype)
    return out, new_cache


# ---------------------------------------------------------------------------
# xLSTM: mLSTM (matrix memory) and sLSTM (scalar memory) blocks
# ---------------------------------------------------------------------------

def init_mlstm(init: Init, d_model, n_heads, head_dim) -> Params:
    d_inner = n_heads * head_dim
    return Params({
        "wqkv": init.dense((d_model, 3, n_heads, head_dim), d_model),
        "wif": init.dense((d_model, 2, n_heads), d_model),
        "wo": init.dense((d_inner, d_model), d_inner),
        "ogate": init.dense((d_model, d_inner), d_model),
    })


def mlstm_block(params, x, *, n_heads, head_dim, chunk=256, cache=None):
    b, s, d = x.shape
    qkv = mm(x, params["wqkv"].reshape(d, -1), out=x.dtype).reshape(
        b, s, 3, n_heads, head_dim)
    q, k, v = qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]
    k = k / (head_dim ** 0.5)
    gates = mm(x, params["wif"].reshape(d, -1)).reshape(b, s, 2, n_heads)
    i_gate = torch.exp(-F.softplus(-gates[:, :, 0]))     # sigmoid, (b,s,h)
    log_f = -F.softplus(-gates[:, :, 1])                 # log sigmoid

    if cache is None:
        y, _ = chunked_linear_attention(q, k, v, log_f, i_gate, chunk=chunk)
        new_cache = None
    else:
        y, final = linear_attention_step(q, k, v, log_f, i_gate,
                                         cache["state"])
        new_cache = {"state": final}
    og = torch.sigmoid(mm(x, params["ogate"]))
    y = y.reshape(b, s, n_heads * head_dim) * og
    out = mm(y.to(x.dtype), params["wo"], out=x.dtype)
    return out, new_cache


def init_slstm(init: Init, d_model, n_heads) -> Params:
    return Params({
        # gates: i, f, z, o
        "wx": init.dense((d_model, 4, d_model), d_model),
        "wh": init.dense((d_model, 4, d_model), d_model).mul_(0.1),
    })


def slstm_block(params, x, *, cache=None):
    """Scalar-memory LSTM with exponential gating; a loop over time (JAX's
    ``lax.scan``) in f32."""
    b, s, d = x.shape
    wx = mm(x, params["wx"].reshape(d, -1)).reshape(b, s, 4, d)

    if cache is None:
        h = torch.zeros((b, d), dtype=torch.float32, device=x.device)
        c = torch.zeros((b, d), dtype=torch.float32, device=x.device)
        n = torch.ones((b, d), dtype=torch.float32, device=x.device)
    else:
        h, c, n = cache["h"], cache["c"], cache["n"]

    wh = params["wh"].float().reshape(d, -1)
    ys = []
    for t in range(s):
        g = wx[:, t] + (h @ wh).reshape(b, 4, d)
        i = torch.exp(torch.clamp(g[:, 0], -10.0, 10.0))
        f = torch.sigmoid(g[:, 1])
        z = torch.tanh(g[:, 2])
        o = torch.sigmoid(g[:, 3])
        c = f * c + i * z
        n = f * n + i
        h = o * c / torch.clamp(torch.abs(n), min=1.0)
        ys.append(h)
    y = torch.stack(ys, dim=1).to(x.dtype)
    new_cache = {"h": h, "c": c, "n": n} if cache is not None else None
    return y, new_cache
