"""``repro_torch.models.layers`` against ``repro.models.layers`` on the
CPU: the same numpy inputs and weights through both.

Tolerances are stated as a share of the largest reference value.  The
f32 paths (norms before their cast, rope's angles) are held to 1e-5.  A
bf16 path (bf16 operands, f32 sums, a bf16 result) is held to one bf16
rounding, 2^-8 of the largest value: the two sum in another order, so a
sum near a rounding boundary may round the other way.  Measured on this
container the bf16 paths came out bit-equal (max error 0) unless noted.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import layers as JL
from repro_torch.models import layers as TL
from repro_torch.models.convert import _node

BF16_ULP = 2.0 ** -8


def rng(seed):
    return np.random.default_rng(seed)


def both(a, bf16=True):
    """The numpy array ``a`` as a JAX and a torch array, bf16 or f32."""
    j, t = jnp.asarray(a), torch.tensor(a)
    if bf16:
        return j.astype(jnp.bfloat16), t.to(torch.bfloat16)
    return j, t


def f32(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


def close(got, want, rel=BF16_ULP, atol=0.0):
    got, want = f32(got), f32(want)
    assert got.shape == want.shape
    err = np.abs(got - want).max() if got.size else 0.0
    assert err <= rel * np.abs(want).max() + atol, (err, np.abs(want).max())


def params(tree):
    """A JAX param dict as the port's Params."""
    return _node(jax.tree.map(np.asarray, tree), "cpu")


def test_params_read_by_key_and_hold_no_grad():
    p = params({"wq": np.ones((2, 3), np.float32),
                "inner": {"scale": np.zeros(3, np.float32)}})
    assert "wq" in p and "bq" not in p and "inner" in p
    assert p["wq"].shape == (2, 3) and p["inner"]["scale"].shape == (3,)
    assert not p["wq"].requires_grad
    assert sorted(p.keys()) == ["inner", "wq"]
    with pytest.raises(KeyError):
        p["bq"]


@pytest.mark.parametrize("shape", [(2, 5, 64), (1, 3, 48)])
def test_rms_and_layer_norm(shape):
    r = rng(0)
    xj, xt = both(r.standard_normal(shape).astype(np.float32) * 3)
    scale = r.standard_normal(shape[-1]).astype(np.float32)
    bias = r.standard_normal(shape[-1]).astype(np.float32)
    close(TL.rms_norm(params({"scale": scale}), xt),
          JL.rms_norm({"scale": jnp.asarray(scale)}, xj))
    close(TL.layer_norm(params({"scale": scale, "bias": bias}), xt),
          JL.layer_norm({"scale": jnp.asarray(scale),
                         "bias": jnp.asarray(bias)}, xj))
    # f32 in, f32 out: the f32 path alone
    xj, xt = both(r.standard_normal(shape).astype(np.float32), bf16=False)
    close(TL.rms_norm(params({"scale": scale}), xt),
          JL.rms_norm({"scale": jnp.asarray(scale)}, xj), rel=1e-5)


@pytest.mark.parametrize("d_rot,theta", [(16, 10000.0), (64, 10000.0),
                                         (8, 500000.0)])
def test_rope_freqs(d_rot, theta):
    close(TL.rope_freqs(d_rot, theta), JL.rope_freqs(d_rot, theta),
          rel=1e-6)


@pytest.mark.parametrize("frac", [1.0, 0.5, 0.25, 0.0])
@pytest.mark.parametrize("offset", [0, 1000])
def test_apply_rope(frac, offset):
    r = rng(1)
    xj, xt = both(r.standard_normal((2, 6, 4, 16)).astype(np.float32))
    pos = np.arange(offset, offset + 6)
    close(TL.apply_rope(xt, torch.tensor(pos), frac),
          JL.apply_rope(xj, jnp.asarray(pos), frac))


def qkv(seed, b=2, sq=8, sk=8, h=4, g=2, d=16, dv=None):
    r = rng(seed)
    q = r.standard_normal((b, sq, h, d)).astype(np.float32)
    k = r.standard_normal((b, sk, g, d)).astype(np.float32)
    v = r.standard_normal((b, sk, g, dv or d)).astype(np.float32)
    return both(q), both(k), both(v)


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("window", [0, 3])
@pytest.mark.parametrize("h,g", [(4, 2), (4, 4), (4, 1)])
def test_sdpa(causal, window, h, g):
    (qj, qt), (kj, kt), (vj, vt) = qkv(2, h=h, g=g)
    close(TL.sdpa(qt, kt, vt, causal=causal, sliding_window=window),
          JL.sdpa(qj, kj, vj, causal=causal, sliding_window=window))


def test_sdpa_decode_offset_and_ring_kpos():
    """One query at absolute position 9 against a ring of 4 slots: slot j
    holds position 9 - ((9 - j) mod 4); a negative position (an empty
    slot) is masked, as is a key outside the window."""
    (qj, qt), (kj, kt), (vj, vt) = qkv(3, sq=1, sk=4)
    for idx in (2, 9):
        kpos = idx - ((idx - np.arange(4)) % 4)
        got = TL.sdpa(qt, kt, vt, causal=True, q_offset=idx,
                      sliding_window=4, kpos=torch.tensor(kpos))
        want = JL.sdpa(qj, kj, vj, causal=True, q_offset=idx,
                       sliding_window=4, kpos=jnp.asarray(kpos))
        close(got, want)
    # with no key left (every slot empty) both give the mean of v
    got = TL.sdpa(qt, kt, vt, causal=True, kpos=torch.full((4,), -1))
    want = JL.sdpa(qj, kj, vj, causal=True, kpos=jnp.full((4,), -1))
    close(got, want)


@pytest.mark.parametrize("causal,window", [(True, 0), (True, 5),
                                           (False, 0)])
def test_sdpa_chunked_against_jax_and_sdpa(causal, window):
    (qj, qt), (kj, kt), (vj, vt) = qkv(4, sq=16, sk=16, dv=8)
    kw = dict(causal=causal, sliding_window=window, q_chunk=4, kv_chunk=8)
    got = TL.sdpa_chunked(qt, kt, vt, **kw)
    close(got, JL.sdpa_chunked(qj, kj, vj, **kw))
    # the online softmax against the full one: the same sums rescaled,
    # within one bf16 rounding (measured 2^-8 of the largest value here)
    close(got, TL.sdpa(qt, kt, vt, causal=causal, sliding_window=window),
          rel=2 * BF16_ULP)


def test_sdpa_chunked_rejects_chunks_that_do_not_tile():
    (_, qt), (_, kt), (_, vt) = qkv(5, sq=12, sk=12)
    with pytest.raises(ValueError, match="tile"):
        TL.sdpa_chunked(qt, kt, vt, q_chunk=8)


def gqa_params(seed, bias):
    p = JL.init_gqa(jax.random.PRNGKey(seed), 64, 4, 2, 16, bias=bias)
    if bias:    # non-zero biases, so that they count
        r = rng(seed)
        p = {k: (jnp.asarray(r.standard_normal(v.shape).astype(np.float32))
                 if k.startswith("b") else v) for k, v in p.items()}
    return p, params(p)


@pytest.mark.parametrize("bias", [False, True])
@pytest.mark.parametrize("frac,window", [(1.0, 0), (0.5, 0), (1.0, 4),
                                         (0.0, 0)])
def test_gqa_attention_prefill(bias, frac, window):
    pj, pt = gqa_params(6, bias)
    xj, xt = both(rng(6).standard_normal((2, 10, 64)).astype(np.float32))
    pos = np.arange(10)
    kw = dict(rotary_frac=frac, sliding_window=window)
    got, gc = TL.gqa_attention(pt, xt, positions=torch.tensor(pos), **kw)
    want, wc = JL.gqa_attention(pj, xj, positions=jnp.asarray(pos), **kw)
    assert gc is None and wc is None
    close(got, want)


@pytest.mark.parametrize("ring", [False, True])
def test_gqa_attention_decode_writes_the_cache_in_place(ring):
    """Ten decode steps against a cache of 4 slots (ring) or 10: the same
    outputs as JAX's, each step's k/v written at its slot in place."""
    pj, pt = gqa_params(7, True)
    r = rng(7)
    w, steps = (4, 10) if ring else (10, 10)
    cj = {"k": jnp.zeros((2, w, 2, 16), jnp.bfloat16),
          "v": jnp.zeros((2, w, 2, 16), jnp.bfloat16), "length": 0}
    kt = torch.zeros((2, w, 2, 16), dtype=torch.bfloat16)
    vt = torch.zeros_like(kt)
    for i in range(steps):
        xj, xt = both(r.standard_normal((2, 1, 64)).astype(np.float32))
        kw = dict(sliding_window=w if ring else 0, ring=ring)
        got, ct = TL.gqa_attention(
            pt, xt, positions=torch.tensor([i]),
            cache={"k": kt, "v": vt, "length": i}, **kw)
        want, cj = JL.gqa_attention(
            pj, xj, positions=jnp.asarray([i]),
            cache={"k": cj["k"], "v": cj["v"], "length": jnp.int32(i)},
            **kw)
        close(got, want)
        assert ct["k"] is kt and ct["length"] == i + 1
        close(kt, cj["k"])
        close(vt, cj["v"])


def test_mla_attention_prefill_and_decode():
    pj = JL.init_mla(jax.random.PRNGKey(8), 64, 4, 32, 16, 8, 16)
    pt = params(pj)
    r = rng(8)
    xj, xt = both(r.standard_normal((2, 6, 64)).astype(np.float32))
    pos = np.arange(6)
    kw = dict(qk_nope=16, qk_rope=8)
    close(TL.mla_attention(pt, xt, positions=torch.tensor(pos), **kw)[0],
          JL.mla_attention(pj, xj, positions=jnp.asarray(pos), **kw)[0])
    cj = {"ckv": jnp.zeros((2, 6, 32), jnp.bfloat16),
          "kr": jnp.zeros((2, 6, 8), jnp.bfloat16)}
    ct = {"ckv": torch.zeros((2, 6, 32), dtype=torch.bfloat16),
          "kr": torch.zeros((2, 6, 8), dtype=torch.bfloat16)}
    for i in range(6):
        got, nt = TL.mla_attention(pt, xt[:, i:i + 1],
                                   positions=torch.tensor([i]),
                                   cache={**ct, "length": i}, **kw)
        want, cj = JL.mla_attention(pj, xj[:, i:i + 1],
                                    positions=jnp.asarray([i]),
                                    cache={**cj, "length": jnp.int32(i)},
                                    **kw)
        close(got, want)
        assert nt["ckv"] is ct["ckv"]
        close(ct["ckv"], cj["ckv"])
        close(ct["kr"], cj["kr"])


def test_mla_folded_chunked_logits():
    """MLA's long-sequence path folds its two logit terms into one dot
    (q_eff, k_eff) for ``sdpa_chunked``: the same function as the two
    terms through ``sdpa``'s masked softmax, within a bf16 rounding."""
    (_, qn), (_, kn), (_, v) = qkv(9, sq=8, sk=8, h=4, g=4, d=16)
    (_, qr), (_, kr), _ = qkv(10, sq=8, sk=8, h=4, g=4, d=8)
    kr1 = kr[:, :, :1]
    scale = 1.0 / 24 ** 0.5
    q_eff = torch.cat([qn, qr], dim=-1)
    k_eff = torch.cat([kn, kr1.expand(-1, -1, 4, -1)], dim=-1)
    got = TL.sdpa_chunked(q_eff, k_eff, v, scale=scale, q_chunk=4,
                          kv_chunk=4)
    want = TL.sdpa(q_eff, k_eff, v, causal=True, scale=scale)
    close(got, want, rel=2 * BF16_ULP)


@pytest.mark.parametrize("gated,act", [(True, "silu"), (False, "gelu")])
def test_mlp(gated, act):
    pj = JL.init_mlp(jax.random.PRNGKey(10), 64, 96, gated)
    xj, xt = both(rng(10).standard_normal((2, 5, 64)).astype(np.float32))
    jact = {"silu": jax.nn.silu, "gelu": jax.nn.gelu}[act]
    close(TL.mlp(params(pj), xt, act=TL.ACTS[act]),
          JL.mlp(pj, xj, act=jact))


def test_sigmoid_and_silu_round_as_jax_in_bf16():
    """XLA's bf16 logistic rounds after each of its steps; the port's
    ``sigmoid`` does too (``torch.sigmoid`` disagrees with it on about a
    third of these values)."""
    xj, xt = both(rng(11).standard_normal(4096).astype(np.float32) * 4)
    assert np.array_equal(f32(TL.sigmoid(xt)), f32(jax.nn.sigmoid(xj)))
    assert np.array_equal(f32(TL.silu(xt)), f32(jax.nn.silu(xj)))


def test_embed_and_unembed():
    pj = JL.init_embed(jax.random.PRNGKey(12), 50, 32)
    pt = params(pj)
    tokens = rng(12).integers(0, 50, (3, 7)).astype(np.int32)
    xj = JL.embed(pj, jnp.asarray(tokens))
    xt = TL.embed(pt, torch.tensor(tokens))
    assert xt.dtype == torch.bfloat16
    assert np.array_equal(f32(xt), f32(xj))
    lj, lt = JL.unembed(pj, xj), TL.unembed(pt, xt)
    assert lt.dtype == torch.float32
    # f32 logits from bf16 operands: the sums in another order, 1e-5
    close(lt, lj, rel=1e-5)


def test_mm_takes_bf16_operands_and_sums_in_f32():
    r = rng(13)
    a = r.standard_normal((3, 40)).astype(np.float32)
    b = r.standard_normal((40, 5)).astype(np.float32)
    want = (torch.tensor(a).to(torch.bfloat16).double()
            @ torch.tensor(b).to(torch.bfloat16).double())
    got = TL.mm(torch.tensor(a), torch.tensor(b))
    assert got.dtype == torch.float32
    assert float((got.double() - want).abs().max()) < 1e-5
    assert TL.mm(torch.tensor(a), torch.tensor(b),
                 out=torch.bfloat16).dtype == torch.bfloat16
    # batched, broadcasting the weight's batch
    a3 = torch.tensor(r.standard_normal((2, 3, 4, 40)).astype(np.float32))
    b3 = torch.tensor(r.standard_normal((3, 40, 6)).astype(np.float32))
    assert TL.mm(a3, b3).shape == (2, 3, 4, 6)
