"""``repro_torch.models.ssm`` against ``repro.models.ssm`` on the CPU.

The scans and recurrent steps are f32 in both and held to 1e-5 of the
largest value where their inputs are f32, to a bf16 rounding where they
are bf16 (a value one rounding apart moves them); the chunk products take bf16 operands and f32 sums in
both (measured: within 1e-6 here), held to 1e-4.  A block's bf16 output
(bf16 operands, f32 sums, a bf16 result) is held to one bf16 rounding,
2^-8 of its largest value (measured: bit-equal here, once the port's
sigmoid rounds as XLA's bf16 logistic does).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import ssm as JS
from repro_torch.models import ssm as TS
from repro_torch.models.convert import _node

BF16_ULP = 2.0 ** -8

# compiled, as the JAX model runs them (eager, XLA's CPU dot thunk refuses
# some bf16 x bf16 -> f32 contractions of the chunked core)
J_CHUNKED = jax.jit(JS.chunked_linear_attention, static_argnames="chunk")
J_MAMBA = jax.jit(JS.mamba2_block, static_argnames=(
    "d_state", "expand", "head_dim", "chunk"))
J_MLSTM = jax.jit(JS.mlstm_block, static_argnames=("n_heads", "head_dim",
                                                    "chunk"))


def f32(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


def close(got, want, rel):
    got, want = f32(got), f32(want)
    assert got.shape == want.shape
    assert np.abs(got - want).max() <= rel * np.abs(want).max(), \
        (np.abs(got - want).max(), np.abs(want).max())


def both(a, bf16=False):
    j, t = jnp.asarray(a), torch.tensor(a)
    return (j.astype(jnp.bfloat16), t.to(torch.bfloat16)) if bf16 else (j, t)


def lin_inputs(seed, b=2, s=16, h=3, dk=5, dv=7):
    r = np.random.default_rng(seed)
    q, k = (r.standard_normal((b, s, h, dk)).astype(np.float32)
            for _ in range(2))
    v = r.standard_normal((b, s, h, dv)).astype(np.float32)
    log_a = -np.log1p(np.exp(r.standard_normal((b, s, h)))).astype(
        np.float32)
    scale = (1 / (1 + np.exp(-r.standard_normal((b, s, h))))).astype(
        np.float32)
    return [both(x) for x in (q, k, v, log_a, scale)]


@pytest.mark.parametrize("chunk", [4, 8, 16])
def test_chunked_linear_attention_matches_jax(chunk):
    args = lin_inputs(1)
    yj, sj = J_CHUNKED(*[a[0] for a in args], chunk=chunk)
    yt, st = TS.chunked_linear_attention(*[a[1] for a in args], chunk=chunk)
    close(yt, yj, 1e-4)
    close(st, sj, 1e-4)


def test_chunked_linear_attention_carries_a_state():
    args = lin_inputs(2)
    state = np.random.default_rng(2).standard_normal((2, 3, 5, 7)).astype(
        np.float32)
    yj, sj = J_CHUNKED(*[a[0] for a in args],
                                         state0=jnp.asarray(state), chunk=4)
    yt, st = TS.chunked_linear_attention(*[a[1] for a in args],
                                         state0=torch.tensor(state), chunk=4)
    close(yt, yj, 1e-4)
    close(st, sj, 1e-4)


def test_chunked_against_stepwise():
    """The port's chunk-parallel form against its own recurrence (JAX's
    test_chunked_linear_attention_matches_stepwise, the same 2e-2)."""
    q, k, v, la, sc = [a[1] for a in lin_inputs(3)]
    y, final = TS.chunked_linear_attention(q, k, v, la, sc, chunk=4)
    state = torch.zeros((2, 3, 5, 7))
    ys = []
    for t in range(16):
        yt, state = TS.linear_attention_step(
            q[:, t:t + 1], k[:, t:t + 1], v[:, t:t + 1], la[:, t:t + 1],
            sc[:, t:t + 1], state)
        ys.append(yt[:, 0])
    assert torch.allclose(y, torch.stack(ys, dim=1), rtol=2e-2, atol=2e-2)
    assert torch.allclose(final, state, rtol=2e-2, atol=2e-2)


def test_chunked_rejects_a_chunk_that_does_not_tile():
    q, k, v, la, sc = [a[1] for a in lin_inputs(4, s=12)]
    with pytest.raises(ValueError, match="tile"):
        TS.chunked_linear_attention(q, k, v, la, sc, chunk=8)


def test_linear_attention_step_matches_jax():
    q, k, v, la, sc = lin_inputs(5, s=1)
    state = np.random.default_rng(5).standard_normal((2, 3, 5, 7)).astype(
        np.float32)
    yj, sj = JS.linear_attention_step(q[0], k[0], v[0], la[0], sc[0],
                                      jnp.asarray(state))
    yt, st = TS.linear_attention_step(q[1], k[1], v[1], la[1], sc[1],
                                      torch.tensor(state))
    close(yt, yj, 1e-5)
    close(st, sj, 1e-5)


def test_causal_conv_and_its_decode_tail():
    r = np.random.default_rng(6)
    x = r.standard_normal((2, 9, 12)).astype(np.float32)
    w = (r.standard_normal((4, 12)) * 0.1).astype(np.float32)
    tail = r.standard_normal((2, 3, 12)).astype(np.float32)
    (xj, xt), (tj, tt) = both(x, True), both(tail, True)
    for tj_, tt_ in ((None, None), (tj, tt)):
        yj, nj = JS._causal_conv(xj, jnp.asarray(w), tj_)
        yt, nt = TS._causal_conv(xt, torch.tensor(w), tt_)
        assert np.array_equal(f32(yt), f32(yj))
        assert np.array_equal(f32(nt), f32(nj))
    # the tail carries the context: the conv of 9 steps at once equals
    # 9 one-step convs with their tails
    tail_t = None
    steps = []
    for t in range(9):
        y, tail_t = TS._causal_conv(xt[:, t:t + 1], torch.tensor(w),
                                    tail_t)
        steps.append(y)
    assert torch.equal(torch.cat(steps, dim=1),
                       TS._causal_conv(xt, torch.tensor(w))[0])


def mamba(seed):
    pj = JS.init_mamba2(jax.random.PRNGKey(seed), 32, d_state=8, expand=2,
                        head_dim=16)
    r = np.random.default_rng(seed)   # non-trivial decay, skip and bias
    for key in ("a_log", "d_skip", "dt_bias"):
        pj[key] = jnp.asarray(r.standard_normal(pj[key].shape).astype(
            np.float32) * 0.5)
    return pj, _node(jax.tree.map(np.asarray, pj), "cpu")


def test_mamba2_block_prefill_matches_jax():
    pj, pt = mamba(7)
    xj, xt = both(np.random.default_rng(7).standard_normal(
        (2, 16, 32)).astype(np.float32), True)
    kw = dict(d_state=8, expand=2, head_dim=16, chunk=8)
    yj, cj = J_MAMBA(pj, xj, **kw)
    yt, ct = TS.mamba2_block(pt, xt, **kw)
    assert cj is None and ct is None
    close(yt, yj, BF16_ULP)


def test_mamba2_decode_with_its_tail_matches_jax_and_prefill():
    """Eight decode steps from an empty state and tail: JAX's outputs and
    states, and the port's own prefill within the prefill/decode test's
    2e-2 of the largest output."""
    pj, pt = mamba(8)
    x = np.random.default_rng(8).standard_normal((2, 8, 32)).astype(
        np.float32)
    xj, xt = both(x, True)
    kw = dict(d_state=8, expand=2, head_dim=16)
    cj = {"state": jnp.zeros((2, 4, 8, 16)),
          "conv_tail": jnp.zeros((2, 3, 64 + 16), jnp.bfloat16)}
    ct = {"state": torch.zeros((2, 4, 8, 16)),
          "conv_tail": torch.zeros((2, 3, 64 + 16), dtype=torch.bfloat16)}
    outs = []
    for t in range(8):
        yj, cj = J_MAMBA(pj, xj[:, t:t + 1], cache=cj, **kw)
        yt, ct = TS.mamba2_block(pt, xt[:, t:t + 1], cache=ct, **kw)
        close(yt, yj, BF16_ULP)
        close(ct["state"], cj["state"], 1e-5)
        assert np.array_equal(f32(ct["conv_tail"]), f32(cj["conv_tail"]))
        outs.append(yt)
    full, _ = TS.mamba2_block(pt, xt, chunk=4, **kw)
    close(torch.cat(outs, dim=1), full, 2e-2)


def test_mlstm_block_matches_jax():
    pj = JS.init_mlstm(jax.random.PRNGKey(9), 32, 4, 8)
    pt = _node(jax.tree.map(np.asarray, pj), "cpu")
    xj, xt = both(np.random.default_rng(9).standard_normal(
        (2, 8, 32)).astype(np.float32), True)
    close(TS.mlstm_block(pt, xt, n_heads=4, head_dim=8, chunk=4)[0],
          J_MLSTM(pj, xj, n_heads=4, head_dim=8, chunk=4)[0],
          BF16_ULP)
    cj = {"state": jnp.zeros((2, 4, 8, 8))}
    ct = {"state": torch.zeros((2, 4, 8, 8))}
    for t in range(4):
        yj, cj = J_MLSTM(pj, xj[:, t:t + 1], n_heads=4, head_dim=8,
                         cache=cj)
        yt, ct = TS.mlstm_block(pt, xt[:, t:t + 1], n_heads=4, head_dim=8,
                                cache=ct)
        close(yt, yj, BF16_ULP)
        # the f32 state of bf16 k and v: a k one rounding apart moves it
        # by 2^-9 (measured 0.3 % of its largest entry at step 4)
        close(ct["state"], cj["state"], BF16_ULP)


def test_slstm_block_matches_jax():
    pj = JS.init_slstm(jax.random.PRNGKey(10), 32, 4)
    pt = _node(jax.tree.map(np.asarray, pj), "cpu")
    xj, xt = both(np.random.default_rng(10).standard_normal(
        (2, 8, 32)).astype(np.float32), True)
    yj, _ = JS.slstm_block(pj, xj)
    yt, ct = TS.slstm_block(pt, xt)
    assert ct is None
    close(yt, yj, BF16_ULP)
    cache = {"h": np.zeros((2, 32), np.float32),
             "c": np.zeros((2, 32), np.float32),
             "n": np.ones((2, 32), np.float32)}
    cj = {k: jnp.asarray(v) for k, v in cache.items()}
    ct = {k: torch.tensor(v) for k, v in cache.items()}
    for t in range(3):
        yj, cj = JS.slstm_block(pj, xj[:, t:t + 1], cache=cj)
        yt, ct = TS.slstm_block(pt, xt[:, t:t + 1], cache=ct)
        close(yt, yj, BF16_ULP)
        for k in cache:
            close(ct[k], cj[k], 1e-5)
