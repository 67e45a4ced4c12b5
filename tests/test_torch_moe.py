"""``repro_torch.models.moe`` against ``repro.models.moe`` on the CPU.

From the same bf16 tokens and the same weights the router (f32 x f32),
its top-k, the capacity positions (a cumsum over the (token, k) order)
and the dispatch are the same computation in both, and the outputs came
out bit-equal here; they are held to one bf16 rounding of the largest
output (the expert products sum in another order).  The aux loss is an
f32 mean, held to 1e-6.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import moe as JM
from repro_torch.models import moe as TM
from repro_torch.models.convert import _node

BF16_ULP = 2.0 ** -8
D, F_EXPERT, E = 32, 24, 8


def f32(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


def setup(seed, n_shared=1, b=2, s=12):
    pj = JM.init_moe(jax.random.PRNGKey(seed), D, F_EXPERT, E, n_shared, 2)
    pt = _node(jax.tree.map(np.asarray, pj), "cpu")
    x = np.random.default_rng(seed).standard_normal((b, s, D)).astype(
        np.float32)
    return pj, pt, jnp.asarray(x).astype(jnp.bfloat16), \
        torch.tensor(x).to(torch.bfloat16)


@pytest.mark.parametrize("per_sequence", [False, True])
@pytest.mark.parametrize("capacity_factor", [1e-9, 0.5, 1.25, float(E)])
@pytest.mark.parametrize("top_k,n_shared", [(2, 1), (3, 0)])
def test_moe_block_matches_jax(per_sequence, capacity_factor, top_k,
                               n_shared):
    pj, pt, xj, xt = setup(1, n_shared)
    kw = dict(top_k=top_k, capacity_factor=capacity_factor,
              per_sequence=per_sequence)
    yj, aj = JM.moe_block(pj, xj, **kw)
    yt, at = TM.moe_block(pt, xt, **kw)
    assert yt.dtype == torch.bfloat16 and yt.shape == xt.shape
    assert np.abs(f32(yt) - f32(yj)).max() <= \
        BF16_ULP * np.abs(f32(yj)).max()
    assert abs(float(at) - float(aj)) <= 1e-6


def test_topk_picks_jax_experts_and_capacity_positions():
    """The routing state itself: top-k experts in the same order, and the
    capacity positions of JAX's cumsum over the flattened (token, k)
    order, globally and per sequence."""
    pj, pt, xj, xt = setup(2, s=16)
    probs = jax.nn.softmax(jnp.einsum(
        "bsd,de->bse", xj.astype(jnp.float32), pj["router"]), axis=-1)
    _, experts_j = jax.lax.top_k(probs, 2)
    probs_t, _, experts_t = TM._route(pt, xt, 2)
    assert np.abs(probs_t.numpy() - np.asarray(probs)).max() < 1e-6
    assert np.array_equal(experts_t.numpy(), np.asarray(experts_j))
    onehot = jax.nn.one_hot(experts_j, E, dtype=jnp.int32)
    for per_sequence in (False, True):
        flat = onehot.reshape(2, -1, E) if per_sequence \
            else onehot.reshape(-1, E)
        axis = 1 if per_sequence else 0
        want = (jnp.cumsum(flat, axis=axis) * flat - 1).max(axis=-1)
        got = TM._positions(experts_t if per_sequence
                            else experts_t.reshape(-1, 2), E)
        assert np.array_equal(got.numpy().ravel(),
                              np.asarray(want).ravel())


def test_moe_token_mass_conservation():
    """With a capacity past every expert's load each token's output is its
    shared path plus its gates times its top-k experts' SwiGLU of it:
    nothing dropped, nothing added (the dispatch and combine conserve the
    tokens), in both layouts."""
    _, pt, _, xt = setup(3, s=10)
    probs, gates, experts = TM._route(pt, xt, 2)
    xf = xt.float()
    want = torch.zeros_like(xf)
    for b in range(xt.shape[0]):
        for s in range(xt.shape[1]):
            for k in range(2):
                e = int(experts[b, s, k])
                tok = xt[b, s][None]
                h = TM.mm(tok, pt["wi"][e])
                g = TM.mm(tok, pt["wg"][e])
                y = TM.mm((TM.silu(g) * h).to(torch.bfloat16), pt["wo"][e])
                want[b, s] += float(gates[b, s, k]) * y[0]
    want = want.to(torch.bfloat16).float() + TM._shared_path(
        pt, xt.reshape(-1, D), torch.bfloat16).float().reshape(xf.shape)
    for per_sequence in (False, True):
        y, _ = TM.moe_block(pt, xt, top_k=2, capacity_factor=float(E),
                            per_sequence=per_sequence)
        assert torch.allclose(y.float(), want, rtol=2 * BF16_ULP,
                              atol=2 * BF16_ULP * float(want.abs().max()))


def test_moe_capacity_drops_route_nothing_and_never_nan():
    """A capacity of one slot (factor 1e-9) keeps only each expert's first
    token; the rest get the shared path alone."""
    _, pt, _, xt = setup(4)
    y, aux = TM.moe_block(pt, xt, top_k=2, capacity_factor=1e-9)
    assert bool(torch.isfinite(y.float()).all()) and bool(
        torch.isfinite(aux))
    shared = TM._shared_path(pt, xt.reshape(-1, D), torch.bfloat16)
    same = (y.reshape(-1, D) == shared).all(dim=-1)
    # at most one token an expert took the routed path
    assert int((~same).sum()) <= E


def test_moe_layouts_agree_dropless():
    """Dropless, the global buffer and the per-sequence ones give the same
    tokens the same experts: the same outputs."""
    _, pt, _, xt = setup(5)
    yg, ag = TM.moe_block(pt, xt, top_k=2, capacity_factor=float(E))
    ys, as_ = TM.moe_block(pt, xt, top_k=2, capacity_factor=float(E),
                           per_sequence=True)
    assert torch.equal(yg, ys) and float(ag) == float(as_)


def test_aux_loss_matches_jax():
    r = np.random.default_rng(6)
    experts = r.integers(0, E, (3, 5, 2))
    probs = r.random((3, 5, E)).astype(np.float32)
    probs /= probs.sum(-1, keepdims=True)
    want = JM._aux_loss(jnp.asarray(experts), jnp.asarray(probs), E)
    got = TM._aux_loss(torch.tensor(experts), torch.tensor(probs), E)
    assert abs(float(got) - float(want)) <= 1e-6
