"""int8 error-feedback gradient compression (``repro_torch.train.compress``)
on the CPU: the counterparts of ``tests/test_compress.py``, and parity
with the JAX package.

``quantize`` and ``compress_leaf`` equal JAX's bit for bit on the same
f32 input (``torch.round`` and ``jnp.round`` both round half to even).
The compressed sum equals JAX's ``make_compressed_psum`` run over a
named axis (``jax.vmap`` with ``axis_name``) bit for bit: an int32 sum
of the int8 payloads times the mean of the scales, divided by the rank
count.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _hypothesis_compat import given, settings, st

from repro.train import compress as jax_compress
from repro_torch.configs import SHAPES, get_smoke_config
from repro_torch.data import make_batch
from repro_torch.launch.mesh import Mesh
from repro_torch.models import init_model
from repro_torch.train import OptConfig, make_train_step, opt_init
from repro_torch.train import compress


@given(seed=st.integers(0, 2**31 - 1), scale=st.floats(1e-3, 1e3))
@settings(max_examples=50, deadline=None)
def test_quantize_error_bound(seed, scale):
    x = torch.randn(64, generator=torch.Generator().manual_seed(seed)) \
        * scale
    q, s = compress.quantize(x)
    assert q.dtype == torch.int8
    err = (compress.dequantize(q, s) - x).abs()
    assert float(err.max()) <= float(s) / 2 + 1e-6


def test_error_feedback_accumulates_residual():
    g = torch.tensor([1.0, 1e-4, -1e-4, 0.5])
    err = torch.zeros(4)
    q, s, new_err = compress.compress_leaf(g, err)
    # residual == what dequantization lost
    np.testing.assert_allclose(new_err.numpy(),
                               (g - compress.dequantize(q, s)).numpy(),
                               atol=1e-7)


def test_compressed_sgd_converges_like_exact():
    """Least squares via GD: int8+error-feedback reaches the same loss."""
    gen = torch.Generator().manual_seed(0)
    a = torch.randn(32, 8, generator=gen)
    x_true = torch.randn(8, generator=gen)
    y = a @ x_true

    def loss(x):
        return 0.5 * torch.mean((a @ x - y) ** 2)

    def run(compressed: bool, steps=300, lr=0.1):
        x = torch.zeros(8)
        err = torch.zeros(8)
        for _ in range(steps):
            xg = x.clone().requires_grad_(True)
            loss(xg).backward()
            g = xg.grad
            if compressed:
                q, s, err = compress.compress_leaf(g, err)
                g = compress.dequantize(q, s)
            x = x - lr * g
        return float(loss(x))

    exact = run(False)
    comp = run(True)
    assert comp < 1e-4, comp
    assert comp < max(exact * 50, 1e-5)


def inputs(seed, n=257):
    """f32 values with exact ties of the rounding (k + 1/2 steps of the
    scale) among normal draws."""
    r = np.random.default_rng(seed)
    x = (r.standard_normal(n) * 10.0 ** r.uniform(-3, 3)).astype(np.float32)
    scale = np.float32(np.abs(x).max()) / np.float32(127.0)
    x[:8] = (np.arange(8, dtype=np.float32) - 3.5) * scale
    return x


@pytest.mark.parametrize("seed", range(6))
def test_quantize_bit_equal_to_jax(seed):
    x = inputs(seed)
    jq, js = jax_compress.quantize(jnp.asarray(x))
    q, s = compress.quantize(torch.tensor(x))
    assert np.array_equal(q.numpy(), np.asarray(jq))
    assert np.float32(s) == np.float32(js)
    assert np.array_equal(compress.dequantize(q, s).numpy(),
                          np.asarray(jax_compress.dequantize(jq, js)))


@pytest.mark.parametrize("seed", range(4))
def test_compress_leaf_bit_equal_to_jax(seed):
    g, err = inputs(seed), inputs(seed + 100) * np.float32(1e-3)
    jq, js, je = jax_compress.compress_leaf(jnp.asarray(g), jnp.asarray(err))
    q, s, e = compress.compress_leaf(torch.tensor(g), torch.tensor(err))
    assert np.array_equal(q.numpy(), np.asarray(jq))
    assert np.float32(s) == np.float32(js)
    assert np.array_equal(e.numpy(), np.asarray(je))


def rank_trees(n, seed):
    r = np.random.default_rng(seed)
    return [{"w": r.standard_normal((3, 5)).astype(np.float32),
             "b": (r.standard_normal(4) * 1e-3).astype(np.float32)}
            for _ in range(n)]


def stack(trees):
    return jax.tree.map(lambda *x: jnp.stack(x), *trees)


@pytest.mark.parametrize("n", [1, 2, 4])
def test_compressed_psum_bit_equal_to_jax(n):
    grads, errs = rank_trees(n, n), rank_trees(n, n + 10)
    errs = [jax.tree.map(lambda e: e * np.float32(1e-2), t) for t in errs]
    jsync = jax_compress.make_compressed_psum("dp")
    jsynced, jerr = jax.vmap(jsync, axis_name="dp")(stack(grads),
                                                    stack(errs))
    to_t = lambda t: jax.tree.map(torch.tensor, t)  # noqa: E731
    synced, new_err = compress.make_compressed_psum("dp")(
        [to_t(g) for g in grads], [to_t(e) for e in errs])
    assert len(synced) == len(new_err) == n
    for r in range(n):
        for key in ("w", "b"):
            assert np.array_equal(synced[r][key].numpy(),
                                  np.asarray(jsynced[key][r]))
            assert np.array_equal(new_err[r][key].numpy(),
                                  np.asarray(jerr[key][r]))


def test_dp_sync_sums_over_the_data_axis_of_a_mesh():
    """On a 2 x 2 (data, model) mesh the data axis joins shards (0, 2)
    and (1, 3): each pair's sum is the JAX psum of that pair alone."""
    mesh = Mesh((2, 2), ("data", "model"), (torch.device("cpu"),))
    grads, errs = rank_trees(4, 7), rank_trees(4, 8)
    to_t = lambda t: jax.tree.map(torch.tensor, t)  # noqa: E731
    synced, _ = compress.make_dp_compressed_sync(mesh, ("data",))(
        [to_t(g) for g in grads], [to_t(e) for e in errs])
    jsync = jax_compress.make_compressed_psum("dp")
    for pair in ((0, 2), (1, 3)):
        want, _ = jax.vmap(jsync, axis_name="dp")(
            stack([grads[i] for i in pair]), stack([errs[i] for i in pair]))
        for j, r in enumerate(pair):
            assert np.array_equal(synced[r]["w"].numpy(),
                                  np.asarray(want["w"][j]))
    assert not torch.equal(synced[0]["w"], synced[1]["w"])
    with pytest.raises(ValueError, match="mesh of 4"):
        compress.make_dp_compressed_sync(mesh, ("data",))(
            [to_t(g) for g in grads[:3]], [to_t(e) for e in errs[:3]])


def test_compressed_sync_as_grad_sync_trains():
    """One rank's compressed sync as ``make_train_step``'s ``grad_sync``
    with its error carried across steps: the loss falls as without it."""
    cfg = get_smoke_config("internlm2-1.8b")
    batch = make_batch(cfg, SHAPES["train_4k"], step=0, seed=1,
                       batch_override=4, seq_override=32, device="cpu")
    ocfg = OptConfig(lr=1e-2, warmup=5, total_steps=100)
    sync = compress.make_compressed_psum("dp")
    state = {}

    def grad_sync(grads):
        err = state.get("err") or compress.init_error_state(grads)
        (synced,), (state["err"],) = sync([grads], [err])
        return synced

    params = init_model(cfg, 0, device="cpu")
    step = make_train_step(cfg, ocfg, grad_sync=grad_sync)
    opt = opt_init(params)
    losses = []
    for _ in range(20):
        params, opt, m = step(params, opt, batch)
        losses.append(float(m["loss"]))
    assert losses[-1] < losses[0] * 0.8, losses[::5]
    assert len(state["err"]) == len(list(params.parameters()))
