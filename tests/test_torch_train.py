"""The LM stack's training path (``repro_torch.train``,
``repro_torch.launch.train``) on the CPU: the counterparts of
``tests/test_train.py``, the product's gradient rule, and parity with
the JAX package from JAX's weights (``params_from_jax``) and batches
(``make_batch``, whose tokens are JAX's bit for bit): here the loss, the
schedule and the optimizer, in ``tests/test_torch_train_jax.py`` the
gradients, a train step and the checkpoints across the packages.

Tolerance, measured first: ``cross_entropy``, ``schedule``,
``global_norm`` and ``update`` on the same f32 inputs agree to f32
rounding (``F32``: relative 2e-6, the few ulps that another order of
the same f32 operations gives).  Adam's first update is about
``lr * sign(g)``, so where a near-zero gradient takes the other sign a
parameter moves by up to ``2 lr``: the microbatch test holds each
parameter within ``2.1 lr``, as ``tests/test_train.py`` holds JAX's.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.ckpt import Checkpointer as JaxCheckpointer
from repro.models import init_model as jax_init_model
from repro.train import OptConfig as JaxOptConfig
from repro.train import opt_init as jax_opt_init
from repro.train import optim as jax_optim
from repro.train.step import cross_entropy as jax_cross_entropy
from repro_torch.ckpt import Checkpointer
from repro_torch.configs import SHAPES, get_smoke_config
from repro_torch.data import DataIterator, make_batch
from repro_torch.launch import train as launch_train
from repro_torch.models import init_cache, init_model
from repro_torch.models import layers as L
from repro_torch.models.convert import params_from_jax, params_to_jax
from repro_torch.train import (OptConfig, cross_entropy, make_loss_fn,
                               make_prefill_step, make_serve_step,
                               make_train_step, opt_init, opt_update)
from repro_torch.train import optim
from repro_torch.train.optim import opt_from_jax

F32 = 2e-6
B, S = 2, 16


@pytest.fixture(autouse=True)
def few_threads():
    """Two torch threads a test: the suite runs several test processes
    side by side."""
    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 2))
    yield
    torch.set_num_threads(n)


def tiny_setup(arch="internlm2-1.8b", seed=0):
    cfg = get_smoke_config(arch)
    params = init_model(cfg, seed, device="cpu")
    opt = opt_init(params)
    ocfg = OptConfig(lr=1e-2, warmup=5, total_steps=100, clip_norm=1.0)
    return cfg, params, opt, make_train_step(cfg, ocfg)


def np_tree(tree):
    return jax.tree.map(np.asarray, tree)


# ---------------------------------------------------------------------------
# counterparts of tests/test_train.py
# ---------------------------------------------------------------------------

def test_loss_decreases():
    cfg, params, opt, step = tiny_setup()
    batch = make_batch(cfg, SHAPES["train_4k"], step=0, seed=1,
                       batch_override=4, seq_override=32, device="cpu")
    losses = []
    for _ in range(30):   # the same batch: must memorize
        params, opt, m = step(params, opt, batch)
        losses.append(float(m["loss"]))
    assert losses[-1] < losses[0] * 0.7, losses[::6]
    assert np.isfinite(losses).all()


def test_moe_train_step_runs():
    cfg, params, opt, step = tiny_setup("deepseek-moe-16b")
    batch = make_batch(cfg, SHAPES["train_4k"], step=0, seed=1,
                       batch_override=2, seq_override=16, device="cpu")
    out, opt2, m = step(params, opt, batch)
    assert out is params and opt2 is opt          # updated in place
    assert int(opt["count"]) == 1
    assert np.isfinite(float(m["loss"])) and np.isfinite(float(m["aux"]))
    assert float(m["aux"]) > 0
    assert float(m["total"]) == pytest.approx(
        float(m["loss"]) + 0.01 * float(m["aux"]), rel=1e-6)


def test_grad_clip_bounds_update():
    x = {"w": torch.ones((4, 4)) * 1e6}
    assert float(optim.global_norm(x)) == pytest.approx(4e6)
    ocfg = OptConfig(clip_norm=1.0, lr=1.0, warmup=0, weight_decay=0.0)
    params = {"w": x["w"].clone()}
    state = opt_init(params)
    new_x, _, metrics = opt_update(ocfg, x, params, state)
    assert float(metrics["grad_norm"]) == pytest.approx(4e6, rel=1e-3)
    # clipped: per-element grad after scale is tiny -> update bounded by lr
    assert float((new_x["w"] - x["w"]).abs().max()) <= 1.01 * 1.0 * 2
    assert torch.equal(x["w"], torch.ones((4, 4)) * 1e6)  # grads untouched


def test_schedule_warmup_and_decay():
    ocfg = OptConfig(lr=1.0, warmup=10, total_steps=100)
    assert float(optim.schedule(ocfg, 5)) == pytest.approx(0.5)
    assert float(optim.schedule(ocfg, 10)) == pytest.approx(1.0)
    assert float(optim.schedule(ocfg, 100)) == pytest.approx(0.1, abs=1e-3)


def test_microbatched_grads_match_full_batch():
    """JAX's H9: 4-way gradient accumulation == the full-batch step, held
    as tests/test_train.py holds JAX's."""
    cfg = get_smoke_config("internlm2-1.8b")
    ocfg = OptConfig(lr=1e-2, warmup=0, total_steps=10)
    batch = make_batch(cfg, SHAPES["train_4k"], step=0, seed=2,
                       batch_override=8, seq_override=16, device="cpu")
    pf, pm = (init_model(cfg, 9, device="cpu") for _ in range(2))
    pf, _, mf = make_train_step(cfg, ocfg)(pf, opt_init(pf), batch)
    pm, _, mm = make_train_step(cfg, ocfg, microbatches=4)(
        pm, opt_init(pm), batch)
    assert abs(float(mf["loss"]) - float(mm["loss"])) < 1e-4
    assert abs(float(mf["grad_norm"]) - float(mm["grad_norm"])) < 1e-3
    lr = 1e-2
    for a, b in zip(pf.parameters(), pm.parameters()):
        a, b = a.detach().numpy(), b.detach().numpy()
        np.testing.assert_allclose(a, b, atol=2.1 * lr, rtol=0)
        assert np.mean(np.abs(a - b) < 1e-4) > 0.99


def run_steps(cfg, step, params, opt, start, n, seed=5):
    it = DataIterator(cfg, SHAPES["train_4k"], seed=seed, batch_override=2,
                      seq_override=16, device="cpu")
    it.skip_to(start)
    losses = []
    for _ in range(n):
        _, batch = next(it)
        params, opt, m = step(params, opt, batch)
        losses.append(float(m["loss"]))
    return params, opt, losses


def test_train_restart_equivalence(tmp_path):
    """10 straight steps == 5 steps + checkpoint + restore + 5 steps, bit
    for bit, through the port's Checkpointer in JAX's layout."""
    cfg, pa, oa, step = tiny_setup()
    pa, oa, _ = run_steps(cfg, step, pa, oa, 0, 10)

    _, pb, ob, _ = tiny_setup()
    pb, ob, _ = run_steps(cfg, step, pb, ob, 0, 5)
    ck = Checkpointer(str(tmp_path / "ck"))
    ck.save(5, launch_train.state_tree(cfg, pb, ob))
    st, restored = ck.restore(launch_train.state_tree(cfg, pb, ob))
    assert st == 5
    pc = params_from_jax(cfg, restored["params"], device="cpu")
    oc = opt_from_jax(cfg, restored["opt"], device="cpu")
    pc, oc, _ = run_steps(cfg, step, pc, oc, 5, 5)

    for la, lc in zip(pa.parameters(), pc.parameters()):
        assert torch.equal(la, lc)
    assert int(oa["count"]) == int(oc["count"]) == 10
    for key in ("mu", "nu"):
        for la, lc in zip(oa[key].parameters(), oc[key].parameters()):
            assert torch.equal(la, lc)


def test_inference_steps_build_no_graph_after_training():
    cfg, params, opt, step = tiny_setup()
    batch = make_batch(cfg, SHAPES["train_4k"], batch_override=2,
                       seq_override=8, device="cpu")
    step(params, opt, batch)
    assert all(p.requires_grad for p in params.parameters())
    assert all(p.grad is None for p in params.parameters())
    logits = make_prefill_step(cfg)(params, batch)
    assert not logits.requires_grad and logits.grad_fn is None
    cache = init_cache(cfg, 2, 4, device="cpu")
    tok, cache = make_serve_step(cfg)(params, cache, batch["tokens"][:, :1])
    assert not tok.requires_grad
    assert not cache["kv"]["k"].requires_grad


def test_sdpa_chunked_gradient_matches_sdpa():
    """Autograd through ``sdpa_chunked``'s online softmax and its slice
    writes into the output (the path of 8192 tokens and more), at chunks
    of 4 over 16 tokens: its gradients are ``sdpa``'s to the bf16
    rounding of the two outputs (relative RMS 2 %, measured 0.4-0.5 %)."""
    gen = torch.Generator().manual_seed(3)
    q0, k0, v0 = (torch.randn((2, 16, 4, 8), generator=gen).to(
        torch.bfloat16) for _ in range(3))
    k0, v0 = k0[:, :, :2], v0[:, :, :2]                    # GQA: 4 / 2
    g = torch.randn((2, 16, 4, 8), generator=gen)
    grads = []
    for fn in (L.sdpa, lambda q, k, v, causal: L.sdpa_chunked(
            q, k, v, causal=causal, q_chunk=4, kv_chunk=4)):
        q, k, v = (t.clone().requires_grad_(True) for t in (q0, k0, v0))
        fn(q, k, v, causal=True).float().backward(g)
        grads.append([t.grad.float() for t in (q, k, v)])
    for got, want in zip(*grads):
        rel = float((got - want).pow(2).mean().sqrt()
                    / want.pow(2).mean().sqrt())
        assert rel <= 0.02, rel


def test_checkpoint_tree_is_a_snapshot():
    """launch.train's checkpoint tree holds host copies: a step that
    updates the parameters and moments in place (while ``save_async``
    writes) leaves it as it was."""
    cfg, params, opt, step = tiny_setup("xlstm-125m")
    tree = launch_train.state_tree(cfg, params, opt)
    before = [a.copy() for a in jax.tree.leaves(tree)]
    batch = make_batch(cfg, SHAPES["train_4k"], batch_override=2,
                       seq_override=8, device="cpu")
    step(params, opt, batch)
    assert all(np.array_equal(a, b)
               for a, b in zip(jax.tree.leaves(tree), before))
    assert int(tree["opt"]["count"]) == 0 and int(opt["count"]) == 1


@pytest.mark.parametrize("arch", ["internlm2-1.8b", "zamba2-1.2b",
                                  "xlstm-125m", "whisper-large-v3",
                                  "internvl2-26b"])
def test_remat_recomputes_the_same_gradients(arch):
    """remat=True (each layer's body checkpointed) and remat=False give
    the same loss and gradients bit for bit (not the MoE archs, whose
    dispatch layout ``remat`` also picks, as in JAX)."""
    cfg = get_smoke_config(arch)
    batch = make_batch(cfg, SHAPES["train_4k"], step=1, seed=3,
                       batch_override=2, seq_override=16, device="cpu")
    out = []
    for remat in (True, False):
        params = init_model(cfg, 4, device="cpu")
        for p in params.parameters():
            p.requires_grad_(True)
        total, _ = make_loss_fn(cfg, remat=remat)(params, batch)
        total.backward()
        out.append((total.detach(), [p.grad for p in params.parameters()]))
    assert torch.equal(out[0][0], out[1][0])
    assert all(torch.equal(a, b) for a, b in zip(out[0][1], out[1][1]))


# ---------------------------------------------------------------------------
# the product's gradient: JAX's rule, the card's form emulated on the CPU
# ---------------------------------------------------------------------------

def emulated_product(a, b):
    """The card's ``_product`` on the CPU: bf16 operands' exact products
    summed in f32, as f32."""
    return torch.matmul(a.float(), b.float())


#: (a's shape, b's shape): 2-D weights, batched, b broadcast over a
#: batch axis, a broadcast over b's
MM_LAYOUTS = [((6, 5, 8), (8, 7)), ((3, 5, 8), (3, 8, 7)),
              ((2, 3, 5, 8), (3, 8, 7)), ((1, 5, 8), (4, 8, 7))]


@pytest.mark.parametrize("a_shape,b_shape", MM_LAYOUTS)
def test_card_product_backward_is_jax_rule(monkeypatch, a_shape, b_shape):
    """``CardProduct`` (its product emulated) against the CPU's plain
    ``mm``, which has JAX's CPU gradient under autograd: each operand's
    gradient is bf16, summed over its broadcast axes.  With a cotangent
    that bf16 holds exactly the two agree to one bf16 rounding; with an
    f32 cotangent the card's (rounded to bf16 first: one bf16 pass, as
    the TPU at default precision) differs by about 2^-9 relative."""
    monkeypatch.setattr(L, "_product", emulated_product)
    r = np.random.default_rng(len(a_shape) + len(b_shape))
    a0 = torch.tensor(r.standard_normal(a_shape), dtype=torch.float32)
    b0 = torch.tensor(r.standard_normal(b_shape), dtype=torch.float32)
    batch = torch.broadcast_shapes(a_shape[:-2], b_shape[:-2])
    out_shape = (*batch, a_shape[-2], b_shape[-1]) if len(b_shape) > 2 \
        else (*a_shape[:-1], b_shape[-1])
    g_f32 = torch.tensor(r.standard_normal(out_shape), dtype=torch.float32)
    for g, tol in ((g_f32.to(torch.bfloat16).float(), 2 ** -8),
                   (g_f32, 2 ** -6)):
        grads = {}
        for form in ("card", "plain"):
            a = a0.to(torch.bfloat16).requires_grad_(True)
            b = b0.to(torch.bfloat16).requires_grad_(True)
            if form == "card":
                y = L.CardProduct.apply(a, b)
            else:
                y = torch.matmul(a.float(), b.float())
            assert tuple(y.shape) == out_shape and y.dtype == torch.float32
            y.backward(g)
            grads[form] = (a.grad, b.grad)
        for got, want, shape in zip(grads["card"], grads["plain"],
                                    (a_shape, b_shape)):
            assert got.dtype == want.dtype == torch.bfloat16
            assert tuple(got.shape) == shape
            err = (got.float() - want.float()).abs().max()
            assert float(err) <= tol * float(want.float().abs().max())


def test_mm_gradient_reaches_the_f32_parameter():
    """The product's bf16 gradient is carried back to the f32 parameter
    by the cast: JAX's ``astype`` transpose."""
    w = torch.randn(8, 4, generator=torch.Generator().manual_seed(0))
    w.requires_grad_(True)
    x = torch.randn(3, 8, generator=torch.Generator().manual_seed(1)).to(
        torch.bfloat16)
    L.mm(x, w).sum().backward()
    want = (x.float().t() @ torch.ones(3, 4)).to(torch.bfloat16).float()
    assert w.grad.dtype == torch.float32 and torch.equal(w.grad, want)


# ---------------------------------------------------------------------------
# parity with the JAX package
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("shape", [(2, 3, 11), (1, 7, 257), (4, 2, 1000)])
def test_cross_entropy_matches_jax(shape):
    r = np.random.default_rng(sum(shape))
    logits = (r.standard_normal(shape) * 5).astype(np.float32)
    labels = r.integers(0, shape[-1], shape[:-1]).astype(np.int32)
    want = float(jax_cross_entropy(jnp.asarray(logits), jnp.asarray(labels)))
    got = float(cross_entropy(torch.tensor(logits), torch.tensor(labels)))
    assert got == pytest.approx(want, rel=F32)
    # its gradient: softmax - one_hot, over the positions
    lg = torch.tensor(logits, requires_grad=True)
    cross_entropy(lg, torch.tensor(labels)).backward()
    jg = jax.grad(lambda x: jax_cross_entropy(x, jnp.asarray(labels)))(
        jnp.asarray(logits))
    np.testing.assert_allclose(lg.grad.numpy(), np.asarray(jg), rtol=1e-5,
                               atol=F32 * float(np.abs(jg).max()))


@pytest.mark.parametrize("step", [0, 1, 3, 5, 17, 60, 99, 100, 250])
def test_schedule_matches_jax(step):
    ocfg = OptConfig(lr=3e-3, warmup=20, total_steps=100)
    jcfg = JaxOptConfig(lr=3e-3, warmup=20, total_steps=100)
    want = float(jax_optim.schedule(jcfg, jnp.int32(step)))
    got = float(optim.schedule(ocfg, torch.tensor(step, dtype=torch.int32)))
    assert got == pytest.approx(want, rel=F32, abs=1e-12)


def random_tree(seed, scale=1.0):
    r = np.random.default_rng(seed)
    return {"a": (r.standard_normal((5, 6)) * scale).astype(np.float32),
            "b": {"c": (r.standard_normal((7,)) * scale).astype(np.float32),
                  "d": (r.standard_normal((2, 3, 4)) * scale).astype(
                      np.float32)}}


def to_torch(tree):
    return jax.tree.map(torch.tensor, tree)


def test_global_norm_matches_jax():
    tree = random_tree(0, 3.0)
    want = float(jax_optim.global_norm(tree))
    got = float(optim.global_norm(to_torch(tree)))
    assert got == pytest.approx(want, rel=F32)


@pytest.mark.parametrize("clip", [1.0, 100.0])
def test_update_matches_jax(clip):
    """Three AdamW updates on the same f32 trees: params and moments to
    f32 rounding (decay on the 2-D and 3-D leaves only)."""
    ocfg = dict(lr=1e-2, warmup=2, total_steps=10, clip_norm=clip)
    params, grads = random_tree(1), [random_tree(10 + i, 0.5)
                                     for i in range(3)]
    jp, js = params, jax_optim.init(params)
    tp = to_torch(params)
    ts = opt_init(tp)
    for g in grads:
        jp, js, jm = jax_optim.update(JaxOptConfig(**ocfg), g, jp, js)
        tp, ts, tm = opt_update(OptConfig(**ocfg), to_torch(g), tp, ts)
    for got, want in ((tp, jp), (ts["mu"], js["mu"]), (ts["nu"], js["nu"])):
        for a, b in zip(jax.tree.leaves(jax.tree.map(np.asarray, got)),
                        jax.tree.leaves(np_tree(want))):
            np.testing.assert_allclose(a, b, rtol=F32,
                                       atol=F32 * np.abs(b).max())
    assert int(ts["count"]) == int(js["count"]) == 3
    assert ts["count"].dtype == torch.int32
    assert float(tm["lr"]) == pytest.approx(float(jm["lr"]), rel=F32)
    assert float(tm["grad_norm"]) == pytest.approx(float(jm["grad_norm"]),
                                                   rel=F32)


def test_update_on_a_model_tree_decays_as_jax():
    """On a model's tree the decay follows the JAX leaf: a stacked layer's
    norm scale (a matrix in JAX) decays, the final norm does not."""
    jcfg = jconfigs.get_smoke_config("zamba2-1.2b")
    cfg = get_smoke_config("zamba2-1.2b")
    tree = np_tree(jax_init_model(jcfg, jax.random.PRNGKey(2)))
    grads = jax.tree.map(lambda x: np.full_like(x, 1e-3), tree)
    ocfg = dict(lr=1e-2, warmup=0, total_steps=10, weight_decay=0.5)
    jp, _, _ = jax.jit(lambda g, p, st: jax_optim.update(
        JaxOptConfig(**ocfg), g, p, st))(grads, tree, jax_optim.init(tree))
    params = params_from_jax(cfg, tree, device="cpu")
    gtree = params_from_jax(cfg, grads, device="cpu")
    opt_update(OptConfig(**ocfg), list(gtree.parameters()), params,
               opt_init(params))
    got = params_to_jax(cfg, params)
    for a, b in zip(jax.tree.leaves(got), jax.tree.leaves(np_tree(jp))):
        np.testing.assert_allclose(a, b, rtol=F32, atol=1e-7)
    mask = dict(zip([n for n, _ in params.named_parameters()],
                    optim.decay_mask(params)))
    assert mask["blocks.0.norm1.scale"] and mask["blocks.0.mamba.a_log"]
    assert not mask["final_norm.scale"]
    assert not mask["shared_attn.norm1.scale"] and mask["shared_attn.attn.wq"]


# ---------------------------------------------------------------------------
# launch.train and the example
# ---------------------------------------------------------------------------

def launch_args(ckpt_dir, *extra):
    return ["--smoke", "--device", "cpu", "--steps", "6", "--batch", "2",
            "--seq", "16", "--ckpt-dir", str(ckpt_dir), "--ckpt-every", "2",
            "--log-every", "2", *extra]


def final_arrays(ckpt_dir, step):
    _, arrays = Checkpointer(str(ckpt_dir)).load_arrays(step)
    return arrays


def test_launch_train_restarts_data_exact(tmp_path, capsys):
    """--die-at exits 42 after its checkpoint; the rerun restores and
    finishes; its final checkpoint equals a straight run's bit for bit."""
    assert launch_train.main(launch_args(tmp_path / "a")) == 0
    assert launch_train.main(launch_args(tmp_path / "b", "--die-at",
                                         "3")) == 42
    out = capsys.readouterr().out
    assert "arch=internlm2-1.8b mesh={'data': 1, 'model': 1} devices=1" in out
    assert "simulated failure at step 3; restart me" in out
    assert Checkpointer(str(tmp_path / "b")).latest_step() == 2
    assert launch_train.main(launch_args(tmp_path / "b")) == 0
    out = capsys.readouterr().out
    assert "restored checkpoint at step 2" in out and "done" in out
    assert "step     3 loss=" in out
    a, b = final_arrays(tmp_path / "a", 6), final_arrays(tmp_path / "b", 6)
    assert sorted(a) == sorted(b)
    assert "opt/count" in a and "params/embed/table" in a
    assert "opt/mu/blocks/attn/wq" in a
    assert int(a["opt/count"]) == 6 and a["opt/count"].dtype == np.int32
    for key in a:
        assert np.array_equal(a[key], b[key]), key


def test_launch_train_checkpoint_restores_in_jax(tmp_path):
    assert launch_train.main(launch_args(tmp_path)) == 0
    jcfg = jconfigs.get_smoke_config("internlm2-1.8b")
    j0 = jax_init_model(jcfg, jax.random.PRNGKey(0))
    st, restored = JaxCheckpointer(str(tmp_path)).restore(
        {"params": j0, "opt": jax_opt_init(j0)})
    assert st == 6 and int(restored["opt"]["count"]) == 6


def test_train_lm_example_runs_on_cpu(tmp_path, capsys):
    from repro_torch.examples import train_lm
    assert train_lm.main(["--device", "cpu", "--ckpt-dir",
                          str(tmp_path)]) == 0
    out = capsys.readouterr().out
    assert "step    60 loss=" in out and "done" in out
    assert Checkpointer(str(tmp_path)).latest_step() == 60


def test_train_entry_points_raise_without_gpu(monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        launch_train.main(["--smoke", "--steps", "1", "--ckpt-dir",
                           str(tmp_path)])
