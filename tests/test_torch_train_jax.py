"""The LM stack's training path against the JAX package on the CPU:
the loss's gradients for every smoke architecture, one full train step,
and ``launch.train``-layout checkpoints resumed across the packages,
from JAX's weights (``params_from_jax``) and batches (``make_batch``,
whose tokens are JAX's bit for bit).

Tolerances, each measured first:

* The loss's gradients for every smoke architecture against
  ``jax.value_and_grad``: the activations are bf16 in both and their
  sums run in another order (the logits agree to about 1 % of their RMS,
  ``tests/test_torch_lm.py``).  Measured: the whole tree's relative RMS
  error 0.7-1.6 %, a leaf's 1.2-2.1 %.  Held: ``GRAD_TREE`` 2.5 % for
  the tree, ``GRAD_LEAF`` 3.5 % for a leaf, a key bias's error taken
  against the tree's RMS (its gradient is 0 in exact arithmetic --
  softmax ignores a per-query constant -- and both packages leave
  1e-6 of noise there).  MoE architectures run dropless on the
  positions whose routing is JAX's (a near-tie may route a token the
  other way, as in ``tests/test_torch_lm.py``).
* One train step against JAX's: loss relative 5e-4 (measured 8e-6),
  ``grad_norm`` relative 2e-3 (6e-4), the first moments' tree to
  ``GRAD_TREE``; Adam's first update is about ``lr * sign(g)``, so a
  near-zero gradient whose sign differs moves a parameter by up to
  ``2 lr``: each parameter within ``2.1 lr`` of JAX's, 98 % of them
  within 1e-4 (measured 99.4 %).
* Resumed runs: :func:`resumed_close`.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.ckpt import Checkpointer as JaxCheckpointer
from repro.data import make_batch as jax_make_batch
from repro.models import forward as jax_forward
from repro.models import init_model as jax_init_model
from repro.train import OptConfig as JaxOptConfig
from repro.train import make_loss_fn as jax_make_loss_fn
from repro.train import make_train_step as jax_make_train_step
from repro.train import opt_init as jax_opt_init
from repro.train.step import cross_entropy as jax_cross_entropy
from repro_torch.ckpt import Checkpointer
from repro_torch.configs import ARCH_IDS, SHAPES, get_smoke_config
from repro_torch.data import make_batch
from repro_torch.launch import train as launch_train
from repro_torch.models import forward, init_model
from repro_torch.models.convert import params_from_jax, params_to_jax
from repro_torch.train import (OptConfig, cross_entropy, make_loss_fn,
                               make_train_step, opt_init)
from repro_torch.train import optim
from repro_torch.train.optim import opt_from_jax, opt_to_jax

from test_torch_lm import JaxRouting, routing, same_routing  # noqa: F401
from test_torch_lm import smoke_batch as lm_smoke_batch
from test_torch_train import B, F32, S, np_tree, run_steps

GRAD_TREE, GRAD_LEAF = 0.025, 0.035


@pytest.fixture(autouse=True)
def few_threads():
    """Two torch threads a test: the suite runs several test processes
    side by side."""
    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 2))
    yield
    torch.set_num_threads(n)


def torch_batch(batch):
    return {k: torch.tensor(np.asarray(v)) for k, v in batch.items()}


def rel_rms(got, want):
    return float(np.sqrt(((got - want) ** 2).mean())
                 / max(np.sqrt((want ** 2).mean()), 1e-30))


def grad_errors(got_tree, want_tree):
    """(the tree's relative RMS error, the worst leaf's).  A key bias's
    error is taken relative to the tree's RMS: its gradient is 0 in exact
    arithmetic (softmax ignores a per-query constant) and both packages
    leave rounding noise there."""
    got = jax.tree.leaves(got_tree)
    want = jax.tree_util.tree_flatten_with_path(want_tree)[0]
    assert len(got) == len(want)
    sq = sum(float(((g - w) ** 2).sum()) for g, (_, w) in zip(got, want))
    norm = sum(float((w ** 2).sum()) for _, w in want)
    tree_rms = np.sqrt(norm / sum(w.size for _, w in want))
    worst = max(np.sqrt(((g - w) ** 2).mean())
                / (tree_rms if path[-1].key == "bk"
                   else np.sqrt((w ** 2).mean()))
                for g, (path, w) in zip(got, want))
    return float(np.sqrt(sq / norm)), float(worst)


def smoke_batch(cfg, seed):
    """test_torch_lm's batch with labels."""
    batch = lm_smoke_batch(cfg, seed)
    batch["labels"] = np.random.default_rng(seed + 1).integers(
        0, cfg.vocab, (B, S)).astype(np.int32)
    return batch


def masked_loss(fwd, ce, where, aux_weight):
    """The loss over the positions ``where`` (a static mask), MoE dropless:
    a token routed the other way reaches only its own and later positions
    of its sequence, which ``where`` leaves out."""
    def loss_fn(params, batch):
        logits, aux = fwd(params, batch)
        loss = ce(logits[where][None], batch["labels"][where][None])
        return loss + aux_weight * aux, (loss, aux)
    return loss_fn


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_loss_gradients_match_jax(arch, routing):
    """make_loss_fn's value and gradients against jax.value_and_grad of
    JAX's, from JAX's weights (remat on, as in training)."""
    jcfg, cfg = jconfigs.get_smoke_config(arch), get_smoke_config(arch)
    jparams = jax_init_model(jcfg, jax.random.PRNGKey(0))
    batch = smoke_batch(cfg, 1)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    params = params_from_jax(cfg, np_tree(jparams), device="cpu")
    for p in params.parameters():
        p.requires_grad_(True)
    tb = torch_batch(batch)
    if cfg.family == "moe":
        with JaxRouting() as jr:
            jax_forward(jcfg, jparams, jb, dropless_moe=True)
            jax_routes = jr.take()
        with torch.no_grad():
            forward(cfg, params, tb, dropless_moe=True)
        where = same_routing(routing, jax_routes, (B, S))
        assert where.sum() >= S
        aux_w = 0.01 if where.all() else 0.0
        jloss = masked_loss(lambda p, b: jax_forward(
            jcfg, p, b, dropless_moe=True), jax_cross_entropy, where, aux_w)
        loss_fn = masked_loss(lambda p, b: forward(
            cfg, p, b, dropless_moe=True), cross_entropy,
            torch.tensor(where), aux_w)
    else:
        jloss, loss_fn = jax_make_loss_fn(jcfg), make_loss_fn(cfg)
        aux_w = 0.01
    (jt, (jl, ja)), jg = jax.value_and_grad(jloss, has_aux=True)(jparams, jb)
    total, (loss, aux) = loss_fn(params, tb)
    total.backward()
    assert float(loss.detach()) == pytest.approx(float(jl), rel=1e-3)
    if aux_w:       # an MoE aux counts every token's route
        assert float(aux.detach()) == pytest.approx(float(ja), rel=1e-3,
                                                    abs=1e-6)
    grads = params_to_jax(cfg, optim.tree_map(lambda p: p.grad, params))
    tree_err, leaf_err = grad_errors(grads, np_tree(jg))
    assert tree_err <= GRAD_TREE and leaf_err <= GRAD_LEAF, (tree_err,
                                                             leaf_err)


def test_train_step_matches_jax():
    arch = "internlm2-1.8b"
    jcfg, cfg = jconfigs.get_smoke_config(arch), get_smoke_config(arch)
    jparams = jax_init_model(jcfg, jax.random.PRNGKey(0))
    ocfg = dict(lr=1e-2, warmup=5, total_steps=100)
    batch = jax_make_batch(jcfg, SHAPES["train_4k"], step=0, seed=1,
                           batch_override=4, seq_override=32)
    jp, jo, jm = jax.jit(jax_make_train_step(jcfg, JaxOptConfig(**ocfg)))(
        jparams, jax_opt_init(jparams), batch)
    params = params_from_jax(cfg, np_tree(jparams), device="cpu")
    opt = opt_init(params)
    params, opt, m = make_train_step(cfg, OptConfig(**ocfg))(
        params, opt, torch_batch(batch))
    assert float(m["loss"]) == pytest.approx(float(jm["loss"]), rel=5e-4)
    assert float(m["grad_norm"]) == pytest.approx(float(jm["grad_norm"]),
                                                  rel=2e-3)
    assert float(m["lr"]) == pytest.approx(float(jm["lr"]), rel=F32)
    state = opt_to_jax(cfg, opt)
    assert jax.tree.structure(state) == jax.tree.structure(np_tree(jo))
    tree_err, _ = grad_errors(state["mu"], np_tree(jo["mu"]))
    assert tree_err <= GRAD_TREE, tree_err
    lr = float(jm["lr"])
    for a, b in zip(jax.tree.leaves(params_to_jax(cfg, params)),
                    jax.tree.leaves(np_tree(jp))):
        np.testing.assert_allclose(a, b, atol=2.1 * lr, rtol=0)
        assert np.mean(np.abs(a - b) < 1e-4) > 0.98


# ---------------------------------------------------------------------------
# checkpoints across the packages (launch.train's layout)
# ---------------------------------------------------------------------------

RESUME_OPT = dict(lr=1e-2, warmup=2, total_steps=20)


def jax_steps(jcfg, jp, jo, start, n):
    step = jax.jit(jax_make_train_step(jcfg, JaxOptConfig(**RESUME_OPT)))
    losses = []
    for i in range(start, start + n):
        batch = jax_make_batch(jcfg, SHAPES["train_4k"], step=i, seed=5,
                               batch_override=2, seq_override=16)
        jp, jo, m = step(jp, jo, batch)
        losses.append(float(m["loss"]))
    return jp, jo, losses


def resumed_close(got_params, want_params, got_losses, want_losses):
    """5 steps after the resume against 10 straight ones: every loss to
    1e-3 relative, the parameters' change over the 10 steps to 5 % of
    its RMS (Adam's near-zero gradients may take the other sign), each
    parameter within 5 x 2.1 lr."""
    np.testing.assert_allclose(got_losses, want_losses, rtol=1e-3)
    assert rel_rms_tree(got_params, want_params) <= 0.05


def rel_rms_tree(got, want):
    return rel_rms(np.concatenate([x.ravel() for x in jax.tree.leaves(got)]),
                   np.concatenate([x.ravel() for x in jax.tree.leaves(want)]))


def test_jax_checkpoint_resumes_in_port(tmp_path):
    arch = "internlm2-1.8b"
    jcfg, cfg = jconfigs.get_smoke_config(arch), get_smoke_config(arch)
    j0 = jax_init_model(jcfg, jax.random.PRNGKey(0))
    j10, _, want_losses = jax_steps(jcfg, j0, jax_opt_init(j0), 0, 10)
    j5, o5, _ = jax_steps(jcfg, j0, jax_opt_init(j0), 0, 5)
    JaxCheckpointer(str(tmp_path)).save(5, {"params": j5, "opt": o5})

    template_params = init_model(cfg, 0, device="cpu")
    ck = Checkpointer(str(tmp_path))
    assert ck.latest_step() == 5
    step5, restored = ck.restore(launch_train.state_tree(
        cfg, template_params, opt_init(template_params)))
    params = params_from_jax(cfg, restored["params"], device="cpu")
    opt = opt_from_jax(cfg, restored["opt"], device="cpu")
    assert int(opt["count"]) == 5
    step = make_train_step(cfg, OptConfig(**RESUME_OPT))
    losses = []
    for i in range(5, 10):
        batch = make_batch(cfg, SHAPES["train_4k"], step=i, seed=5,
                           batch_override=2, seq_override=16, device="cpu")
        params, opt, m = step(params, opt, batch)
        losses.append(float(m["loss"]))
    change = jax.tree.map(lambda a, b: a - b, params_to_jax(cfg, params),
                          np_tree(j0))
    want = jax.tree.map(lambda a, b: a - b, np_tree(j10), np_tree(j0))
    resumed_close(change, want, losses, want_losses[5:])


def test_port_checkpoint_resumes_in_jax(tmp_path):
    arch = "internlm2-1.8b"
    jcfg, cfg = jconfigs.get_smoke_config(arch), get_smoke_config(arch)
    tree0 = np_tree(jax_init_model(jcfg, jax.random.PRNGKey(1)))
    step = make_train_step(cfg, OptConfig(**RESUME_OPT))
    p10 = params_from_jax(cfg, tree0, device="cpu")
    p10, _, straight = run_steps(cfg, step, p10, opt_init(p10), 0, 10)
    p5 = params_from_jax(cfg, tree0, device="cpu")
    p5, o5, _ = run_steps(cfg, step, p5, opt_init(p5), 0, 5)
    Checkpointer(str(tmp_path)).save(5, launch_train.state_tree(cfg, p5, o5))

    j0 = jax_init_model(jcfg, jax.random.PRNGKey(1))
    st, restored = JaxCheckpointer(str(tmp_path)).restore(
        {"params": j0, "opt": jax_opt_init(j0)})
    assert st == 5 and int(restored["opt"]["count"]) == 5
    jp, _, losses = jax_steps(jcfg, restored["params"], restored["opt"], 5, 5)
    change = jax.tree.map(lambda a, b: a - b, np_tree(jp), tree0)
    want = jax.tree.map(lambda a, b: a - b, params_to_jax(cfg, p10), tree0)
    resumed_close(change, want, losses, straight[5:])


