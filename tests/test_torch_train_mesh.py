"""The LM train step on a mesh of several shards against the JAX
package's step on the CPU: parameters laid out by JAX's specs
(``repro_torch.train.sharding.place``), each microbatch's rows cut over
the shards, each layer gathered whole on a shard and its gradient cut
back onto the pieces (``repro_torch.models.shards``).  From JAX's
weights (``params_from_jax``) and batches (``make_batch``).

Tolerances, each measured first:

* The ten smoke architectures, one step on the (2, 2) and (4, 1) CPU
  debug meshes, FSDP off and on, against JAX's one-device step: the
  bounds of ``tests/test_torch_train_jax.py``: loss 5e-4 relative
  (measured at most 4.9e-5), ``grad_norm`` 2e-3 (1.43e-3), each
  parameter within ``2.1 lr`` (measured 2.0 lr: Adam's first update is
  about ``lr * sign(g)``, so a near-zero gradient of the other sign
  moves a parameter by ``2 lr``), 98 % of them within 1e-4 (measured at
  least 99.34 %).  MoE architectures run dropless on the positions that
  JAX and the port route alike, as there.
* Against the port's one-shard step: loss 1e-5 relative (measured
  8.6e-8), aux 1e-5 (2.4e-7 absolute), ``grad_norm`` 1e-4 (1.34e-5),
  each parameter within ``2.1 lr`` (2.0 lr), 99 % within 1e-6 (measured
  at least 99.33 %); 6 rows on 4 shards and 2 rows on 4 shards the same.
* Against JAX's own (2, 2) step on four forced host devices, 3 steps of
  ``internlm2-1.8b`` and ``deepseek-moe-16b`` at 8 x 32: each loss 1e-3
  relative (measured 8.8e-5 and 4.0e-4); ``grad_norm`` 2e-3 at the
  first step (7.1e-4 and 2.4e-4) and 2e-2 after it (4.9e-3 and
  1.25e-2: once Adam's first update has moved the near-zero gradients'
  parameters by ``+-lr`` either way, the gradients part by about 1 %;
  JAX's own (2, 2) and one-device runs part by 9.0e-3 there, the port's
  one-shard and (2, 2) runs by 8.7e-3); the parameters' change over the
  3 steps to JAX's within ``CHANGE_TOL`` of its RMS, 0.1 and 0.45
  (measured 0.055 and 0.289; the port's one-shard run against JAX's
  one-device run 0.054 and 0.301, the same sign flips, and for the MoE
  tokens whose routing a near-tie turns).
* Microbatches on a mesh against the full batch on it: the bounds of
  ``tests/test_torch_train.py``'s test (loss 1e-4, measured 0;
  ``grad_norm`` 1e-3, 1.2e-5; 2.1 lr; 99 % within 1e-4, 99.90 %).
* Exact: each piece's gradient is the sum of its shards' cuts in shard
  order, bit for bit (so a step on several cards repeats); replicated
  copies stay equal; a ``--die-at`` restart on a CPU mesh.
"""
import json
import os
import subprocess
import sys
import textwrap

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
from repro.train import make_train_step as jax_make_train_step
from repro.train import opt_init as jax_opt_init
from repro.train.step import cross_entropy as jax_cross_entropy
from repro_torch.ckpt import Checkpointer
from repro_torch.configs import ARCH_IDS, SHAPES, get_smoke_config
from repro_torch.data import make_batch
from repro_torch.launch import roofline
from repro_torch.launch import train as launch_train
from repro_torch.launch.mesh import make_debug_mesh
from repro_torch.models import forward, init_model
from repro_torch.models import moe as lm_moe
from repro_torch.models.convert import params_from_jax, params_to_jax
from repro_torch.models.model import forward_parts
from repro_torch.models.shards import Sharded, weigh
from repro_torch.train import (OptConfig, cross_entropy, make_loss_fn,
                               make_prefill_step, make_train_step, opt_init)
from repro_torch.train import optim
from repro_torch.train.optim import opt_from_jax, opt_to_jax
from repro_torch.train.sharding import param_shardings, place
from repro_torch.train.step import split_rows

from test_torch_lm import JaxRouting, same_routing
from test_torch_train import np_tree

OCFG = dict(lr=1e-2, warmup=5, total_steps=100)
LR1 = 1e-2 / 5          # the first step's learning rate
MESHES = [(2, 2), (4, 1)]
SRC = os.path.join(os.path.dirname(__file__), "..", "src")


@pytest.fixture(autouse=True)
def few_threads():
    """Two torch threads a test: the suite runs several test processes
    side by side."""
    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 2))
    yield
    torch.set_num_threads(n)


def cpu_mesh(shape):
    return make_debug_mesh(n_devices=shape[0] * shape[1], model=shape[1],
                           device="cpu")


def on_mesh(cfg, tree, shape, fsdp=False):
    """JAX's tree laid out on a CPU debug mesh of ``shape``."""
    mesh = cpu_mesh(shape)
    template = init_model(cfg, device="meta")
    return params_from_jax(cfg, tree, shardings=param_shardings(
        cfg, template, mesh, fsdp=fsdp)), mesh


def torch_batch(batch):
    """JAX's batch as tensors (its bf16 arrays through f32, exactly)."""
    out = {}
    for k, v in batch.items():
        v = np.asarray(v)
        out[k] = (torch.tensor(v.astype(np.float32)).to(torch.bfloat16)
                  if v.dtype.name == "bfloat16" else torch.tensor(v))
    return out


def close_params(got, want, lr, within, share):
    """Each parameter within 2.1 lr, ``share`` of them within
    ``within``."""
    got, want = jax.tree.leaves(got), jax.tree.leaves(want)
    assert len(got) == len(want)
    near = []
    for a, b in zip(got, want):
        np.testing.assert_allclose(a, b, atol=2.1 * lr, rtol=0)
        near.append((np.abs(a - b) < within).ravel())
    assert np.mean(np.concatenate(near)) >= share


def mesh_routes(cfg, params, batch):
    """The experts the port's forward picks on a mesh, a call of JAX's
    routing each: the parts' picks of one layer, rows in order."""
    calls, route = [], lm_moe._route

    def recording(p, x, top_k):
        out = route(p, x, top_k)
        calls.append(out[2].reshape(-1, top_k).numpy())
        return out
    lm_moe._route = recording
    try:
        with torch.no_grad():
            parts = split_rows(params, batch)
            forward_parts(cfg, params, parts, dropless_moe=True)
    finally:
        lm_moe._route = route
    n = len(parts)
    # each MoE layer routes every part twice: across_parts, then its body
    per_layer = 2 * n if n > 1 else 1
    return [np.concatenate(calls[i:i + n])
            for i in range(0, len(calls), per_layer)]


def masked_mesh_loss(cfg, where, aux_weight):
    """The loss over the positions ``where`` (B, S) on a mesh, MoE
    dropless: each part's masked CE weighted by its share of them."""
    def loss_fn(params, batch):
        parts = split_rows(params, batch)
        outs = forward_parts(cfg, params, parts, dropless_moe=True)
        cut = torch.tensor_split(where, params.mesh.size)
        device = params.mesh.device_of(0)
        loss = 0.0
        for (i, part), (logits, _) in zip(parts, outs):
            m = cut[i]
            if m.any():
                loss = loss + cross_entropy(
                    logits[m][None], part["labels"][m][None]).to(device) \
                    * (int(m.sum()) / int(where.sum()))
        aux = weigh(parts, [a for _, a in outs], len(batch["labels"]),
                    device)
        return loss + aux_weight * aux, (loss, aux)
    return loss_fn


def jax_masked_loss(jcfg, where, aux_weight):
    def loss_fn(params, batch):
        logits, aux = jax_forward(jcfg, params, batch, dropless_moe=True)
        loss = jax_cross_entropy(logits[where][None],
                                 batch["labels"][where][None])
        return loss + aux_weight * aux, (loss, aux)
    return loss_fn


# ---------------------------------------------------------------------------
# one step of every architecture against JAX's one-device step
# ---------------------------------------------------------------------------

_JAX = {}


def jax_inputs(arch):
    """JAX's weights from PRNGKey(0) (initialised under jit: the eager
    initialisation of the MoE trees takes tens of seconds) and
    make_batch's 4 x 32 batch."""
    if arch not in _JAX:
        jcfg = jconfigs.get_smoke_config(arch)
        init = jax.jit(lambda k: jax_init_model(jcfg, k))
        _JAX[arch] = (np_tree(init(jax.random.PRNGKey(0))),
                      jax_make_batch(jcfg, SHAPES["train_4k"], step=0,
                                     seed=1, batch_override=4,
                                     seq_override=32))
    return _JAX[arch]


def jax_step(arch, where=None, aux_weight=0.01):
    """JAX's one-device step on :func:`jax_inputs` (a masked, dropless
    loss where ``where`` is given): its parameters and metrics, cached."""
    key = (arch, None if where is None else where.tobytes(), aux_weight)
    if key not in _JAX:
        jcfg = jconfigs.get_smoke_config(arch)
        tree0, batch = jax_inputs(arch)
        jparams = jax.tree.map(jnp.asarray, tree0)
        loss_fn = None if where is None else jax_masked_loss(
            jcfg, where, aux_weight)
        jp, _, jm = jax.jit(jax_make_train_step(
            jcfg, JaxOptConfig(**OCFG), loss_fn=loss_fn))(
            jparams, jax_opt_init(jparams), batch)
        _JAX[key] = (np_tree(jp), {k: float(v) for k, v in jm.items()})
    return _JAX[key]


def jax_routes(arch, jparams, batch):
    jcfg = jconfigs.get_smoke_config(arch)
    with JaxRouting() as jr:
        jax.jit(lambda p, b: jax_forward(jcfg, p, b, dropless_moe=True))(
            jax.tree.map(jnp.asarray, jparams),
            {k: jnp.asarray(v) for k, v in batch.items()})
        return jr.take()


@pytest.mark.parametrize("fsdp", [False, True], ids=["tp", "fsdp"])
@pytest.mark.parametrize("shape", MESHES, ids=["2x2", "4x1"])
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_mesh_step_matches_jax(arch, shape, fsdp):
    cfg = get_smoke_config(arch)
    tree0, batch = jax_inputs(arch)
    params, mesh = on_mesh(cfg, tree0, shape, fsdp)
    assert isinstance(params, Sharded) and params.mesh == mesh
    tb = torch_batch(batch)
    loss_fn = None
    where, aux_w = None, 0.01
    if cfg.family == "moe":
        where = same_routing(mesh_routes(cfg, params, tb),
                             jax_routes(arch, tree0, batch),
                             tb["labels"].shape)
        assert where.sum() >= tb["labels"].shape[1]
        aux_w = 0.01 if where.all() else 0.0
        loss_fn = masked_mesh_loss(cfg, torch.tensor(where), aux_w)
    jp, jm = jax_step(arch, where, aux_w)
    step = make_train_step(cfg, OptConfig(**OCFG), mesh=mesh,
                           loss_fn=loss_fn)
    params, opt, m = step(params, opt_init(params), tb)
    assert float(m["loss"]) == pytest.approx(jm["loss"], rel=5e-4)
    assert float(m["grad_norm"]) == pytest.approx(jm["grad_norm"], rel=2e-3)
    assert float(m["lr"]) == pytest.approx(jm["lr"], rel=2e-6)
    close_params(params_to_jax(cfg, params), jp, jm["lr"], 1e-4, 0.98)


# ---------------------------------------------------------------------------
# against the port's one-shard step
# ---------------------------------------------------------------------------

def one_and_mesh(arch, shape=(2, 2), fsdp=True, rows=4, microbatches=1,
                 seed=1):
    """One step on one device and on a CPU mesh from the same weights and
    batch: ((params, metrics) one shard, (params, opt, metrics) mesh)."""
    cfg = get_smoke_config(arch)
    tree = params_to_jax(cfg, init_model(cfg, 3, device="cpu"))
    batch = make_batch(cfg, SHAPES["train_4k"], step=0, seed=seed,
                       batch_override=rows, seq_override=32, device="cpu")
    one = params_from_jax(cfg, tree, device="cpu")
    one, _, m1 = make_train_step(cfg, OptConfig(**OCFG))(one, opt_init(one),
                                                          batch)
    params, mesh = on_mesh(cfg, tree, shape, fsdp)
    opt = opt_init(params)
    params, opt, mm = make_train_step(cfg, OptConfig(**OCFG), mesh=mesh,
                                      microbatches=microbatches)(
        params, opt, batch)
    return cfg, (one, m1), (params, opt, mm)


def assert_one_shard(cfg, one, mesh_run):
    (p1, m1), (pm, _, mm) = one, mesh_run
    assert float(mm["loss"]) == pytest.approx(float(m1["loss"]), rel=1e-5)
    assert float(mm["aux"]) == pytest.approx(float(m1["aux"]), rel=1e-5,
                                             abs=1e-7)
    assert float(mm["grad_norm"]) == pytest.approx(float(m1["grad_norm"]),
                                                   rel=1e-4)
    close_params(params_to_jax(cfg, pm), params_to_jax(cfg, p1), LR1, 1e-6,
                 0.99)


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_mesh_step_matches_one_shard(arch):
    cfg, one, mesh_run = one_and_mesh(arch)
    assert_one_shard(cfg, one, mesh_run)


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_forward_and_prefill_on_a_mesh(arch):
    """``forward`` and ``make_prefill_step`` of a tree on a (2, 2) mesh
    compute each shard's rows (6 rows: blocks of 2, 2, 1, 1) and equal
    the one-device forward: logits within 1e-6 of their RMS and aux 1e-6
    relative (measured 0: the same ops on each row), in the training
    and the per-sequence (inference) MoE layouts; in the per-sequence
    layout the aux is each part's own, weighted by its rows."""
    cfg = get_smoke_config(arch)
    one = init_model(cfg, 2, device="cpu")
    params = place(one, param_shardings(cfg, one, cpu_mesh((2, 2))))
    batch = make_batch(cfg, SHAPES["prefill_32k"], batch_override=6,
                       seq_override=32, device="cpu")
    batch.pop("labels")
    assert len(split_rows(params, batch)) == 4
    with torch.no_grad():
        for remat in (True, False):
            want, want_aux = forward(cfg, one, batch, remat=remat)
            got, aux = forward(cfg, params, batch, remat=remat)
            rms = float(want.pow(2).mean().sqrt())
            assert float((got - want).abs().max()) <= 1e-6 * rms
            if not remat:
                parts = split_rows(params, batch)
                want_aux = weigh(parts, [
                    forward(cfg, one, part, remat=False)[1]
                    for _, part in parts], 6, "cpu")
            assert float(aux) == pytest.approx(float(want_aux), rel=1e-6,
                                               abs=1e-9)
    got = make_prefill_step(cfg)(params, batch)
    assert float((got - want).abs().max()) <= 1e-6 * rms


def test_uneven_batch_on_four_shards():
    """6 rows on 4 shards: blocks of 2, 2, 1 and 1 rows."""
    cfg, one, mesh_run = one_and_mesh("internlm2-1.8b", rows=6)
    params = mesh_run[0]
    batch = make_batch(cfg, SHAPES["train_4k"], batch_override=6,
                       seq_override=32, device="cpu")
    parts = split_rows(params, batch)
    assert [(i, len(p["tokens"])) for i, p in parts] == [(0, 2), (1, 2),
                                                         (2, 1), (3, 1)]
    assert_one_shard(cfg, one, mesh_run)


def test_a_shard_without_rows_computes_nothing():
    """2 rows on 4 shards: shards 2 and 3 compute nothing, and their
    pieces still take the step."""
    cfg, one, mesh_run = one_and_mesh("deepseek-moe-16b", rows=2)
    params = mesh_run[0]
    batch = make_batch(cfg, SHAPES["train_4k"], batch_override=2,
                       seq_override=32, device="cpu")
    assert [i for i, _ in split_rows(params, batch)] == [0, 1]
    assert_one_shard(cfg, one, mesh_run)


def test_microbatches_on_a_mesh_equal_the_full_batch():
    cfg, _, full = one_and_mesh("internlm2-1.8b", rows=8, seed=2)
    _, _, micro = one_and_mesh("internlm2-1.8b", rows=8, seed=2,
                               microbatches=2)
    (pf, _, mf), (pm, _, mm) = full, micro
    assert abs(float(mf["loss"]) - float(mm["loss"])) < 1e-4
    assert abs(float(mf["grad_norm"]) - float(mm["grad_norm"])) < 1e-3
    close_params(params_to_jax(cfg, pm), params_to_jax(cfg, pf), LR1, 1e-4,
                 0.99)


def test_moe_capacity_drops_the_one_shard_tokens(monkeypatch):
    """deepseek-moe-16b at a batch where capacity drops picks: the mesh
    drops those that the one-shard step drops (JAX's global cumsum and
    capacity), which a capacity of each shard's own tokens would not;
    its logits and aux are then the one-shard forward's."""
    cfg = get_smoke_config("deepseek-moe-16b")
    tree = params_to_jax(cfg, init_model(cfg, 5, device="cpu"))
    batch = make_batch(cfg, SHAPES["train_4k"], seed=3, batch_override=8,
                       seq_override=32, device="cpu")
    one = params_from_jax(cfg, tree, device="cpu")
    params, _ = on_mesh(cfg, tree, (2, 2))
    calls = []
    route = lm_moe._route

    def recording(p, x, top_k):
        out = route(p, x, top_k)
        calls.append(out[2].reshape(-1, top_k).numpy())
        return out
    monkeypatch.setattr(lm_moe, "_route", recording)
    with torch.no_grad():
        logits1, aux1 = forward(cfg, one, batch)
        n_layers = len(calls)
        outs = forward_parts(cfg, params, split_rows(params, batch))
    e, k, t = cfg.n_routed, cfg.top_k, 8 * 32
    cap = int((k * t * 1.25) / e) + 1
    local_cap = int((k * (t // 4) * 1.25) / e) + 1

    def slots(experts):
        onehot = np.eye(e, dtype=int)[experts.reshape(-1)]
        return (np.cumsum(onehot, 0) * onehot).max(-1) - 1

    dropped = differs = 0
    for layer in range(n_layers):
        experts = calls[layer]
        kept = slots(experts) < cap
        dropped += int((~kept).sum())
        own = np.concatenate([slots(b) < local_cap
                              for b in np.split(experts, 4)])
        differs += int((own != kept).sum())
        # the parts' picks in the mesh forward are the one-shard picks
        at = n_layers + 8 * layer
        np.testing.assert_array_equal(np.concatenate(calls[at:at + 4]),
                                      experts)
        np.testing.assert_array_equal(np.concatenate(calls[at + 4:at + 8]),
                                      experts)
    assert differs > 0
    assert dropped > 0
    logits = torch.cat([lg for lg, _ in outs])
    rms = float(logits1.pow(2).mean().sqrt())
    assert float((logits - logits1).abs().max()) <= 1e-4 * rms
    aux = sum(a * 0.25 for _, a in outs)
    assert float(aux) == pytest.approx(float(aux1), rel=1e-5)


# ---------------------------------------------------------------------------
# the layout: pieces, bytes, replicated copies, the norm
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("fsdp", [False, True], ids=["tp", "fsdp"])
def test_pieces_are_their_index_slices(fsdp):
    """Each piece is its ``NamedSharding.index`` slice of the whole leaf,
    on ``mesh.device_of(i)``, a storage of its own; a shard's parameter
    and AdamW bytes are ``memory_per_device``'s argument bytes."""
    cfg = get_smoke_config("deepseek-v2-lite-16b")
    whole = init_model(cfg, 1, device="cpu")
    mesh = cpu_mesh((2, 2))
    sh = param_shardings(cfg, whole, mesh, fsdp=fsdp)
    params = place(whole, sh)
    opt = opt_init(params)
    assert isinstance(params, Sharded) and len(params.pieces) == 4
    ptrs = set()
    split = 0
    for i, tree in enumerate(params.pieces):
        for name, piece in tree.named_parameters():
            path = name.replace(".", "/")
            leaf = whole.get_parameter(name)
            assert piece.device == mesh.device_of(i)
            assert torch.equal(piece, leaf[sh[path].index(i, leaf.shape)])
            assert piece.data_ptr() not in ptrs
            ptrs.add(piece.data_ptr())
            split += piece.shape != leaf.shape
        state = [(s, whole.get_parameter(p.replace("/", ".")))
                 for p, s in sh.items()] * 3
        got = sum(x.numel() * x.element_size() for t in (
            tree, opt["mu"].pieces[i], opt["nu"].pieces[i])
            for x in t.parameters())
        assert got == roofline.memory_per_device(state)[
            "argument_size_in_bytes"]
    assert split > 0


def test_replicated_copies_stay_equal():
    """3 steps of deepseek-moe-16b on (2, 2): every block's copies (its
    parameters and moments) are equal bit for bit."""
    cfg = get_smoke_config("deepseek-moe-16b")
    params, mesh = on_mesh(cfg, params_to_jax(
        cfg, init_model(cfg, 2, device="cpu")), (2, 2))
    opt = opt_init(params)
    step = make_train_step(cfg, OptConfig(**OCFG), mesh=mesh)
    for i in range(3):
        params, opt, m = step(params, opt, make_batch(
            cfg, SHAPES["train_4k"], step=i, batch_override=4,
            seq_override=16, device="cpu"))
    copies = 0
    for tree in (params, opt["mu"], opt["nu"]):
        for path, holders in tree.holders.items():
            for first, *others in holders.values():
                for i in others:
                    assert torch.equal(tree._leaf[i][path],
                                       tree._leaf[first][path]), path
                    copies += 1
    assert copies > 0


@pytest.mark.parametrize("fsdp", [False, True], ids=["tp", "fsdp"])
def test_a_piece_sums_its_cuts_in_shard_order(fsdp):
    """Each piece's gradient is, bit for bit, the sum over the shards in
    their order of what each shard's rows alone give it: the order does
    not hang on which card's autograd thread comes first, so a step on
    several cards repeats bit for bit.  The reverse order gives other
    bits somewhere, so the check can tell the orders apart."""
    cfg = get_smoke_config("internlm2-1.8b")
    params, mesh = on_mesh(cfg, params_to_jax(
        cfg, init_model(cfg, 4, device="cpu")), (2, 2), fsdp)
    batch = make_batch(cfg, SHAPES["train_4k"], batch_override=4,
                       seq_override=32, device="cpu")
    plist = optim.leaves(params)
    for p in plist:
        p.requires_grad_(True)

    def grads(total):
        total.backward()
        out = [p.grad for p in plist]
        for p in plist:
            p.grad = None
        return out
    whole = grads(make_loss_fn(cfg, mesh=mesh)(params, batch)[0])
    parts = split_rows(params, batch)
    alone = []
    for part in parts:
        ((logits, _),) = forward_parts(cfg, params, [part])
        alone.append(grads(cross_entropy(logits, part[1]["labels"])
                           * (len(part[1]["labels"]) / 4)))
    forward_sum = [sum(g[k] for g in alone) for k in range(len(plist))]
    reverse_sum = [sum(g[k] for g in alone[::-1]) for k in range(len(plist))]
    for got, want in zip(whole, forward_sum):
        assert torch.equal(got, want)
    assert not all(torch.equal(a, b) for a, b in zip(whole, reverse_sum))


def test_global_norm_counts_a_replicated_leaf_once():
    cfg = get_smoke_config("internlm2-1.8b")
    whole = init_model(cfg, 4, device="cpu")
    sharded = place(whole, param_shardings(cfg, whole, cpu_mesh((2, 2))))
    want = optim.global_norm(whole)
    got = optim.global_norm(sharded, optim.counted(sharded))
    assert float(got) == pytest.approx(float(want), rel=1e-6)
    # every piece counted: the replicated leaves and copies twice or more
    assert float(optim.global_norm(sharded)) > 1.2 * float(want)


def test_a_mesh_step_refuses_an_unplaced_tree():
    cfg = get_smoke_config("internlm2-1.8b")
    whole = init_model(cfg, 0, device="cpu")
    batch = make_batch(cfg, SHAPES["train_4k"], batch_override=4,
                       seq_override=16, device="cpu")
    step = make_train_step(cfg, OptConfig(), mesh=cpu_mesh((2, 2)))
    with pytest.raises(ValueError, match="placed on it"):
        step(whole, opt_init(whole), batch)
    other = place(whole, param_shardings(cfg, whole, cpu_mesh((4, 1))))
    with pytest.raises(ValueError, match="placed on it"):
        step(other, opt_init(other), batch)


# ---------------------------------------------------------------------------
# checkpoints and launch.train
# ---------------------------------------------------------------------------

def test_checkpoints_cross_meshes_and_packages(tmp_path):
    """A (2, 2) mesh's checkpoint has JAX's layout: JAX and the one-shard
    port restore it, equal to the gathered state; restored onto the mesh
    it takes the uninterrupted run's next step bit for bit; a one-shard
    checkpoint restores onto a (4, 1) mesh, each piece its slice."""
    cfg = get_smoke_config("internlm2-1.8b")
    tree = params_to_jax(cfg, init_model(cfg, 6, device="cpu"))
    params, mesh = on_mesh(cfg, tree, (2, 2), fsdp=True)
    sh = param_shardings(cfg, init_model(cfg, device="meta"), mesh,
                         fsdp=True)
    opt = opt_init(params)
    step = make_train_step(cfg, OptConfig(**OCFG), mesh=mesh)
    batches = [make_batch(cfg, SHAPES["train_4k"], step=i, batch_override=4,
                          seq_override=16, device="cpu") for i in range(3)]
    for b in batches[:2]:
        params, opt, _ = step(params, opt, b)
    saved = launch_train.state_tree(cfg, params, opt)
    Checkpointer(str(tmp_path / "mesh")).save(2, saved)
    params, opt, _ = step(params, opt, batches[2])
    straight = launch_train.state_tree(cfg, params, opt)

    # JAX restores it
    j0 = jax_init_model(jconfigs.get_smoke_config("internlm2-1.8b"),
                        jax.random.PRNGKey(0))
    st, restored = JaxCheckpointer(str(tmp_path / "mesh")).restore(
        {"params": j0, "opt": jax_opt_init(j0)})
    assert st == 2
    for a, b in zip(jax.tree.leaves(np_tree(restored)),
                    jax.tree.leaves(saved)):
        assert np.array_equal(a, b)

    # the one-shard port and the mesh restore it
    ck = Checkpointer(str(tmp_path / "mesh"))
    _, restored = ck.restore(saved)
    one = params_from_jax(cfg, restored["params"], device="cpu")
    assert all(np.array_equal(a, b) for a, b in zip(
        jax.tree.leaves(params_to_jax(cfg, one)),
        jax.tree.leaves(saved["params"])))
    pr = params_from_jax(cfg, restored["params"], shardings=sh)
    orr = opt_from_jax(cfg, restored["opt"], shardings=sh)
    assert int(orr["count"]) == 2 and isinstance(orr["mu"], Sharded)
    pr, orr, _ = step(pr, orr, batches[2])
    again = launch_train.state_tree(cfg, pr, orr)
    for a, b in zip(jax.tree.leaves(again), jax.tree.leaves(straight)):
        assert np.array_equal(a, b)

    # a one-shard checkpoint onto a (4, 1) mesh
    Checkpointer(str(tmp_path / "one")).save(
        2, launch_train.state_tree(cfg, one, opt_from_jax(
            cfg, restored["opt"], device="cpu")))
    _, back = Checkpointer(str(tmp_path / "one")).restore(saved)
    mesh41 = cpu_mesh((4, 1))
    sh41 = param_shardings(cfg, init_model(cfg, device="meta"), mesh41)
    p41 = params_from_jax(cfg, back["params"], shardings=sh41)
    o41 = opt_to_jax(cfg, opt_from_jax(cfg, back["opt"], shardings=sh41))
    whole = params_from_jax(cfg, back["params"], device="cpu")
    for i, t in enumerate(p41.pieces):
        for name, piece in t.named_parameters():
            leaf = whole.get_parameter(name)
            idx = sh41[name.replace(".", "/")].index(i, leaf.shape)
            assert torch.equal(piece, leaf[idx])
    for a, b in zip(jax.tree.leaves(o41), jax.tree.leaves(saved["opt"])):
        assert np.array_equal(a, b)


def test_launch_train_restarts_on_a_cpu_mesh(tmp_path, capsys, monkeypatch):
    """launch.train on a (2, 2) CPU mesh: --die-at exits 42, the rerun
    restores onto the mesh, its final checkpoint equals a straight
    run's bit for bit."""
    monkeypatch.setattr(launch_train, "make_debug_mesh",
                        lambda **kw: cpu_mesh((2, 2)))
    args = ["--smoke", "--device", "cpu", "--steps", "4", "--batch", "4",
            "--seq", "16", "--ckpt-every", "2", "--log-every", "1"]
    assert launch_train.main(args + ["--ckpt-dir", str(tmp_path / "a")]) == 0
    out = capsys.readouterr().out
    assert "mesh={'data': 2, 'model': 2}" in out
    assert launch_train.main(args + ["--ckpt-dir", str(tmp_path / "b"),
                                     "--die-at", "3"]) == 42
    assert launch_train.main(args + ["--ckpt-dir", str(tmp_path / "b")]) == 0
    out = capsys.readouterr().out
    assert "restored checkpoint at step 2" in out and "done" in out
    a = Checkpointer(str(tmp_path / "a")).load_arrays(4)[1]
    b = Checkpointer(str(tmp_path / "b")).load_arrays(4)[1]
    assert sorted(a) == sorted(b) and int(a["opt/count"]) == 4
    for key in a:
        assert np.array_equal(a[key], b[key]), key


# ---------------------------------------------------------------------------
# JAX's own (2, 2) step on four forced host devices
# ---------------------------------------------------------------------------

JAX_MESH_ARCHS = ("internlm2-1.8b", "deepseek-moe-16b")
#: the parameters' change over 3 steps against JAX's mesh run: relative
#: RMS (the module's docstring)
CHANGE_TOL = {"internlm2-1.8b": 0.1, "deepseek-moe-16b": 0.45}
JAX_MESH_SCRIPT = textwrap.dedent("""
    import os, sys, json
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
    import jax, numpy as np
    from repro import configs
    from repro.configs import SHAPES
    from repro.data import make_batch
    from repro.launch.mesh import make_debug_mesh
    from repro.models import init_model
    from repro.train import OptConfig, make_train_step, opt_init
    from repro.train.sharding import param_shardings
    out = {}
    for arch in sys.argv[2:]:
        cfg = configs.get_smoke_config(arch)
        mesh = make_debug_mesh()
        params = jax.jit(lambda k: init_model(cfg, k))(jax.random.PRNGKey(0))
        np.savez(os.path.join(os.environ["OUT_DIR"], arch + "_init.npz"),
                 *jax.tree.leaves(jax.tree.map(np.asarray, params)))
        params = jax.tree.map(jax.device_put, params,
                              param_shardings(cfg, params, mesh))
        opt = opt_init(params)
        step = jax.jit(make_train_step(cfg, OptConfig(**json.loads(
            sys.argv[1])), mesh=mesh))
        losses, norms = [], []
        for i in range(3):
            b = make_batch(cfg, SHAPES["train_4k"], step=i, seed=1,
                           batch_override=8, seq_override=32)
            params, opt, m = step(params, opt, b)
            losses.append(float(m["loss"]))
            norms.append(float(m["grad_norm"]))
        flat = jax.tree.leaves(jax.tree.map(np.asarray, params))
        np.savez(os.path.join(os.environ["OUT_DIR"], arch + ".npz"), *flat)
        out[arch] = {"loss": losses, "grad_norm": norms,
                     "mesh": dict(mesh.shape)}
    print("JSON" + json.dumps(out))
""")


@pytest.fixture(scope="module", autouse=True)
def jax_mesh_run(tmp_path_factory):
    """JAX's (2, 2) run in a subprocess, started with the file's first
    test so that it runs beside the others."""
    out = tmp_path_factory.mktemp("jax_mesh")
    env = dict(os.environ, PYTHONPATH=SRC, OUT_DIR=str(out),
               JAX_PLATFORMS="cpu")
    env.pop("XLA_FLAGS", None)
    proc = subprocess.Popen(
        [sys.executable, "-c", JAX_MESH_SCRIPT, json.dumps(OCFG),
         *JAX_MESH_ARCHS], env=env, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True)

    def result():
        stdout, stderr = proc.communicate(timeout=600)
        assert proc.returncode == 0, stderr[-2000:]
        line = next(x for x in stdout.splitlines() if x.startswith("JSON"))
        return json.loads(line[4:]), out
    yield result
    if proc.poll() is None:
        proc.kill()
        proc.communicate()


def npz_leaves(path):
    with np.load(path) as z:
        return [z[f"arr_{i}"] for i in range(len(z.files))]


@pytest.mark.parametrize("arch", JAX_MESH_ARCHS)
def test_mesh_steps_match_jax_mesh_steps(arch, jax_mesh_run):
    runs, out = jax_mesh_run()
    want = runs[arch]
    assert want["mesh"] == {"data": 2, "model": 2}
    jcfg, cfg = jconfigs.get_smoke_config(arch), get_smoke_config(arch)
    tree0 = jax.tree.unflatten(
        jax.tree.structure(jax.eval_shape(
            lambda k: jax_init_model(jcfg, k), jax.random.PRNGKey(0))),
        npz_leaves(os.path.join(out, arch + "_init.npz")))
    params, mesh = on_mesh(cfg, tree0, (2, 2))
    opt = opt_init(params)
    step = make_train_step(cfg, OptConfig(**OCFG), mesh=mesh)
    losses, norms = [], []
    for i in range(3):
        params, opt, m = step(params, opt, make_batch(
            cfg, SHAPES["train_4k"], step=i, seed=1, batch_override=8,
            seq_override=32, device="cpu"))
        losses.append(float(m["loss"]))
        norms.append(float(m["grad_norm"]))
    np.testing.assert_allclose(losses, want["loss"], rtol=1e-3)
    assert norms[0] == pytest.approx(want["grad_norm"][0], rel=2e-3)
    np.testing.assert_allclose(norms[1:], want["grad_norm"][1:], rtol=2e-2)
    got = jax.tree.leaves(params_to_jax(cfg, params))
    jp = npz_leaves(os.path.join(out, arch + ".npz"))
    start = jax.tree.leaves(tree0)
    change = np.concatenate([(a - s).ravel() for a, s in zip(got, start)])
    jchange = np.concatenate([(b - s).ravel() for b, s in zip(jp, start)])
    err = np.sqrt(((change - jchange) ** 2).mean()) / np.sqrt(
        (jchange ** 2).mean())
    assert err <= CHANGE_TOL[arch], err
