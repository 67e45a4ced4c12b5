"""The LM stack's inference path (``repro_torch.{configs,models,data,
train}``) against the JAX package's on the CPU, every architecture at
its ``smoke_config()`` width, from JAX's weights carried across by
``params_from_jax``.

Tolerances.  The activations are bf16 in both, and the two sum the bf16
products in another order, so a sum near a rounding boundary rounds the
other way now and then, and the layers carry it on; XLA also fuses some
bf16 casts away inside its compiled scans.  Measured over the
architectures, the logits' RMS error is 0.0-0.9 % of their RMS and the
largest error 0.0-1.3 % of the largest logit (xlstm's f32 recurrences:
1e-7).  They are held to 2 % and 3 %.

An MoE router can break a near-tie between its k-th and (k+1)-th expert
the other way after such a rounding, and that token then takes another
expert (measured: a gap of 0.00097 in probability flipped).  So the MoE
architectures run dropless (no capacity drop multiplies a flip), both
packages' routing is recorded (JAX's by a debug callback in ``lax.top_k``),
and the logits are held to the same 2 % and 3 % at the positions whose
own experts and every earlier position's in their sequence (the
attention reads them) are JAX's in every layer.  Their blocks alone are
held to a bf16 rounding in ``tests/test_torch_moe.py``.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.data import pipeline as jpipeline
from repro.models import decode_step as jax_decode_step
from repro.models import forward as jax_forward
from repro.models import init_cache as jax_init_cache
from repro.models import init_model as jax_init_model
from repro.models.model import encode_audio as jax_encode_audio
from repro.train.step import make_serve_step as jax_make_serve_step
from repro_torch.configs import ARCH_IDS, SHAPES, get_smoke_config
from repro_torch.data import DataIterator, make_batch
from repro_torch.models import decode_step, forward, init_cache, init_model
from repro_torch.models.convert import params_from_jax, params_to_jax
from repro_torch.models.model import encode_audio
from repro_torch.train import make_prefill_step, make_serve_step

B, S, STEPS = 2, 16, 8
REL_RMS, REL_MAX = 0.02, 0.03
#: prefill against decode, as tests/test_models.py holds JAX's
CONSISTENCY = 0.05


def errors(got, want, where=None):
    """(RMS error / RMS, max error / max |want|) of two logit arrays, over
    the leading positions ``where`` (a boolean mask) if given."""
    got = got.float().numpy() if isinstance(got, torch.Tensor) else got
    want = np.asarray(want, np.float32)
    scale_rms, scale_max = np.sqrt((want ** 2).mean()), np.abs(want).max()
    diff = got - want
    if where is not None:
        diff = diff[where]
    return (float(np.sqrt((diff ** 2).mean()) / scale_rms),
            float(np.abs(diff).max() / scale_max))


@pytest.fixture
def routing(monkeypatch):
    """The port's MoE routing as it runs: each call's experts, in a
    list."""
    from repro_torch.models import moe
    calls = []
    route = moe._route

    def recording(params, x, top_k):
        probs, gates, experts = route(params, x, top_k)
        calls.append(experts.numpy())
        return probs, gates, experts
    monkeypatch.setattr(moe, "_route", recording)
    return calls


class JaxRouting:
    """While open, JAX's ``lax.top_k`` records each call's experts into
    ``calls`` by an ordered debug callback, traced into what is compiled
    then; ``take()`` waits for the callbacks and empties the list."""

    def __init__(self):
        self.calls = []
        self.top_k = jax.lax.top_k

    def __enter__(self):
        calls, top_k = self.calls, self.top_k

        def recording(x, k):
            values, experts = top_k(x, k)
            jax.debug.callback(lambda e: calls.append(np.asarray(e)),
                               experts, ordered=True)
            return values, experts
        jax.lax.top_k = recording
        return self

    def __exit__(self, *exc):
        jax.lax.top_k = self.top_k

    def take(self) -> list:
        jax.effects_barrier()
        out = list(self.calls)
        self.calls.clear()
        return out


def same_routing(port_calls, jax_calls, shape):
    """Positions (B, S) whose experts and every earlier position's in
    their sequence are JAX's in every call."""
    assert len(port_calls) == len(jax_calls)
    same = np.ones(shape, bool)
    for got, want in zip(port_calls, jax_calls):
        same &= (np.sort(got, -1) == np.sort(want, -1)).all(-1).reshape(
            shape)
    return np.minimum.accumulate(same, axis=1)


def smoke_batch(cfg, seed):
    r = np.random.default_rng(seed)
    text = S - (cfg.prefix_len if cfg.family == "vlm" else 0)
    batch = {"tokens": r.integers(0, cfg.vocab, (B, text)).astype(np.int32)}
    if cfg.family == "audio":
        batch["frames"] = r.standard_normal(
            (B, cfg.enc_seq, cfg.d_model)).astype(np.float32)
    if cfg.family == "vlm":
        batch["patch_emb"] = r.standard_normal(
            (B, cfg.prefix_len, cfg.d_model)).astype(np.float32)
    return batch


@pytest.fixture(scope="module")
def jax_runs():
    """One JAX initialisation, forward and 8 decode steps an arch, made on
    first use and shared by the tests of that arch."""
    runs = {}

    def get(arch):
        if arch in runs:
            return runs[arch]
        cfg = jconfigs.get_smoke_config(arch)
        moe = cfg.family == "moe"
        params = jax_init_model(cfg, jax.random.PRNGKey(0))
        batch = smoke_batch(cfg, 1)
        jb = {k: jnp.asarray(v) for k, v in batch.items()}
        with JaxRouting() as routing:
            logits, aux = jax.jit(lambda p, b: jax_forward(
                cfg, p, b, remat=False, dropless_moe=moe))(params, jb)
            routes = routing.take()
            enc = None
            if cfg.family == "audio":
                enc = jax_encode_audio(cfg, params, jb["frames"])
            cache = jax_init_cache(cfg, B, STEPS, enc_out=enc,
                                   params=params if enc is not None
                                   else None)
            step = jax.jit(lambda p, c, t: jax_decode_step(cfg, p, c, t))
            dec, dec_routes = [], []
            for t in range(STEPS):
                lg, cache = step(params, cache, jb["tokens"][:, t:t + 1])
                dec.append(np.asarray(lg, np.float32))
                dec_routes.append(routing.take())
        runs[arch] = {"tree": jax.tree.map(np.asarray, params),
                      "batch": batch, "logits": np.asarray(logits),
                      "aux": float(aux), "decode": dec, "routes": routes,
                      "decode_routes": dec_routes}
        return runs[arch]
    return get


def port(arch, run):
    cfg = get_smoke_config(arch)
    return cfg, params_from_jax(cfg, run["tree"], device="cpu")


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_forward_matches_jax(arch, jax_runs, routing):
    run = jax_runs(arch)
    cfg, params = port(arch, run)
    batch = {k: torch.tensor(v) for k, v in run["batch"].items()}
    logits, aux = forward(cfg, params, batch, remat=False,
                          dropless_moe=cfg.family == "moe")
    assert logits.dtype == torch.float32
    assert logits.shape == run["logits"].shape == (B, S, cfg.vocab)
    assert bool(torch.isfinite(logits).all())
    where = same_routing(routing, run["routes"], (B, S)) if routing \
        else None
    rms, worst = errors(logits, run["logits"], where)
    assert rms <= REL_RMS and worst <= REL_MAX, (rms, worst)
    if cfg.family == "moe":
        assert where.sum() >= S           # most of the positions compared
        if where.all():
            assert abs(float(aux) - run["aux"]) <= 1e-6
    else:
        assert float(aux) == run["aux"] == 0.0


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_decode_steps_match_jax(arch, jax_runs, routing):
    """Eight decode steps from an empty cache, JAX's tokens fed to both;
    the cache is written in place and returned."""
    run = jax_runs(arch)
    cfg, params = port(arch, run)
    tokens = torch.tensor(run["batch"]["tokens"])
    enc = None
    if cfg.family == "audio":
        enc = encode_audio(cfg, params, torch.tensor(run["batch"]["frames"]))
    cache = init_cache(cfg, B, STEPS, enc_out=enc,
                       params=params if enc is not None else None,
                       device="cpu")
    clear = np.ones(B, bool)
    compared = 0
    for t in range(STEPS):
        routing.clear()
        logits, out = decode_step(cfg, params, cache, tokens[:, t:t + 1])
        assert out is cache and cache["length"] == t + 1
        assert logits.shape == (B, 1, cfg.vocab)
        assert bool(torch.isfinite(logits).all())
        if routing:
            clear &= same_routing(routing, run["decode_routes"][t],
                                  (B, 1))[:, 0]
        if clear.any():
            rms, worst = errors(logits, run["decode"][t], clear)
            assert rms <= REL_RMS and worst <= REL_MAX, (t, rms, worst)
            compared += 1
    assert compared >= STEPS // 2


@pytest.mark.parametrize("arch", ["internlm2-1.8b", "chatglm3-6b",
                                  "deepseek-v2-lite-16b", "xlstm-125m",
                                  "zamba2-1.2b", "whisper-large-v3"])
def test_prefill_decode_consistency(arch):
    """Teacher-forced decode reproduces the forward logits in the port
    (tests/test_models.py's archs and whisper, its 0.05)."""
    cfg = get_smoke_config(arch)
    params = init_model(cfg, 1, device="cpu")
    r = np.random.default_rng(2)
    tokens = torch.tensor(r.integers(0, cfg.vocab, (B, 8)).astype(np.int32))
    batch = {"tokens": tokens}
    enc = None
    if cfg.family == "audio":
        batch["frames"] = torch.tensor(r.standard_normal(
            (B, cfg.enc_seq, cfg.d_model)).astype(np.float32))
        enc = encode_audio(cfg, params, batch["frames"])
    full, _ = forward(cfg, params, batch, remat=False, dropless_moe=True)
    cache = init_cache(cfg, B, 8, enc_out=enc,
                       params=params if enc is not None else None,
                       device="cpu")
    outs = []
    for t in range(8):
        logits, cache = decode_step(cfg, params, cache, tokens[:, t:t + 1])
        outs.append(logits[:, 0])
    assert torch.allclose(torch.stack(outs, dim=1), full,
                          rtol=CONSISTENCY, atol=CONSISTENCY)


def test_ring_cache_matches_full_cache():
    """The ring buffer of ``window`` slots against the full cache, both
    under the window's mask, past the ring's wrap (tests/test_models.py's
    2e-2)."""
    cfg = get_smoke_config("internlm2-1.8b")
    params = init_model(cfg, 5, device="cpu")
    window, steps = 4, 10
    tokens = torch.randint(0, cfg.vocab, (B, steps),
                           generator=torch.Generator().manual_seed(5))
    full = init_cache(cfg, B, steps, device="cpu")
    ring = init_cache(cfg, B, steps, window=window, device="cpu")
    assert ring["kv"]["k"].shape[2] == window
    for i in range(steps):
        t = tokens[:, i:i + 1]
        lf, full = decode_step(cfg, params, full, t, sliding_window=window)
        lr, ring = decode_step(cfg, params, ring, t, sliding_window=window)
        assert torch.allclose(lr, lf, rtol=2e-2, atol=2e-2), i


def test_ring_cache_matches_jax():
    """The port's ring against JAX's ring, from JAX's weights."""
    jcfg = jconfigs.get_smoke_config("internlm2-1.8b")
    jp = jax_init_model(jcfg, jax.random.PRNGKey(5))
    cfg = get_smoke_config("internlm2-1.8b")
    params = params_from_jax(cfg, jax.tree.map(np.asarray, jp), device="cpu")
    tokens = np.random.default_rng(5).integers(0, cfg.vocab, (B, 10)).astype(
        np.int32)
    jring = jax_init_cache(jcfg, B, 10, window=4)
    ring = init_cache(cfg, B, 10, window=4, device="cpu")
    step = jax.jit(lambda p, c, t: jax_decode_step(jcfg, p, c, t,
                                                   sliding_window=4))
    for i in range(10):
        lj, jring = step(jp, jring, jnp.asarray(tokens[:, i:i + 1]))
        lt, ring = decode_step(cfg, params, ring,
                               torch.tensor(tokens[:, i:i + 1]),
                               sliding_window=4)
        rms, worst = errors(lt, lj)
        assert rms <= REL_RMS and worst <= REL_MAX, (i, rms, worst)


@pytest.mark.parametrize("arch", ["internlm2-1.8b", "internvl2-26b",
                                  "whisper-large-v3", "xlstm-125m"])
@pytest.mark.parametrize("step", [0, 3])
def test_make_batch_tokens_bit_equal_to_jax(arch, step):
    cfg = get_smoke_config(arch)
    shape = SHAPES["train_4k"]
    want = jpipeline.make_batch(jconfigs.get_smoke_config(arch), shape,
                                step=step, seed=7, batch_override=3,
                                seq_override=24)
    got = make_batch(cfg, shape, step=step, seed=7, batch_override=3,
                     seq_override=24, device="cpu")
    assert sorted(got) == sorted(want)
    for key in ("tokens", "labels"):
        assert got[key].dtype == torch.int32
        assert np.array_equal(got[key].numpy(), np.asarray(want[key]))
    for key in ("frames", "patch_emb"):
        if key in want:
            assert got[key].dtype == torch.bfloat16
            assert tuple(got[key].shape) == want[key].shape
            assert bool(torch.isfinite(got[key].float()).all())


def test_make_batch_abstract_and_seeded_frontends():
    cfg = get_smoke_config("internvl2-26b")
    shape = SHAPES["prefill_32k"]
    abstract = make_batch(cfg, shape, abstract=True, batch_override=2,
                          seq_override=16)
    want = jpipeline.make_batch(jconfigs.get_smoke_config("internvl2-26b"),
                                shape, abstract=True, batch_override=2,
                                seq_override=16)
    for key, value in abstract.items():
        assert value.device.type == "meta"
        assert tuple(value.shape) == want[key].shape
    a = make_batch(cfg, shape, step=2, seed=3, batch_override=2,
                   seq_override=16, device="cpu")
    b = make_batch(cfg, shape, step=2, seed=3, batch_override=2,
                   seq_override=16, device="cpu")
    c = make_batch(cfg, shape, step=3, seed=3, batch_override=2,
                   seq_override=16, device="cpu")
    assert torch.equal(a["patch_emb"], b["patch_emb"])
    assert not torch.equal(a["patch_emb"], c["patch_emb"])


def test_data_iterator_skips_to_a_step():
    cfg = get_smoke_config("internlm2-1.8b")
    shape = SHAPES["train_4k"]
    it = DataIterator(cfg, shape, seed=4, batch_override=2, seq_override=8,
                      device="cpu")
    first = [next(it) for _ in range(3)]
    assert [s for s, _ in first] == [0, 1, 2]
    it2 = DataIterator(cfg, shape, seed=4, batch_override=2,
                       seq_override=8, device="cpu")
    it2.skip_to(2)
    step, batch = next(it2)
    assert step == 2 and torch.equal(batch["tokens"], first[2][1]["tokens"])
    want = jpipeline.make_batch(jconfigs.get_smoke_config("internlm2-1.8b"),
                                shape, step=2, seed=4, batch_override=2,
                                seq_override=8)
    assert np.array_equal(batch["tokens"].numpy(), np.asarray(want["tokens"]))


@pytest.mark.parametrize("arch", ["zamba2-1.2b", "deepseek-v2-lite-16b",
                                  "xlstm-125m", "whisper-large-v3"])
def test_params_from_jax_round_trips(arch):
    """JAX's tree -> the port -> JAX's layout again, leaf for leaf; zamba's
    shared block stays one block."""
    cfg = jconfigs.get_smoke_config(arch)
    tree = jax.tree.map(np.asarray, jax_init_model(cfg,
                                                   jax.random.PRNGKey(3)))
    params = params_from_jax(get_smoke_config(arch), tree, device="cpu")
    back = params_to_jax(get_smoke_config(arch), params)
    flat_a, tree_a = jax.tree.flatten(tree)
    flat_b, tree_b = jax.tree.flatten(back)
    assert tree_a == tree_b
    assert all(np.array_equal(a, b) for a, b in zip(flat_a, flat_b))
    if cfg.family == "hybrid":
        assert sum(1 for name, _ in params.named_modules()
                   if name == "shared_attn") == 1
        assert len(params["blocks"]) == cfg.n_layers


def test_params_from_jax_checks_the_tree():
    cfg = jconfigs.get_smoke_config("internlm2-1.8b")
    tree = jax.tree.map(np.asarray, jax_init_model(cfg,
                                                   jax.random.PRNGKey(3)))
    with pytest.raises(ValueError, match="layers"):
        params_from_jax(dataclasses.replace(get_smoke_config(
            "internlm2-1.8b"), n_layers=3), tree, device="cpu")
    with pytest.raises(ValueError, match="stacks"):
        params_from_jax(get_smoke_config("deepseek-moe-16b"), tree,
                        device="cpu")


def test_prefill_step_is_forward_without_grad():
    cfg = get_smoke_config("deepseek-moe-16b")
    params = init_model(cfg, 2, device="cpu")
    batch = make_batch(cfg, SHAPES["prefill_32k"], batch_override=2,
                       seq_override=16, device="cpu")
    logits = make_prefill_step(cfg)(params, batch)
    want, _ = forward(cfg, params, batch, remat=False)
    assert not logits.requires_grad
    assert torch.equal(logits, want)


@pytest.mark.parametrize("arch", ["internlm2-1.8b", "zamba2-1.2b"])
def test_serve_step_greedy_matches_jax(arch, jax_runs):
    """Greedy serve steps on JAX's weights and tokens: the argmax of the
    step's logits, and JAX's token wherever its top-2 margin exceeds the
    logits' error bound (2 x 3 % of the largest logit)."""
    run = jax_runs(arch)
    cfg, params = port(arch, run)
    jcfg = jconfigs.get_smoke_config(arch)
    jp = jax.tree.map(jnp.asarray, run["tree"])
    jstep = jax.jit(jax_make_serve_step(jcfg))
    step = make_serve_step(cfg)
    jcache = jax_init_cache(jcfg, B, STEPS)
    cache = init_cache(cfg, B, STEPS, device="cpu")
    tokens = run["batch"]["tokens"]
    compared = 0
    for t in range(STEPS):
        tok = tokens[:, t:t + 1]
        want, jcache = jstep(jp, jcache, jnp.asarray(tok))
        got, cache = step(params, cache, torch.tensor(tok))
        assert got.dtype == torch.int32 and got.shape == (B, 1)
        margin = np.sort(run["decode"][t][:, -1], axis=-1)
        sure = margin[:, -1] - margin[:, -2] > \
            2 * REL_MAX * np.abs(run["decode"][t]).max()
        compared += int(sure.sum())
        assert np.array_equal(got.numpy()[sure], np.asarray(want)[sure])
    assert cache["length"] == STEPS
    assert compared > 0


def test_serve_step_samples_keyed_on_the_cache_length():
    """At a temperature the draw is a function of the cache's length
    before the step: the same from the same state, another at another
    length (JAX keys its own stream the same way)."""
    cfg = get_smoke_config("internlm2-1.8b")
    params = init_model(cfg, 3, device="cpu")
    step = make_serve_step(cfg, temperature=2.0)
    tok = torch.ones((4, 1), dtype=torch.int32)
    draws = []
    for _ in range(2):
        cache = init_cache(cfg, 4, 4, device="cpu")
        draws.append([step(params, cache, tok)[0] for _ in range(3)])
    for a, b in zip(*draws):
        assert torch.equal(a, b)
    assert all(int(x.min()) >= 0 and int(x.max()) < cfg.vocab
               for x in draws[0])


def test_entry_points_raise_without_gpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = get_smoke_config("internlm2-1.8b")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        init_model(cfg, 0)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        init_cache(cfg, 1, 4)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        make_batch(cfg, SHAPES["train_4k"], batch_override=1,
                   seq_override=4)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        DataIterator(cfg, SHAPES["train_4k"])
    tree = jax.tree.map(np.asarray, jax_init_model(
        jconfigs.get_smoke_config("internlm2-1.8b"), jax.random.PRNGKey(0)))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        params_from_jax(cfg, tree)
