"""The port's sharding rules (``repro_torch.train.sharding``), mesh
factories and the dry-run half of ``launch/roofline.py``: each case of
``tests/test_sharding.py`` on the port's ``Mesh`` (on the meta device,
in place of its ``FakeMesh``), and parity with the JAX package's rules
for all ten architectures at smoke and full width, on both production
meshes, FSDP on and off.

JAX stacks a family's layers on a leading axis and the port holds one
leaf a layer: a port leaf's spec is held against JAX's spec of the
stacked leaf with its leading entry dropped.  JAX's trees are
``jax.eval_shape`` abstractions; the port's are on meta.  Specs are
compared as tuples (entries: None, an axis name, a tuple of names);
parameter counts exactly.
"""
import jax
import numpy as np
import pytest
import torch

from repro.configs import ARCH_IDS, SHAPES, get_config, get_smoke_config
from repro.launch import roofline as jroof
from repro.models import init_cache as jinit_cache
from repro.models import init_model as jinit_model
from repro.train import sharding as js

from repro_torch.configs import get_config as tget_config
from repro_torch.configs import get_smoke_config as tget_smoke
from repro_torch.launch import roofline
from repro_torch.launch.mesh import (make_debug_mesh, make_mesh,
                                     make_production_mesh)
from repro_torch.models import init_cache, init_model
from repro_torch.models.convert import STACKED
from repro_torch.train import OptConfig, make_loss_fn, make_train_step
from repro_torch.train.sharding import (P, NamedSharding, activation_spec,
                                        batch_specs, cache_specs,
                                        leaf_paths, mesh_axes, param_spec,
                                        param_shardings, place)

MESH16 = make_mesh((16, 16), ("data", "model"), "meta")


class FakeMesh:
    """JAX's rules read ``mesh.shape[axis]`` and ``mesh.axis_names``."""

    def __init__(self, mesh):
        self.shape = dict(zip(mesh.axis_names, mesh.shape))
        self.axis_names = mesh.axis_names


def meshes():
    return [make_production_mesh(multi_pod=m, device="meta")
            for m in (False, True)]


# -- the cases of tests/test_sharding.py ------------------------------------

def test_heads_shard_when_divisible():
    spec = param_spec("blocks/attn/wq", (2048, 32, 64), MESH16, fsdp=False)
    assert spec == P(None, "model", None)


def test_whisper_heads_fall_back_to_head_dim():
    """20 heads don't divide 16 -> the model axis moves to head_dim."""
    spec = param_spec("dec_blocks/attn/wq", (1280, 20, 64), MESH16,
                      fsdp=False)
    assert spec == P(None, None, "model")
    # and if neither divides, fully replicated
    spec = param_spec("dec_blocks/attn/wq", (1280, 20, 63), MESH16,
                      fsdp=False)
    assert spec == P(None, None, None)


def test_vocab_shard_and_fallback():
    assert param_spec("embed/table", (102400, 2048), MESH16,
                      fsdp=False) == P("model", None)
    # whisper vocab 51866 % 16 != 0 -> replicated
    assert param_spec("embed/table", (51866, 1280), MESH16,
                      fsdp=False) == P(None, None)


def test_fsdp_shards_dmodel():
    spec = param_spec("blocks/mlp/wi", (8192, 22528), MESH16, fsdp=True)
    assert spec == P("data", "model")


def test_expert_parallel():
    spec = param_spec("moe_blocks/moe/wi", (26, 64, 2048, 1408), MESH16,
                      fsdp=False)
    assert spec == P(None, "model", None, None)
    # a layer of the port's unstacked tree
    spec = param_spec("moe_blocks/3/moe/wi", (64, 2048, 1408), MESH16,
                      fsdp=False)
    assert spec == P("model", None, None)


def test_stacked_leading_axis_never_sharded():
    spec = param_spec("blocks/attn/wo", (40, 64, 128, 8192), MESH16,
                      fsdp=True)
    assert spec[0] is None


def test_norms_replicated():
    assert param_spec("blocks/norm1/scale", (2048,), MESH16,
                      fsdp=True) == P()


def test_param_shardings_on_real_mesh():
    mesh = make_debug_mesh(device="cpu")
    cfg = tget_smoke("internlm2-1.8b")
    params = init_model(cfg, 0, device="cpu")
    sh = param_shardings(cfg, params, mesh)
    assert len(sh) == len(list(params.parameters()))
    assert list(sh) == list(leaf_paths(params))
    assert place(params, sh) is params


def test_collective_bytes_counted_by_hand():
    """Two leaves on the (2, 4) mesh ("data", "model"): a (8, 16) f32
    weight FSDP-sharded P("data", "model") -> shard (4, 4), 64 B; a
    (16,) f32 norm replicated, 64 B.  A train step gathering twice:
    all-gather 2 x 64 x 2 = 256 B of the weight, its gradient
    reduce-scattered 128 B, the norm's all-reduced 64 B; plus a residual
    of 1000 B with sp (all-gather and reduce-scatter), 300 B of MoE
    dispatch and 40 B of halo."""
    mesh = make_mesh((2, 4), ("data", "model"), "meta")
    w = torch.empty((8, 16), device="meta")
    norm = torch.empty((16,), device="meta")
    params = [(NamedSharding(mesh, P("data", "model")), w),
              (NamedSharding(mesh, P()), norm)]
    got = roofline.collective_bytes(mesh, params, train=True, gathers=2,
                                    residual=1000, sp=True, dispatch=300,
                                    halo=40)
    assert got == {"all-gather": 256 + 1000, "all-reduce": 64,
                   "reduce-scatter": 128 + 1000, "all-to-all": 300,
                   "collective-permute": 40}
    # inference: one gather, no gradient; the residual all-reduced
    got = roofline.collective_bytes(mesh, params, residual=1000)
    assert got == {"all-gather": 128, "all-reduce": 1000,
                   "reduce-scatter": 0, "all-to-all": 0,
                   "collective-permute": 0}
    # one data position: no gradient all-reduce
    one = make_mesh((1, 4), ("data", "model"), "meta")
    got = roofline.collective_bytes(
        one, [(NamedSharding(one, P()), norm)], train=True)
    assert sum(got.values()) == 0


def test_roofline_terms_dominance():
    t = roofline.roofline_terms(roofline.H100_BF16_FLOPS, 0.0,
                                {"all-reduce": 0}, 1)
    assert t["dominant"] == "compute"
    assert t["t_compute_s"] == 1.0
    t = roofline.roofline_terms(0.0, roofline.H100_HBM_BYTES_PER_S, {}, 1)
    assert t["dominant"] == "memory" and t["t_memory_s"] == 1.0
    t = roofline.roofline_terms(1.0, 1.0, {"all-to-all": 450e9}, 1)
    assert t["dominant"] == "collective" and t["t_collective_s"] == 1.0
    assert roofline.H100_NVLINK_BYTES_PER_S == 450e9


def test_count_params_moe_active():
    cfg = tget_smoke("deepseek-moe-16b")
    params = init_model(cfg, device="meta")
    counts = roofline.count_params(params,
                                   active_moe_frac=cfg.top_k / cfg.n_routed)
    assert 0 < counts["active"] < counts["total"]


def test_model_flops():
    assert roofline.model_flops(10.0, 3.0, "train") == 180.0
    assert roofline.model_flops(10.0, 3.0, "decode") == 60.0


# -- the spec type and the mesh factories ------------------------------------

def test_named_sharding_shard_shape_and_index():
    mesh = make_production_mesh(multi_pod=True, device="meta")
    sh = NamedSharding(mesh, P(("pod", "data"), None, "model"))
    assert sh.shard_shape((64, 3, 32)) == (2, 3, 2)
    # shard i's block: its (pod, data) ring position on dim 0, its model
    # position on dim 2
    i = 1 * 256 + 5 * 16 + 7
    assert sh.index(i, (64, 3, 32)) == (slice(42, 44), slice(0, 3),
                                        slice(14, 16))
    assert sh.shard_bytes(torch.empty((64, 3, 32), device="meta")) == 48
    with pytest.raises(ValueError):
        sh.check((63, 3, 32))          # 63 does not divide 32 positions
    with pytest.raises(ValueError):
        NamedSharding(mesh, P("model", "model")).check((16, 16))
    with pytest.raises(ValueError):
        NamedSharding(mesh, P("rows")).check((16,))
    with pytest.raises(ValueError):
        NamedSharding(mesh, P(None, None)).check((16,))


def test_production_and_debug_meshes():
    single, multi = meshes()
    assert (single.shape, single.axis_names) == ((16, 16), ("data", "model"))
    assert (multi.shape, multi.axis_names) == ((2, 16, 16),
                                               ("pod", "data", "model"))
    assert multi.size == 512 and multi.devices == (torch.device("meta"),)
    assert mesh_axes(multi) == (("pod", "data"), ("model",))
    debug = make_debug_mesh(n_devices=8, model=2, device="cpu")
    assert debug.shape == (4, 2) and debug.axis_names == ("data", "model")
    assert make_debug_mesh(n_devices=1, device="cpu").shape == (1, 1)


def test_lm_step_takes_any_mesh():
    """make_loss_fn, make_train_step and place take a (2, 2) CPU mesh and
    the 256-shard production mesh on meta: each shard's pieces have its
    shard shape, on its device; a mesh step refuses an unplaced tree."""
    cfg = tget_smoke("internlm2-1.8b")
    one = make_debug_mesh(n_devices=1, device="cpu")
    make_loss_fn(cfg, mesh=one, sp=True)
    make_train_step(cfg, OptConfig(), mesh=one)
    for mesh, device in ((make_debug_mesh(n_devices=4, device="cpu"), "cpu"),
                         (MESH16, "meta")):
        make_loss_fn(cfg, mesh=mesh, sp=True)
        make_train_step(cfg, OptConfig(), mesh=mesh)
        params = init_model(cfg, device=device)
        sh = param_shardings(cfg, params, mesh)
        placed = place(params, sh)
        assert placed is not params and len(placed.pieces) == mesh.size
        for i in (0, mesh.size - 1):
            for name, piece in placed.pieces[i].named_parameters():
                path = name.replace(".", "/")
                assert piece.device == torch.device(device)
                assert tuple(piece.shape) == sh[path].shard_shape(
                    params.get_parameter(name).shape)
        with pytest.raises(ValueError, match="placed on it"):
            make_loss_fn(cfg, mesh=mesh)(params, {})


# -- parity with the JAX package ---------------------------------------------

def _jax_leaves(cfg):
    a = jax.eval_shape(lambda k: jinit_model(cfg, k), jax.random.PRNGKey(0))
    return {js._path_str(p): tuple(leaf.shape)
            for p, leaf in jax.tree_util.tree_flatten_with_path(a)[0]}


def _jax_key(path: str) -> str:
    parts = path.split("/")
    return "/".join([parts[0]] + parts[2:]) if parts[0] in STACKED else path


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_param_specs_equal_jax(arch):
    """Every leaf, at smoke and full width, on both production meshes,
    FSDP on and off; and the specs are valid for the port's leaves."""
    for smoke in (True, False):
        jcfg = get_smoke_config(arch) if smoke else get_config(arch)
        tcfg = tget_smoke(arch) if smoke else tget_config(arch)
        jleaves = _jax_leaves(jcfg)
        params = init_model(tcfg, device="meta")
        paths = leaf_paths(params)
        tops = [k.split("/")[0] for k in jleaves]
        assert len(paths) == sum(len(params[t]) if t in STACKED else 1
                                 for t in tops)
        for mesh in meshes():
            for fsdp in (False, True):
                sh = param_shardings(tcfg, params, mesh, fsdp=fsdp)
                for path, s in sh.items():
                    key = _jax_key(path)
                    want = tuple(js.param_spec(key, jleaves[key],
                                               FakeMesh(mesh), fsdp=fsdp))
                    if key != path:
                        want = want[1:]
                        assert tuple(paths[path].shape) == jleaves[key][1:]
                    assert tuple(s.spec) == want, (arch, smoke, path, fsdp)
                    s.check(paths[path].shape)


@pytest.mark.parametrize("shape", list(SHAPES))
def test_batch_specs_equal_jax(shape):
    for arch in ARCH_IDS:
        cfg = tget_config(arch)
        for mesh in meshes():
            for b in (SHAPES[shape].global_batch, 24):
                got = batch_specs(cfg, mesh, global_batch=b)
                want = js.batch_specs(get_config(arch), FakeMesh(mesh),
                                      global_batch=b)
                assert {k: tuple(v) for k, v in got.items()} == \
                    {k: tuple(v) for k, v in want.items()}


def _flat(tree, prefix=""):
    """Leaves of a dict/list tree by path (either package's)."""
    if isinstance(tree, dict):
        return {p: v for k in tree for p, v in
                _flat(tree[k], f"{prefix}/{k}").items()}
    if isinstance(tree, (list, tuple)) and not isinstance(tree, P) \
            and not type(tree).__name__ == "PartitionSpec":
        return {p: v for i, x in enumerate(tree) for p, v in
                _flat(x, f"{prefix}/{i}").items()}
    return {prefix: tree}


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_cache_specs_equal_jax(arch):
    """Each smoke cache (batch 16 and 32, a short cache and one of 4096
    slots), on both meshes: the same spec for every leaf, ``length``
    (a Python int in the port) P() in both."""
    jcfg, tcfg = get_smoke_config(arch), tget_smoke(arch)
    for b, maxlen in ((16, 64), (32, 4096)):
        jcache = jax.eval_shape(lambda: jinit_cache(jcfg, b, maxlen))
        tcache = init_cache(tcfg, b, maxlen, device="meta")
        for mesh in meshes():
            got = _flat(cache_specs(tcfg, tcache, mesh, batch=b))
            want = _flat(js.cache_specs(jcfg, jcache, FakeMesh(mesh),
                                        batch=b))
            assert set(got) == set(want)
            for path in want:
                assert tuple(got[path]) == tuple(want[path]), (arch, path)
            for path, leaf in _flat(tcache).items():
                if isinstance(leaf, torch.Tensor):
                    NamedSharding(mesh, got[path]).check(leaf.shape)


def test_activation_spec_equals_jax():
    for mesh in meshes():
        for sp in (False, True):
            assert tuple(activation_spec(mesh, sp=sp)) == tuple(
                js.activation_spec(FakeMesh(mesh), sp=sp))


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_count_params_equal_jax(arch):
    for smoke in (True, False):
        jcfg = get_smoke_config(arch) if smoke else get_config(arch)
        tcfg = tget_smoke(arch) if smoke else tget_config(arch)
        frac = (jcfg.top_k / jcfg.n_routed) if jcfg.family == "moe" else 1.0
        want = jroof.count_params(
            jax.eval_shape(lambda k: jinit_model(jcfg, k),
                           jax.random.PRNGKey(0)), active_moe_frac=frac)
        got = roofline.count_params(init_model(tcfg, device="meta"),
                                    active_moe_frac=frac)
        assert got == want
        assert np.isfinite(got["total"]) and got["total"] > 0
