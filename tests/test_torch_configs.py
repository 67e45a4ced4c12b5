"""The port's LM configs (``repro_torch.configs``) against the JAX
package's: every architecture's full and smoke config field for field,
the shapes and their applicability, and the parameter counts of the full
configs (JAX's ``eval_shape`` against the port's tree on the meta device,
so nothing is allocated)."""
import dataclasses

import jax
import numpy as np
import pytest

from repro import configs as jconfigs
from repro.models import init_model as jax_init_model
from repro_torch import configs
from repro_torch.models import init_model
from repro_torch.models.model import param_count


def test_registry_lists_the_jax_archs_in_order():
    assert configs.ARCH_IDS == jconfigs.ARCH_IDS
    assert len(configs.ARCH_IDS) == 10


@pytest.mark.parametrize("arch", jconfigs.ARCH_IDS)
def test_full_config_equals_jax(arch):
    got, want = configs.get_config(arch), jconfigs.get_config(arch)
    assert type(got).__module__ == "repro_torch.configs.base"
    assert dataclasses.asdict(got) == dataclasses.asdict(want)


@pytest.mark.parametrize("arch", jconfigs.ARCH_IDS)
def test_smoke_config_equals_jax(arch):
    got, want = configs.get_smoke_config(arch), \
        jconfigs.get_smoke_config(arch)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)


def test_shapes_and_applicability_equal_jax():
    assert {k: dataclasses.asdict(v) for k, v in configs.SHAPES.items()} \
        == {k: dataclasses.asdict(v) for k, v in jconfigs.SHAPES.items()}
    for arch in jconfigs.ARCH_IDS:
        for name in jconfigs.SHAPES:
            assert configs.shape_applicable(
                configs.get_config(arch), configs.SHAPES[name]) == \
                jconfigs.shape_applicable(jconfigs.get_config(arch),
                                          jconfigs.SHAPES[name])


def test_unknown_arch_raises():
    with pytest.raises(KeyError, match="unknown arch"):
        configs.get_config("gpt-5")


def test_with_overrides_returns_a_new_config():
    cfg = configs.get_config("internlm2-1.8b")
    two = cfg.with_overrides(n_layers=2)
    assert (two.n_layers, cfg.n_layers) == (2, 24)
    assert dataclasses.replace(two, n_layers=24) == cfg


@pytest.mark.parametrize("arch", jconfigs.ARCH_IDS)
def test_full_param_count_equals_jax(arch):
    """The port's tree on the meta device has JAX's parameter count, and
    each leaf JAX's shape (by its path, stacks unstacked)."""
    want_tree = jax.eval_shape(lambda: jax_init_model(
        jconfigs.get_config(arch), jax.random.PRNGKey(0)))
    want = sum(int(np.prod(x.shape)) for x in jax.tree.leaves(want_tree))
    params = init_model(configs.get_config(arch), device="meta")
    assert param_count(params) == want
    assert all(p.device.type == "meta" for p in params.parameters())
    # the stacked leaves: n layers of the per-layer shape
    for key in ("blocks", "dense_blocks", "moe_blocks", "enc_blocks",
                "dec_blocks"):
        if key not in want_tree:
            continue
        flat = jax.tree_util.tree_flatten_with_path(want_tree[key])[0]
        layers = params[key]
        for path, leaf in flat:
            node = layers[0]
            for k in path:
                node = node[k.key]
            assert (len(layers), *node.shape) == leaf.shape, (key, path)
