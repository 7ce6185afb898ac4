"""The port's configs equal the JAX package's field for field, and the
weight bridge maps a JAX parameter tree onto torch tensors with the
same keys, shapes, dtypes and bits."""
import dataclasses

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.configs import ARCH_IDS
from repro.configs import INPUT_SHAPES as JAX_SHAPES
from repro.configs import get_config as jax_get_config
from repro.configs import get_smoke_config as jax_get_smoke_config
from repro.models import model as JM
from repro_torch import bridge
from repro_torch.configs import INPUT_SHAPES, get_config, get_smoke_config


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_full_config_matches_jax(arch):
    assert dataclasses.asdict(get_config(arch)) == \
        dataclasses.asdict(jax_get_config(arch))


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_smoke_config_matches_jax(arch):
    assert dataclasses.asdict(get_smoke_config(arch)) == \
        dataclasses.asdict(jax_get_smoke_config(arch))


def test_input_shapes_and_derived_numbers_match_jax():
    assert {k: dataclasses.asdict(v) for k, v in INPUT_SHAPES.items()} == \
        {k: dataclasses.asdict(v) for k, v in JAX_SHAPES.items()}
    for arch in ARCH_IDS:
        a, b = get_config(arch), jax_get_config(arch)
        assert a.param_count() == b.param_count()
        assert a.pattern_blocks() == b.pattern_blocks()


def test_dtype_properties_are_torch_dtypes():
    cfg = get_smoke_config("phi3-medium-14b")
    assert cfg.activation_dtype is torch.bfloat16
    assert cfg.weight_dtype is torch.float32
    assert cfg.replace(dtype="float32").activation_dtype is torch.float32
    with pytest.raises(ValueError, match="dtype"):
        _ = cfg.replace(dtype="nonsense").activation_dtype


def _flat(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _flat(v, prefix + (k,))
        else:
            yield prefix + (k,), v


@pytest.mark.parametrize("arch", ["phi3-medium-14b", "gemma3-1b",
                                  "mamba2-370m"])
def test_bridged_params_keep_keys_shapes_and_values(arch):
    cfg = jax_get_smoke_config(arch)
    jparams = JM.init_params(cfg, jax.random.PRNGKey(0))
    tree = bridge.params_from_numpy(jax.tree.map(np.asarray, jparams),
                                    device="cpu")
    jflat = dict(_flat(jax.tree.map(np.asarray, jparams)))
    tflat = dict(_flat(tree))
    assert jflat.keys() == tflat.keys()
    for k, a in jflat.items():
        t = tflat[k]
        assert tuple(t.shape) == a.shape, k
        assert t.dtype == torch.float32 and a.dtype == np.float32, k
        assert np.array_equal(t.numpy(), a), k


def test_bfloat16_crosses_bit_for_bit():
    x = jnp.asarray(np.random.default_rng(0).standard_normal((5, 7)),
                    jnp.bfloat16)
    a = np.asarray(x)
    assert a.dtype == ml_dtypes.bfloat16
    t = bridge.array_to_tensor(a)
    assert t.dtype == torch.bfloat16
    back = bridge.tensor_to_array(t)
    assert back.dtype == np.uint16
    assert np.array_equal(back, a.view(np.uint16))
    np.testing.assert_array_equal(t.float().numpy(), a.astype(np.float32))


def test_bridge_recasts_floats_only():
    tree = {"w": np.ones((2, 3), np.float32), "ids": np.arange(4)}
    out = bridge.params_from_numpy(tree, device="cpu", dtype=torch.bfloat16)
    assert out["w"].dtype == torch.bfloat16
    assert out["ids"].dtype == torch.int64


def test_bridge_defaults_to_cuda():
    if torch.cuda.is_available():
        pytest.skip("this host has CUDA: the default device is valid")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        bridge.params_from_numpy({"w": np.ones(2, np.float32)})


def _jax_to_numpy(tree):
    """A JAX tree's arrays as numpy, its Python ints left as ints."""
    return jax.tree.map(lambda a: np.asarray(a) if isinstance(a, jax.Array)
                        else a, tree)


def test_exit_heads_cross_with_their_list_and_tuple():
    from repro.core import earlyexit as JEE
    cfg = jax_get_smoke_config("phi3-medium-14b")
    heads = JEE.init_exit_heads(cfg, jax.random.PRNGKey(0), [0, 1])
    tree = bridge.params_from_numpy(_jax_to_numpy(heads), device="cpu")
    assert isinstance(tree["exits"], list) and len(tree["exits"]) == 2
    assert tree["exit_layers"] == (0, 1)
    assert type(tree["exit_layers"]) is tuple
    assert all(type(i) is int for i in tree["exit_layers"])
    assert tree["exits"][1]["ln"]["scale"].dtype == torch.float32
    back = bridge.tree_to_numpy(tree)
    assert back["exit_layers"] == (0, 1) and isinstance(back["exits"], list)
    for a, b in zip(back["exits"], heads["exits"]):
        np.testing.assert_array_equal(a["ln"]["scale"],
                                      np.asarray(b["ln"]["scale"]))
    # a recast keeps the ints and the float32 norm scales
    cast = bridge.params_from_numpy(back, device="cpu", dtype=torch.bfloat16)
    assert cast["exit_layers"] == (0, 1)
    assert cast["exits"][0]["ln"]["scale"].dtype == torch.float32


def test_context_space_crosses_without_its_jax_key():
    """The shared-context space holds a JAX PRNG key under ``_key``: the
    caller drops it and gives the port a ``torch.Generator`` there; the
    space's ints cross as ints."""
    from repro.core import context as JCX
    from repro_torch.core import context as CX
    jp = JCX.init_context_space(jax.random.PRNGKey(0), {"cam": 8, "mic": 4},
                                6, 3, hidden=5)
    JCX.add_task_head(jp, "intent", 3)
    tree = bridge.params_from_numpy(
        _jax_to_numpy({k: v for k, v in jp.items() if k != "_key"}),
        device="cpu")
    assert (tree["shared_dim"], tree["hidden"]) == (6, 5)
    assert type(tree["hidden"]) is int
    assert sorted(tree["proj"]) == ["cam", "mic"]
    back = bridge.tree_to_numpy(tree)
    assert back["hidden"] == 5 and back["heads"]["intent"].shape == (5, 3)
    np.testing.assert_array_equal(back["trunk_w"], np.asarray(jp["trunk_w"]))
    tree["_key"] = torch.Generator().manual_seed(0)
    CX.add_task_head(tree, "intrusion", 2)
    assert tuple(tree["heads"]["intrusion"].shape) == (5, 2)
