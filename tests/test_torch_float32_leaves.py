"""Leaves the JAX package keeps and reads in float32 (norm scales, the
ssm's ``A_log``, ``D`` and ``dt_bias``) stay float32 in the port when its
weights are bfloat16: from ``init_params`` under ``param_dtype =
"bfloat16"`` and through the bridge's ``dtype=torch.bfloat16`` recast.
The values here are not exact in bfloat16, so a rounded leaf shows."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as jax_smoke_config
from repro.models import layers as JL
from repro.models import model as JM
from repro_torch import bridge
from repro_torch.configs import get_smoke_config
from repro_torch.models import layers as L
from repro_torch.models import model as M

ARCHS = ["gemma3-1b", "mamba2-370m"]
KEEP = {"scale", "A_log", "D", "dt_bias"}


def _flat(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _flat(v, prefix + (k,))
        else:
            yield prefix + (k,), v


def _set(tree, path, value):
    for k in path[:-1]:
        tree = tree[k]
    tree[path[-1]] = value


def _get(tree, path):
    for k in path:
        tree = tree[k]
    return tree


def _params(arch):
    """JAX smoke params as numpy, every float32 leaf of ``KEEP``
    replaced by values near its own that bfloat16 cannot hold."""
    jcfg = jax_smoke_config(arch)
    tree = jax.tree.map(np.asarray, JM.init_params(jcfg, jax.random.PRNGKey(0)))
    rng = np.random.default_rng(0)
    kept = []
    for path, a in list(_flat(tree)):
        if path[-1] in KEEP:
            new = (a + 0.1 + rng.uniform(0.0, 0.3, a.shape)).astype(np.float32)
            exact = new.astype(jnp.bfloat16).astype(np.float32) == new
            assert not exact.any(), path
            _set(tree, path, new)
            kept.append(path)
    return jcfg, tree, kept


@pytest.mark.parametrize("arch", ARCHS)
def test_bridge_keeps_float32_leaves_under_a_bfloat16_recast(arch):
    _, tree, kept = _params(arch)
    out = bridge.params_from_numpy(tree, device="cpu", dtype=torch.bfloat16)
    for path, t in _flat(out):
        if path in kept:
            assert t.dtype == torch.float32, path
            assert np.array_equal(t.numpy(), _get(tree, path)), path
        elif t.is_floating_point():
            assert t.dtype == torch.bfloat16, path
    assert {p[-1] for p in kept} >= ({"scale"} if arch == "gemma3-1b"
                                     else KEEP)


@pytest.mark.parametrize("arch", ARCHS)
def test_init_params_keeps_float32_leaves_under_bfloat16_weights(arch):
    cfg = get_smoke_config(arch).replace(param_dtype="bfloat16")
    params = M.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    n_kept = 0
    for path, t in _flat(params):
        if path[-1] in KEEP:
            n_kept += 1
            assert t.dtype == torch.float32, path
        elif path[-1] != "table":
            assert t.dtype == torch.bfloat16, path
    assert n_kept >= 3


@pytest.mark.parametrize("arch", ARCHS)
def test_rmsnorm_on_bridged_leaves_equals_jax(arch):
    """Every norm of the bridged bf16 tree, applied at float32, gives
    JAX's float32 result on the same scale values."""
    jcfg, tree, kept = _params(arch)
    out = bridge.params_from_numpy(tree, device="cpu", dtype=torch.bfloat16)
    x = np.random.default_rng(1).standard_normal((3, 5, 1)).astype(np.float32)
    n_norms = 0
    for path in kept:
        if path[-1] != "scale":
            continue
        scale = _get(tree, path)
        scale = scale.reshape(-1, scale.shape[-1])[-1]     # one layer's
        xs = np.broadcast_to(x, (3, 5, scale.shape[-1])) \
            * np.linspace(0.5, 2.0, scale.shape[-1], dtype=np.float32)
        want = np.asarray(JL.rmsnorm({"scale": jnp.asarray(scale)},
                                     jnp.asarray(xs), jcfg.norm_eps))
        t = _get(out, path).reshape(-1, scale.shape[-1])[-1]
        got = L.rmsnorm({"scale": t}, torch.from_numpy(np.ascontiguousarray(xs)),
                        jcfg.norm_eps)
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-6)
        n_norms += 1
    assert n_norms >= 2
