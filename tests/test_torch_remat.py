"""The port's remat policies against ``jax.checkpoint``'s.

Every name ``jax.checkpoint_policies`` takes without arguments (and
``"full"``, a policy-free ``jax.checkpoint``) runs through
``transformer._maybe_remat``: on a 4-layer gemma3-1b smoke config (one
super-block of two local layers and a global one, then a remainder
local layer: nested remat regions, the chunked local and the plain global
attention) the loss and every gradient equal the port's no-remat run bit
for bit and JAX's under the same policy within 1e-5 of each quantity's
largest magnitude (the same float32 math summed in another order).

What a policy keeps: for a phi3 dense block, a gemma super-block with its
nested local regions, a granite-moe layer and a mamba2 block (two scan
chunks), the element counts of the products (``mm`` / ``bmm``) whose
outputs are still alive after the port's forward equal those of the dot
outputs among ``saved_residuals(jax.checkpoint(fn, policy=...))``; the
products the port did not keep are the ones it runs again in the
backward.  JAX's super-block stacks the residuals of its scanned local
layers along a leading axis of 2, unstacked here into one per layer.

The factory names raise ``TypeError`` and an unknown name
``AttributeError`` in both packages.
"""
import gc
from collections import Counter

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import lax
from jax._src.ad_checkpoint import saved_residuals
from torch.multiprocessing.reductions import StorageWeakRef
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.checkpoint import set_checkpoint_early_stop

from repro.configs import get_smoke_config as jax_smoke_config
from repro.models import model as JM
from repro.models import moe as JMO
from repro.models import ssm as JSS
from repro.models import transformer as JT
from repro_torch.bridge import params_from_numpy
from repro_torch.configs import get_smoke_config
from repro_torch.models import model as M
from repro_torch.models import moe as MO
from repro_torch.models import ssm as SS
from repro_torch.models import transformer as T
from repro_torch.training import optimizer as O

POLICIES = ("full", "nothing_saveable", "everything_saveable",
            "dots_saveable", "checkpoint_dots",
            "dots_with_no_batch_dims_saveable",
            "checkpoint_dots_with_no_batch_dims")
SELECTIVE = ("nothing_saveable", "dots_saveable",
             "dots_with_no_batch_dims_saveable")
PRODUCTS = {torch.ops.aten.mm, torch.ops.aten.bmm, torch.ops.aten.addmm,
            torch.ops.aten.baddbmm}
B, S = 3, 32        # B differs from the super-block's 2 scanned locals


def _bridge(arch, seed=0, **kw):
    jcfg = jax_smoke_config(arch).replace(dtype="float32", **kw)
    cfg = get_smoke_config(arch).replace(dtype="float32", **kw)
    jparams = jax.jit(lambda key: JM.init_params(jcfg, key))(
        jax.random.PRNGKey(seed))
    return jcfg, jparams, cfg


def _torch(tree):
    return params_from_numpy(jax.tree.map(np.asarray, tree), device="cpu")


# ---------------------------------------------------------------------------
# loss and gradients under every policy
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def gemma():
    jcfg, jparams, cfg = _bridge("gemma3-1b", num_layers=4)
    toks = np.random.default_rng(1).integers(0, cfg.vocab_size, (2, 65),
                                             dtype=np.int32)
    jbatch = {"tokens": jnp.asarray(toks[:, :-1]),
              "targets": jnp.asarray(toks[:, 1:])}
    batch = {"tokens": torch.from_numpy(toks[:, :-1].copy()),
             "targets": torch.from_numpy(toks[:, 1:].copy())}
    params = _torch(jparams)
    leaves = O.tree_leaves(params)
    for t in leaves:
        t.requires_grad_(True)
    loss, _ = M.loss_fn(cfg, params, batch)
    grads = torch.autograd.grad(loss, leaves)
    return jcfg, jparams, cfg, params, jbatch, batch, (loss, grads)


def _rel_close(mine, theirs, rel, what):
    mine = mine.detach().numpy()
    theirs = np.asarray(theirs)
    scale = max(float(np.abs(theirs).max()), 1e-30)
    err = float(np.abs(mine - theirs).max())
    assert err <= rel * scale, f"{what}: {err} > {rel} x {scale}"


_JAX_STEPS = {}


@pytest.mark.parametrize("policy", POLICIES)
def test_policy_gradients(gemma, policy):
    jcfg, jparams, cfg, params, jbatch, batch, (ref_loss, ref_grads) = gemma
    leaves = O.tree_leaves(params)
    loss, _ = M.loss_fn(cfg, params, batch, remat=policy)
    grads = torch.autograd.grad(loss, leaves)
    assert torch.equal(loss, ref_loss)
    assert all(torch.equal(a, b) for a, b in zip(grads, ref_grads))
    # the aliases are the same JAX policy: one traced step each
    key = getattr(jax.checkpoint_policies, policy, policy)
    if key not in _JAX_STEPS:
        _JAX_STEPS[key] = jax.jit(jax.value_and_grad(
            lambda q: JM.loss_fn(jcfg, q, jbatch, remat=policy)[0]))(jparams)
    jloss, jgrads = _JAX_STEPS[key]
    _rel_close(loss, jloss, 1e-5, "loss")
    theirs = jax.tree.leaves(jgrads)
    assert len(theirs) == len(grads)
    for g, jg in zip(grads, theirs):
        _rel_close(g, jg, 1e-5, f"gradient under {policy}")


# ---------------------------------------------------------------------------
# what each policy keeps
# ---------------------------------------------------------------------------

class _Products(TorchDispatchMode):
    """Every product of the forward with a weak reference to its storage,
    and the products run again (grad mode on: the recompute) in the
    backward."""

    def __init__(self):
        super().__init__()
        self.backward = False
        self.made, self.again = [], []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        if func.overloadpacket in PRODUCTS:
            if not self.backward:
                self.made.append((out.numel(),
                                  StorageWeakRef(out.untyped_storage())))
            elif torch.is_grad_enabled():
                self.again.append(out.numel())
        return out


def _port_kept(fn, x, params):
    """(sizes of the products alive after the forward, of those that are
    not, of the products run again in the backward)."""
    x = torch.from_numpy(x.copy()).requires_grad_(True)
    leaves = [t.requires_grad_(True) for t in O.tree_leaves(params)
              if t.is_floating_point()]
    mode = _Products()
    with mode:
        with set_checkpoint_early_stop(False):   # recompute every region
            out = fn(x, params)
        gc.collect()
        kept = sorted(n for n, ref in mode.made if not ref.expired())
        dropped = sorted(n for n, ref in mode.made if ref.expired())
        mode.backward = True
        loss = sum(o.sum() for o in (out if isinstance(out, tuple)
                                     else (out,)))
        torch.autograd.grad(loss, [x] + leaves)
    return kept, dropped, mode.again


def _jax_kept(fn, policy, x, params, scanned=0):
    """Sizes of the dot outputs among the residuals of ``fn`` under
    ``policy``: every residual that is not an argument or a constant (a
    policy saves nothing else), a scanned layer's stacked residual split
    into one per layer."""
    res = saved_residuals(jax.checkpoint(
        fn, policy=getattr(jax.checkpoint_policies, policy)),
        jnp.asarray(x), params)
    sizes = []
    for aval, src in res:
        if "from the argument" in src or "from a constant" in src:
            continue
        shape = aval.shape
        if scanned and shape[0] == scanned:
            sizes += [int(np.prod(shape[1:]))] * scanned
        else:
            sizes.append(int(np.prod(shape)))
    return sorted(sizes)


def _positions():
    return (jnp.broadcast_to(jnp.arange(S), (B, S)),
            torch.broadcast_to(torch.arange(S, dtype=torch.int32), (B, S)))


def _dense(policy):
    jcfg, jparams, cfg = _bridge("phi3-medium-14b")
    jpos, pos = _positions()
    jlp = jax.tree.map(lambda a: a[0], jparams["trunk"]["layers"])
    return (lambda x, p: JT.block_fwd(jcfg, p, x, jpos, is_global=True),
            T._maybe_remat(lambda x, p: T.block_fwd(
                cfg, p, x, pos, is_global=True), policy), jlp, _torch(jlp),
            cfg, 0)


def _superblock(policy):
    """JAX's ``trunk_fwd`` super-block body (a remat'd scan over the
    local layers, then the global layer) against the port's ``trunk_fwd``
    on a one-super-block config."""
    jcfg, jparams, cfg = _bridge("gemma3-1b", num_layers=3)
    jpos, pos = _positions()

    def local_body(h, lp):
        return JT.block_fwd(jcfg, lp, h, jpos, is_global=False), None

    def super_body(h, sp):
        h, _ = lax.scan(JT._maybe_remat(local_body, policy), h, sp["local"])
        return JT.block_fwd(jcfg, sp["global"], h, jpos, is_global=True)
    stacked = jparams["trunk"]["super"]        # one super-block
    return (super_body,
            lambda x, p: T.trunk_fwd(cfg, {"super": p}, x, pos,
                                     remat=policy),
            jax.tree.map(lambda a: a[0], stacked), _torch(stacked), cfg,
            cfg.pattern_period - 1)


def _moe(policy):
    jcfg, jparams, cfg = _bridge("granite-moe-1b-a400m")
    jpos, pos = _positions()
    jlp = jax.tree.map(lambda a: a[0], jparams["moe_layers"])
    return (lambda x, p: JMO.moe_block_fwd(jcfg, p, x, jpos)[:2],
            T._maybe_remat(lambda x, p: MO.moe_block_fwd(
                cfg, p, x, pos)[:2], policy), jlp, _torch(jlp), cfg, 0)


def _ssm(policy):
    jcfg, jparams, cfg = _bridge("mamba2-370m", ssm_chunk=S // 2)
    jlp = jax.tree.map(lambda a: a[0], jparams["layers"])
    return (lambda x, p: JSS.block_fwd(jcfg, p, x)[0],
            T._maybe_remat(lambda x, p: SS.block_fwd(cfg, p, x)[0], policy),
            jlp, _torch(jlp), cfg, 0)


@pytest.mark.parametrize("policy", SELECTIVE)
@pytest.mark.parametrize("block", [_dense, _superblock, _moe, _ssm],
                         ids=["dense", "gemma_superblock", "moe", "ssm"])
def test_kept_products_match_saved_residuals(block, policy):
    jfn, fn, jparams, params, cfg, scanned = block(policy)
    x = np.random.default_rng(2).standard_normal(
        (B, S, cfg.d_model)).astype(np.float32)
    kept, dropped, again = _port_kept(fn, x, params)
    assert kept == _jax_kept(jfn, policy, x, jparams, scanned)
    assert not Counter(dropped) - Counter(again)
    if policy == "nothing_saveable":
        assert kept == [] and dropped


# ---------------------------------------------------------------------------
# names JAX refuses
# ---------------------------------------------------------------------------

FACTORIES = ("save_only_these_names", "save_any_names_but_these",
             "save_anything_except_these_names",
             "save_and_offload_only_these_names", "save_from_both_policies",
             "offload_dot_with_no_batch_dims")


@pytest.mark.parametrize("name,error",
                         [(n, TypeError) for n in FACTORIES]
                         + [("dots_everything", AttributeError)])
def test_refused_names(gemma, name, error):
    """Every name of ``jax.checkpoint_policies`` is either taken or a
    factory here; a factory fails at the first traced step in JAX and at
    the first step in the port, with the same exception type."""
    jcfg, jparams, cfg, params, jbatch, batch, _ = gemma
    assert set(POLICIES) - {"full"} | set(FACTORIES) == {
        n for n in dir(jax.checkpoint_policies) if not n.startswith("_")}
    with pytest.raises(error):
        jax.grad(lambda w: JT._maybe_remat(lambda v: jnp.sum(v @ v), name)(
            w))(jnp.ones((4, 4)))
    with pytest.raises(error, match=name):
        M.loss_fn(cfg, params, batch, remat=name)
