"""The port's training path against the JAX package's under bridged
weights: the superblock trunk, ``attention_fwd(use_flash=True)`` and the
chunked local attention, ``model.apply`` / ``loss_fn``, gradients, the
train step (remat, micro-batches), AdamW with float32 and int8 moments,
the synthetic data, checkpoints in both directions and the train CLI;
and the gradient guard of the kernel path.

The dense config is the gemma3-1b smoke config with 8 layers (period 3:
2 super-blocks of 2 local + 1 global, and 2 remainder locals), at float32;
sequences of 64 tokens take the chunked local path (S > 2W, window 16)
without the kernel and the kernel's plain version with ``use_flash``.
Tolerances, stated relative to the largest magnitude of each compared
quantity: the forward (logits, attention outputs, the loss) within
1e-5, the same float32 math summed in another order in two frameworks;
gradients, the three steps' losses and gradient norms within 1e-4 (the
backward sums over every position and layer).  Parameters after three
AdamW steps: each update is lr x m / (sqrt(v) + eps), a sign-like ratio
(exactly +-1 on the first step), so an element whose gradient is float
noise in both frameworks moves by up to lr in a noisy direction; such an
element may differ by up to 2 x the sum of the three learning rates (the
gap two opposite moves open), and at most 1e-3 of each leaf's elements
may differ by more than 1e-6.  A wrong update (decay, bias correction,
clipping, a dropped gradient) moves most elements of a leaf and fails
the second bound; measured: 92 of 1,184,384 elements past 1e-6 (at
most 17 in a leaf, the largest gap 6.1e-5).
"""
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as jax_smoke_config
from repro.data import pipeline as JD
from repro.models import layers as JL
from repro.models import model as JM
from repro.training import checkpoint as JC
from repro.training import optimizer as JO
from repro.training import trainer as JT
from repro_torch.bridge import params_from_numpy, tree_to_numpy
from repro_torch.configs import get_smoke_config
from repro_torch.data import pipeline as D
from repro_torch.launch import train as train_cli
from repro_torch.models import layers as L
from repro_torch.models import model as M
from repro_torch.models import transformer as T
from repro_torch.training import checkpoint as C
from repro_torch.training import optimizer as O
from repro_torch.training import trainer as TR

ARCH = "gemma3-1b"
SEQ = 64
LR = 1e-3
# parameters after three AdamW steps (see the module docstring)
PARAM_ATOL = 1e-6
PARAM_OUTLIERS = 1e-3


def _cfgs(arch=ARCH, **kw):
    return (jax_smoke_config(arch).replace(dtype="float32", **kw),
            get_smoke_config(arch).replace(dtype="float32", **kw))


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _rel_close(mine, theirs, rel, what=""):
    mine = mine.detach().numpy() if isinstance(mine, torch.Tensor) else mine
    theirs = np.asarray(theirs)
    scale = max(float(np.abs(theirs).max()), 1e-30)
    err = float(np.abs(mine - theirs).max())
    assert err <= rel * scale, f"{what}: {err} > {rel} x {scale}"


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _flat(tree[k], f"{prefix}{k}/")
    else:
        yield prefix.rstrip("/"), tree


def _jax_forward(jcfg, jparams, jbatch, use_flash=False):
    """JAX ``apply``'s logits and ``loss_fn``'s (loss, metrics), jitted."""
    return jax.jit(lambda p, b: (
        JM.apply(jcfg, p, b, use_flash=use_flash)[0],
        *JM.loss_fn(jcfg, p, b, use_flash=use_flash)))(jparams, jbatch)


def _clone(tree):
    return {k: (_clone(v) if isinstance(v, dict) else v.detach().clone())
            for k, v in tree.items()}


@pytest.fixture(scope="module")
def gemma():
    """(jax cfg, jax params, port cfg, port params, jax batch, port
    batch): 8 layers, 2 rows of 64 bigram tokens."""
    jcfg, cfg = _cfgs(num_layers=8)
    jparams = jax.jit(lambda k: JM.init_params(jcfg, k))(
        jax.random.PRNGKey(1))
    params = params_from_numpy(_np(jparams), device="cpu")
    toks = JD.synthetic_tokens(JD.DataConfig(), cfg.vocab_size, 2, SEQ, 0)
    jbatch = {"tokens": jnp.asarray(toks[:, :-1]),
              "targets": jnp.asarray(toks[:, 1:])}
    batch = {"tokens": torch.from_numpy(toks[:, :-1].copy()),
             "targets": torch.from_numpy(toks[:, 1:].copy())}
    return jcfg, jparams, cfg, params, jbatch, batch


# ---------------------------------------------------------------------------
# the superblock trunk, attention branches, apply and loss_fn
# ---------------------------------------------------------------------------

def test_superblock_params_have_the_jax_layout(gemma):
    jcfg, jparams, cfg, _, _, _ = gemma
    assert cfg.pattern_blocks() == (2, 2)
    mine = T.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    theirs = dict(_flat(_np(jparams)))
    ours = dict(_flat(mine))
    assert ours.keys() == theirs.keys()
    assert "trunk/super/local/attn/wq" in ours and \
        "trunk/rem_local/mlp/w_up" in ours
    for k, a in theirs.items():
        assert tuple(ours[k].shape) == a.shape, k
    assert M.count_params(mine) == sum(a.size for a in theirs.values())


@pytest.mark.parametrize("is_global", [False, True], ids=["local", "global"])
def test_attention_fwd_flash_matches_jax(gemma, is_global):
    """``use_flash=True``: the kernel's plain version against the Pallas
    kernel in interpret mode, on one layer's bridged weights."""
    jcfg, jparams, cfg, params, _, _ = gemma
    rng = np.random.default_rng(3)
    x = rng.standard_normal((2, SEQ, cfg.d_model)).astype(np.float32)
    pos = np.broadcast_to(np.arange(SEQ, dtype=np.int32), (2, SEQ))
    jp = jax.tree.map(lambda a: a[0, 0], jparams["trunk"]["super"]["local"])
    p = T._layer(T._layer(params["trunk"]["super"]["local"], 0), 0)
    mine = L.attention_fwd(cfg, p["attn"], torch.from_numpy(x),
                           torch.from_numpy(pos.copy()), is_global=is_global,
                           use_flash=True)
    theirs = jax.jit(lambda a, b, c: JL.attention_fwd(
        jcfg, a, b, c, is_global=is_global, use_flash=True))(
            jp["attn"], jnp.asarray(x), jnp.asarray(pos))
    for a, b in zip(mine, theirs):
        _rel_close(a, b, 1e-5, "attention_fwd(use_flash=True)")


def test_chunked_local_attention_matches_jax():
    rng = np.random.default_rng(5)
    qg = rng.standard_normal((2, 64, 2, 3, 16)).astype(np.float32)
    k, v = (rng.standard_normal((2, 64, 2, 16)).astype(np.float32)
            for _ in range(2))
    for softcap in (0.0, 5.0):
        mine = L._chunked_local_attention(
            *map(torch.from_numpy, (qg, k, v)), 16, 0.25, softcap)
        theirs = jax.jit(lambda *a: JL._chunked_local_attention(
            *a, 16, 0.25, softcap))(*map(jnp.asarray, (qg, k, v)))
        _rel_close(mine, theirs, 1e-5, f"chunked softcap {softcap}")


@pytest.mark.parametrize("use_flash", [False, True], ids=["plain", "flash"])
def test_apply_and_loss_match_jax(gemma, use_flash):
    jcfg, jparams, cfg, params, jbatch, batch = gemma
    with torch.no_grad():
        logits, aux = M.apply(cfg, params, batch, use_flash=use_flash)
        loss, metrics = M.loss_fn(cfg, params, batch, use_flash=use_flash)
    jlogits, jloss, jmetrics = _jax_forward(jcfg, jparams, jbatch,
                                            use_flash=use_flash)
    assert logits.shape == (2, SEQ, cfg.vocab_size) and float(aux) == 0.0
    _rel_close(logits, jlogits, 1e-5, "logits")
    _rel_close(loss, jloss, 1e-5, "loss")
    _rel_close(metrics["ce"], jmetrics["ce"], 1e-5, "ce")


def test_phi3_apply_matches_jax():
    jcfg, cfg = _cfgs("phi3-medium-14b")
    jparams = jax.jit(lambda k: JM.init_params(jcfg, k))(
        jax.random.PRNGKey(2))
    params = params_from_numpy(_np(jparams), device="cpu")
    toks = JD.synthetic_tokens(JD.DataConfig(seed=1), cfg.vocab_size, 2, 24, 0)
    batch = {"tokens": toks[:, :-1], "targets": toks[:, 1:]}
    with torch.no_grad():
        loss, _ = M.loss_fn(cfg, params, {k: torch.from_numpy(v.copy())
                                          for k, v in batch.items()})
        logits, _ = M.apply(cfg, params,
                            {"tokens": torch.from_numpy(toks[:, :-1].copy())})
    jlogits, jloss, _ = _jax_forward(jcfg, jparams, {
        k: jnp.asarray(v) for k, v in batch.items()})
    _rel_close(logits, jlogits, 1e-5, "logits")
    _rel_close(loss, jloss, 1e-5, "loss")


def test_remat_policies(gemma):
    """The recomputing policies give the plain forward's loss and
    gradients; a JAX policy the port does not have raises."""
    _, _, cfg, params, _, batch = gemma
    p = TR._with_grad(_clone(params))
    leaves = O.tree_leaves(p)
    ref_loss, _ = M.loss_fn(cfg, p, batch)
    ref_grads = torch.autograd.grad(ref_loss, leaves)
    for policy in ("full", "nothing_saveable"):
        loss, _ = M.loss_fn(cfg, p, batch, remat=policy)
        grads = torch.autograd.grad(loss, leaves)
        assert torch.equal(loss, ref_loss)
        assert all(torch.equal(a, b) for a, b in zip(grads, ref_grads))
    with pytest.raises(NotImplementedError, match="dots_saveable"):
        M.loss_fn(cfg, p, batch, remat="dots_saveable")


# ---------------------------------------------------------------------------
# gradients and the train step
# ---------------------------------------------------------------------------

def test_gradients_match_jax(gemma):
    jcfg, jparams, cfg, params, jbatch, batch = gemma
    p = TR._with_grad(_clone(params))
    loss, _ = M.loss_fn(cfg, p, batch)
    grads = torch.autograd.grad(loss, O.tree_leaves(p))
    jloss, jgrads = jax.jit(jax.value_and_grad(
        lambda q: JM.loss_fn(jcfg, q, jbatch)[0]))(jparams)
    _rel_close(loss, jloss, 1e-4, "loss")
    theirs = [a for _, a in _flat(_np(jgrads))]
    assert len(grads) == len(theirs) == len(list(_flat(params)))
    for (name, _), g, jg in zip(_flat(params), grads, theirs):
        _rel_close(g, jg, 1e-4, f"grad {name}")


@pytest.fixture(scope="module")
def three_steps(gemma):
    """Three steps of each package's train step from the same weights
    and batches (4 rows, 2 micro-batches, remat nothing_saveable)."""
    jcfg, jparams, cfg, params, _, _ = gemma
    ocfg = dict(learning_rate=LR, warmup_steps=1, total_steps=3)
    jt = JT.TrainConfig(optimizer=JO.OptimizerConfig(**ocfg),
                        microbatches=2, remat="nothing_saveable")
    tt = TR.TrainConfig(optimizer=O.OptimizerConfig(**ocfg),
                        microbatches=2, remat="nothing_saveable")
    batches = [JD.synthetic_tokens(JD.DataConfig(), cfg.vocab_size, 4, SEQ,
                                   s) for s in range(3)]
    jstep = jax.jit(JT.make_train_step(jcfg, jt))
    jstate = {"params": jparams, "opt": JO.init_opt_state(jt.optimizer,
                                                          jparams)}
    pparams = _clone(params)
    state = {"params": pparams, "opt": O.init_opt_state(tt.optimizer,
                                                        pparams)}
    step = TR.make_train_step(cfg, tt)
    jmetrics, metrics = [], []
    for toks in batches:
        jstate, m = jstep(jstate, {"tokens": jnp.asarray(toks[:, :-1]),
                                   "targets": jnp.asarray(toks[:, 1:])})
        jmetrics.append({k: float(v) for k, v in m.items()})
        t = torch.from_numpy(toks)
        state, m = step(state, {"tokens": t[:, :-1], "targets": t[:, 1:]})
        metrics.append({k: float(v) for k, v in m.items()})
    return jstate, jmetrics, state, metrics


def test_train_steps_match_jax(three_steps):
    jstate, jmetrics, state, metrics = three_steps
    assert [set(m) for m in metrics] == [set(m) for m in jmetrics]
    for m, jm in zip(metrics, jmetrics):
        for key in ("loss", "ce", "grad_norm", "lr"):
            assert abs(m[key] - jm[key]) <= 1e-4 * abs(jm[key]), (key, m, jm)
    assert int(state["opt"]["step"]) == int(jstate["opt"]["step"]) == 3
    theirs = dict(_flat(_np(jstate["params"])))
    lr_sum = sum(m["lr"] for m in jmetrics)
    for name, p in _flat(state["params"]):
        assert p.requires_grad and p.is_leaf
        diff = np.abs(p.detach().numpy() - theirs[name])
        assert diff.max() <= 2 * lr_sum, (name, diff.max())
        assert np.mean(diff > PARAM_ATOL) <= PARAM_OUTLIERS, \
            (name, np.mean(diff > PARAM_ATOL), diff.max())


def test_train_step_through_the_kernel_raises(gemma):
    """``use_flash`` has no backward: the first step raises instead of
    returning gradients that miss the attention."""
    _, _, cfg, params, _, batch = gemma
    tcfg = TR.TrainConfig(use_flash=True, remat=None)
    p = _clone(params)
    state = {"params": p, "opt": O.init_opt_state(tcfg.optimizer, p)}
    with pytest.raises(NotImplementedError, match="no backward"):
        TR.make_train_step(cfg, tcfg)(state, batch)


def test_loss_through_the_kernel_refuses_backward(gemma):
    jcfg, jparams, cfg, params, jbatch, batch = gemma
    p = TR._with_grad(_clone(params))
    with pytest.raises(NotImplementedError, match="no backward"):
        M.loss_fn(cfg, p, batch, use_flash=True)[0].backward()
    with torch.no_grad():
        loss, _ = M.loss_fn(cfg, p, batch, use_flash=True)
    assert torch.isfinite(loss)
    # the reference raises too: its Pallas kernel has no custom_vjp
    with pytest.raises(Exception):
        jax.grad(lambda q: JM.loss_fn(jcfg, q, jbatch,
                                      use_flash=True)[0])(jparams)


def test_ssm_kernel_path_refuses_backward():
    _, cfg = _cfgs("mamba2-370m")
    params = TR._with_grad(M.init_params(cfg, torch.Generator().manual_seed(0),
                                         "cpu"))
    toks = torch.from_numpy(JD.synthetic_tokens(JD.DataConfig(),
                                                cfg.vocab_size, 1, 8, 0))
    batch = {"tokens": toks[:, :-1], "targets": toks[:, 1:]}
    with pytest.raises(NotImplementedError, match="ssd_scan has no backward"):
        M.loss_fn(cfg, params, batch, use_kernel=True)
    loss, _ = M.loss_fn(cfg, params, batch, remat="full")
    loss.backward()
    assert params["embed"]["table"].grad is not None


# ---------------------------------------------------------------------------
# optimizer, data, checkpoints, CLI
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("moments", ["float32", "int8"])
def test_adamw_update_matches_jax(moments):
    """Two updates of a small tree from the same gradients: equal int8
    moment bytes and scales, parameters within 1e-6."""
    rng = np.random.default_rng(11)
    params = {"a": rng.standard_normal((3, 300)).astype(np.float32),
              "b": {"c": rng.standard_normal((5,)).astype(np.float32)}}
    grads = [{"a": rng.standard_normal((3, 300)).astype(np.float32) * s,
              "b": {"c": rng.standard_normal((5,)).astype(np.float32) * s}}
             for s in (0.1, 3.0)]
    ocfg = dict(learning_rate=1e-2, warmup_steps=2, total_steps=10,
                moments_dtype=moments)
    jcfg, cfg = JO.OptimizerConfig(**ocfg), O.OptimizerConfig(**ocfg)
    jp = jax.tree.map(jnp.asarray, params)
    jstate = JO.init_opt_state(jcfg, jp)
    p = params_from_numpy(params, device="cpu")
    state = O.init_opt_state(cfg, p)
    for g in grads:
        jp, jstate, jm = JO.adamw_update(jcfg, jax.tree.map(jnp.asarray, g),
                                         jstate, jp)
        p, state, m = O.adamw_update(cfg, params_from_numpy(g, device="cpu"),
                                     state, p)
        for key in ("grad_norm", "lr"):
            assert abs(float(m[key]) - float(jm[key])) <= 1e-6 * \
                abs(float(jm[key]))
    for (name, a), (_, b) in zip(_flat(p), _flat(_np(jp))):
        np.testing.assert_allclose(a.numpy(), b, rtol=0, atol=1e-6,
                                   err_msg=name)
    for which in ("m", "v"):
        for (name, a), (_, b) in zip(_flat(state[which]),
                                     _flat(_np(jstate[which]))):
            if moments == "int8" and name.endswith("/q"):
                assert a.dtype == torch.int8
                assert np.array_equal(a.numpy(), b), name
            else:
                np.testing.assert_allclose(a.numpy(), b, rtol=1e-6,
                                           atol=1e-12, err_msg=name)


def test_bridge_carries_superblocks_and_optimizer_state(gemma):
    """A JAX superblock trunk and its int8-moment AdamW state cross the
    bridge with keys, shapes, dtypes and values (the int32 step stays a
    scalar, q8 moments stay {"q" int8, "scale"} leaves), and
    ``tree_to_numpy`` brings them back."""
    _, jparams, _, _, _, _ = gemma
    ocfg = JO.OptimizerConfig(moments_dtype="int8")
    jstate = _np(jax.jit(lambda p: JO.init_opt_state(ocfg, p))(jparams))
    state = params_from_numpy(jstate, device="cpu")
    assert state["step"].shape == () and state["step"].dtype == torch.int32
    q8 = state["m"]["trunk"]["super"]["local"]["mlp"]["w_up"]
    assert set(q8) == {"q", "scale"} and q8["q"].dtype == torch.int8
    mine, theirs = dict(_flat(tree_to_numpy(state))), dict(_flat(jstate))
    assert mine.keys() == theirs.keys()
    for k, a in theirs.items():
        assert mine[k].dtype == a.dtype and np.array_equal(mine[k], a), k


def test_train_loop_logs_every_step():
    _, cfg = _cfgs()
    from repro_torch.configs import InputShape
    it = D.data_iterator(cfg, InputShape("t", 16, 2, "train"), device="cpu")
    tcfg = TR.TrainConfig(optimizer=O.OptimizerConfig(warmup_steps=1,
                                                      total_steps=2))
    seen = []
    state, hist = TR.train_loop(cfg, tcfg, it, 2, log_every=1,
                                generator=torch.Generator().manual_seed(0),
                                device="cpu",
                                callback=lambda i, m: seen.append(i))
    assert [h["step"] for h in hist] == seen == [0, 1]
    assert all(np.isfinite(h["loss"]) for h in hist)
    assert int(state["opt"]["step"]) == 2


def test_synthetic_tokens_are_bit_equal():
    for dcfg in (D.DataConfig(), D.DataConfig(seed=3, branching=2,
                                              shard_index=1, num_shards=2)):
        jd = JD.DataConfig(**dcfg.__dict__)
        for step in (0, 5):
            mine = D.synthetic_tokens(dcfg, 512, 3, 40, step)
            assert mine.dtype == np.int32
            assert np.array_equal(mine, JD.synthetic_tokens(jd, 512, 3, 40,
                                                            step))
    from repro.configs import InputShape as JShape
    from repro_torch.configs import InputShape
    jcfg, cfg = _cfgs()
    it = D.data_iterator(cfg, InputShape("t", 16, 4, "train"),
                         D.DataConfig(branching=4), device="cpu")
    jit = JD.data_iterator(jcfg, JShape("t", 16, 4, "train"),
                           JD.DataConfig(branching=4))
    for _ in range(2):
        b, jb = next(it), next(jit)
        for k in ("tokens", "targets"):
            assert b[k].dtype == torch.int32
            assert np.array_equal(b[k].numpy(), np.asarray(jb[k]))


def _state_tree():
    """A params + int8-moment optimizer state with a bfloat16 leaf."""
    rng = np.random.default_rng(4)
    params = {"w": rng.standard_normal((4, 300)).astype(np.float32),
              "n": {"scale": rng.standard_normal((7,)).astype(np.float32)}}
    p = params_from_numpy(params, device="cpu")
    p["n"]["bf"] = torch.from_numpy(rng.standard_normal((3, 5)).astype(
        np.float32)).to(torch.bfloat16)
    state = O.init_opt_state(O.OptimizerConfig(moments_dtype="int8"), p)
    state["m"]["w"] = O._q8_encode(p["w"] * 0.01)
    state["step"] = torch.tensor(7, dtype=torch.int32)
    return {"params": p, "opt": state}


def test_checkpoints_cross_both_ways(tmp_path):
    tree = _state_tree()
    C.save(str(tmp_path / "port"), tree, {"arch": "x"})
    like = jax.tree.map(jnp.asarray, tree_to_numpy(tree))
    restored = JC.restore(str(tmp_path / "port"), like)
    for (name, t), (_, j) in zip(_flat(tree), _flat(restored)):
        if t.dtype == torch.bfloat16:
            assert j.dtype == jnp.bfloat16
            assert np.array_equal(np.asarray(j, np.float32), t.float().numpy())
        else:
            assert np.array_equal(np.asarray(j), t.numpy()), name
    # the JAX package's file, restored by the port
    jtree = jax.tree.map(lambda t: jnp.asarray(t.float().numpy(),
                                               jnp.bfloat16)
                         if t.dtype == torch.bfloat16 else
                         jnp.asarray(t.numpy()), tree)
    JC.save(str(tmp_path / "jax"), jtree, {"arch": "x"})
    back = C.restore(str(tmp_path / "jax"), tree)
    for (name, t), (_, b) in zip(_flat(tree), _flat(back)):
        assert b.dtype == t.dtype and b.shape == t.shape, name
        assert torch.equal(b, t), name
    assert int(back["opt"]["step"]) == 7 and back["opt"]["step"].dim() == 0


def test_train_cli_prints_the_jax_keys(capsys, three_steps):
    _, jmetrics, _, _ = three_steps
    train_cli.main(["--device", "cpu", "--scale", "smoke", "--steps", "3",
                    "--batch", "4", "--seq", "32", "--microbatches", "2",
                    "--log-every", "1"])
    lines = [json.loads(ln) for ln in capsys.readouterr().out.splitlines()]
    assert [ln["step"] for ln in lines] == [0, 1, 2]
    assert all(set(ln) == {"step", "elapsed_s"} | set(jmetrics[0])
               for ln in lines)
    assert all(np.isfinite(ln["loss"]) for ln in lines)
    if not torch.cuda.is_available():        # the default device is cuda
        with pytest.raises(RuntimeError, match="device='cpu'"):
            train_cli.main(["--steps", "1"])
