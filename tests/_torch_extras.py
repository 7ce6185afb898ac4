"""Shared checks of ``tests/test_torch_vlm.py`` and
``tests/test_torch_encdec.py``: the two families whose requests carry
extras (the stub frontends' image or audio embeddings), held to the JAX
package on bridged weights at float32.

Tolerances, relative to the largest magnitude of each compared
quantity: outputs, logits and float pages within rtol 1e-5 / atol 1e-5 x
max (the same float32 math summed in another order); gradients within
1e-4; int8 pages one level in at most 1e-3 of the bytes (float noise
across a rounding boundary), and logits of a call on an int8 pool within
1e-4 (the call quantizes the K/V it writes and attends that round
trip).  Engine tokens, ``stats()``, prefix hits and persisted chains
must be equal.
"""
import argparse

import jax
import jax.numpy as jnp
import numpy as np
import torch

from repro.configs import get_smoke_config as jax_smoke_config
from repro.launch import serve as jax_serve
from repro.models import model as JM
from repro.serving import EdgeServingEngine as JaxEngine
from repro.serving import Request as JaxRequest
from repro.serving import ServeConfig as JaxServeConfig
from repro_torch.bridge import params_from_numpy
from repro_torch.configs import get_smoke_config
from repro_torch.launch import serve
from repro_torch.models import model as M
from repro_torch.serving import EdgeServingEngine, Request, ServeConfig

REL = 1e-5
GRAD_REL = 1e-4
INT8_MOVED = 1e-3
INT8_REL = 1e-4
B, MAX_LEN, NB, BS = 3, 96, 40, 8
N_BLK = MAX_LEN // BS


def bridge(arch, seed=0, **kw):
    """(JAX cfg, JAX params, port cfg, port params) of the smoke config
    at float32, the JAX weights bridged into the port."""
    jcfg = jax_smoke_config(arch).replace(dtype="float32", **kw)
    jparams = jax.jit(lambda key: JM.init_params(jcfg, key))(
        jax.random.PRNGKey(seed))
    cfg = get_smoke_config(arch).replace(dtype="float32", **kw)
    return jcfg, jparams, cfg, params_from_numpy(
        jax.tree.map(np.asarray, jparams), device="cpu")


def extras_key(cfg):
    return M.EXTRAS_KEY[cfg.family]


def extras_shape(cfg):
    if cfg.family == "vlm":
        return (cfg.num_image_tokens, cfg.image_embed_dim)
    return (cfg.encoder_seq, cfg.d_model)


def prefix(cfg):
    return cfg.num_image_tokens if cfg.family == "vlm" else 0


def extras(cfg, rng):
    """One request's extras dict, as the JAX tests draw it."""
    return {extras_key(cfg): rng.normal(0, 0.1, extras_shape(cfg))
            .astype(np.float32)}


def batch_extras(cfg, rng, b):
    return rng.normal(0, 0.1, (b,) + extras_shape(cfg)).astype(np.float32)


def np_(t):
    return t.detach().numpy() if isinstance(t, torch.Tensor) \
        else np.asarray(t)


def close(mine, theirs, rel=REL, what=""):
    a, b = np_(mine).astype(np.float64), np_(theirs).astype(np.float64)
    assert a.shape == b.shape, (what, a.shape, b.shape)
    np.testing.assert_allclose(a, b, rtol=rel,
                               atol=rel * max(np.abs(b).max(), 1e-30),
                               err_msg=what)


def close_tree(mine, theirs):
    """Caches: int leaves equal, int8 pages within one level in at most
    ``INT8_MOVED`` of the bytes, float leaves within ``REL``."""
    assert set(mine) == set(theirs)
    for key, leaf in mine.items():
        if isinstance(leaf, dict):
            close_tree(leaf, theirs[key])
            continue
        a, b = np_(leaf), np_(theirs[key])
        assert a.shape == b.shape and a.dtype == b.dtype, key
        if a.dtype == np.int8:
            d = np.abs(a.astype(np.int32) - b.astype(np.int32))
            assert d.max() <= 1 and (d > 0).mean() <= INT8_MOVED, key
        elif a.dtype.kind in "iu":
            assert np.array_equal(a, b), key
        else:
            close(a, b, what=key)


def copy_into(mine, theirs):
    for key, leaf in mine.items():
        if isinstance(leaf, dict):
            copy_into(leaf, theirs[key])
        else:
            leaf.copy_(torch.from_numpy(np.array(theirs[key])))


def flat(tree, prefix_=""):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from flat(v, f"{prefix_}{k}.")
        else:
            yield f"{prefix_}{k}", v


# ---------------------------------------------------------------------------
# the model API
# ---------------------------------------------------------------------------

def check_forward_and_loss(models):
    """``apply`` (the vlm's logits over image + text), ``loss_fn``
    (aligned to the text) and its gradients against JAX."""
    jcfg, jparams, cfg, params = models
    rng = np.random.default_rng(1)
    key = extras_key(cfg)
    toks = rng.integers(0, cfg.vocab_size, (2, 12)).astype(np.int32)
    tgt = rng.integers(0, cfg.vocab_size, (2, 12)).astype(np.int32)
    e = batch_extras(cfg, rng, 2)
    jb = {"tokens": jnp.asarray(toks), "targets": jnp.asarray(tgt),
          key: jnp.asarray(e)}
    b = {"tokens": torch.from_numpy(toks), "targets": torch.from_numpy(tgt),
         key: torch.from_numpy(e)}
    jlog, _ = jax.jit(lambda p_, b_: JM.apply(jcfg, p_, b_))(jparams, jb)
    log, aux = M.apply(cfg, params, b)
    assert log.shape == (2, prefix(cfg) + 12, cfg.vocab_size)
    close(log, jlog, what="logits")
    assert float(aux) == 0.0

    def grad_tree(node):
        if isinstance(node, dict):
            return {k: grad_tree(v) for k, v in node.items()}
        return node.clone().requires_grad_(True)
    p = grad_tree(params)
    loss, m = M.loss_fn(cfg, p, b)
    names, leaves = zip(*flat(p))
    grads = torch.autograd.grad(loss, leaves)
    jloss, jgrads = jax.jit(jax.value_and_grad(
        lambda q: JM.loss_fn(jcfg, q, jb)[0]))(jparams)
    close(loss, jloss, what="loss")
    close(m["ce"], jloss, what="ce")
    theirs = dict(flat(jax.tree.map(np.asarray, jgrads)))
    assert set(names) == set(theirs)
    for name, g in zip(names, grads):
        close(g, theirs[name], rel=GRAD_REL, what=name)
    return dict(zip(names, grads))


def check_prefill_and_decode(models):
    """Dense ``prefill`` with ragged text lengths, then two
    ``decode_step`` waves (positions past the vlm's image): logits and
    the whole cache."""
    jcfg, jparams, cfg, params = models
    rng = np.random.default_rng(3)
    key = extras_key(cfg)
    toks = rng.integers(0, cfg.vocab_size, (B, 20)).astype(np.int32)
    e = batch_extras(cfg, rng, B)
    n = np.array([20, 13, 4], np.int32)
    jlog, jc = jax.jit(lambda p_, t_, e_, n_: JM.prefill(
        jcfg, p_, {"tokens": t_, key: e_}, MAX_LEN, true_len=n_))(
            jparams, jnp.asarray(toks), jnp.asarray(e), jnp.asarray(n))
    log, c = M.prefill(cfg, params, {"tokens": torch.from_numpy(toks),
                                     key: torch.from_numpy(e)},
                       MAX_LEN, true_len=torch.from_numpy(n))
    close(log, jlog, what="prefill")
    close_tree(c, jc)
    pos = n + prefix(cfg)
    for step in range(2):
        tok = rng.integers(0, cfg.vocab_size, (B, 1)).astype(np.int32)
        jlog, jc = jax.jit(lambda *a: JM.decode_step(jcfg, *a))(
            jparams, jc, jnp.asarray(tok), jnp.asarray(pos))
        log, c = M.decode_step(cfg, params, c, torch.from_numpy(tok),
                               torch.from_numpy(pos))
        close(log, jlog, what=f"decode {step}")
        pos = pos + 1
    close_tree(c, jc)


def check_paged_entry_points(models, kv_dtype, use_pallas):
    """``prefill_paged`` cold (text lengths 20, 13, 4 into slots 2, 0,
    1, the image prefix first on the vlm), a radix-hit suffix prefill
    (ctx_len past the image, mid-page and page-aligned, through full
    tables; audio rebuilt from the extras), a decode wave (the third
    row idle: its table is -1) and an extend wave (valid_len 4, 2, 4),
    through the gather read or the kernel read (plain versions here),
    on a float and an int8 pool: logits of real rows and every page (on
    the int8 pool each call reads the JAX call's pages)."""
    jcfg, jparams, cfg, params = models
    rel = REL if kv_dtype is None else INT8_REL
    rng = np.random.default_rng(6)
    key = extras_key(cfg)
    P = prefix(cfg)
    tokens = rng.integers(0, cfg.vocab_size, (B, 20)).astype(np.int32)
    e = batch_extras(cfg, rng, B)
    true_len = np.array([20, 13, 4], np.int32)
    slots = np.array([2, 0, 1], np.int32)
    n_w = -(-(P + 20) // BS)
    perm = rng.permutation(NB).astype(np.int32)
    tables = np.full((B, N_BLK), -1, np.int32)
    for b, row in enumerate(np.array_split(perm[:3 * (n_w + 2)], 3)):
        tables[b, :len(row)] = row
    wt = tables[slots, :n_w].copy()
    jc = JM.init_paged_cache(jcfg, B, MAX_LEN, NB, BS, kv_dtype=kv_dtype)
    c = M.init_paged_cache(cfg, B, MAX_LEN, NB, BS, kv_dtype=kv_dtype,
                           device="cpu")

    def both(jfn, fn, args):
        jout = jax.jit(jfn)(jparams, jc, *[jnp.asarray(a) for a in args])
        out = fn(params, c, *[torch.from_numpy(a) for a in args])
        if kv_dtype == "int8":
            close_tree(out[1], jout[1])
            copy_into(out[1], jout[1])
        return jout, out

    (jlog, jc), (log, c) = both(
        lambda p_, c_, t_, e_, s_, w_, n_: JM.prefill_paged(
            jcfg, p_, {"tokens": t_, key: e_}, MAX_LEN, c_, slots=s_,
            write_tables=w_, true_len=n_),
        lambda p_, c_, t_, e_, s_, w_, n_: M.prefill_paged(
            cfg, p_, {"tokens": t_, key: e_}, MAX_LEN, c_, slots=s_,
            write_tables=w_, true_len=n_),
        (tokens, e, slots, wt, true_len))
    close(log, jlog, rel=rel, what="cold prefill")
    close_tree(c, jc)

    # hit suffixes reading the chains of slots 2 (row 0) and 0 (row 1):
    # a mid-page context and a page-aligned one, both past the image,
    # sharing the chain's pages up to the context's end (the suffix
    # writes on in the last, partial one) and fresh pages after
    ctx = np.array([P + 13, P + 8], np.int32)
    hit_n = np.array([6, 4], np.int32)
    fresh = iter(perm[3 * (n_w + 2):])
    hit_tables = np.full((2, N_BLK), -1, np.int32)
    for i, (src, L) in enumerate(((2, ctx[0]), (0, ctx[1]))):
        held = -(-int(L) // BS)
        hit_tables[i, :held] = tables[src, :held]
        hit_tables[i, held:held + 2] = [next(fresh), next(fresh)]
    suffix = rng.integers(0, cfg.vocab_size, (2, 6)).astype(np.int32)
    (jlog, jc), (log, c) = both(
        lambda p_, c_, t_, e_, s_, w_, x_, n_: JM.prefill_paged(
            jcfg, p_, {"tokens": t_, key: e_}, MAX_LEN, c_, slots=s_,
            write_tables=w_, ctx_tables=w_, ctx_len=x_, true_len=n_),
        lambda p_, c_, t_, e_, s_, w_, x_, n_: M.prefill_paged(
            cfg, p_, {"tokens": t_, key: e_}, MAX_LEN, c_, slots=s_,
            write_tables=w_, ctx_tables=w_, ctx_len=x_, true_len=n_),
        (suffix, e[[0, 1]], np.array([0, 1], np.int32), hit_tables, ctx,
         hit_n))
    close(log, jlog, rel=rel, what="hit prefill")
    close_tree(c, jc)

    pos = np.zeros((B,), np.int32)
    pos[slots] = true_len + P
    wave_tables = tables.copy()
    wave_tables[1] = -1                       # an idle slot mid-run
    tok = rng.integers(0, cfg.vocab_size, (B, 1)).astype(np.int32)
    (jlog, jc), (log, c) = both(
        lambda p_, c_, t_, q_, b_: JM.decode_step_paged(
            jcfg, p_, c_, t_, q_, b_, use_pallas),
        lambda p_, c_, t_, q_, b_: M.decode_step_paged(
            cfg, p_, c_, t_, q_, b_, use_pallas),
        (tok, pos, wave_tables))
    close(log[[0, 2]], np.asarray(jlog)[[0, 2]], rel=rel, what="decode")

    toks = rng.integers(0, cfg.vocab_size, (B, 4)).astype(np.int32)
    valid = np.array([4, 2, 4], np.int32)
    (jlog, jc), (log, c) = both(
        lambda p_, c_, t_, q_, b_, v_: JM.extend_paged(
            jcfg, p_, c_, t_, q_, b_, v_, use_pallas),
        lambda p_, c_, t_, q_, b_, v_: M.extend_paged(
            cfg, p_, c_, t_, q_, b_, v_, use_pallas),
        (toks, pos + 1, tables, valid))
    for b in range(B):
        close(log[b, :valid[b]], np.asarray(jlog)[b, :valid[b]], rel=rel,
              what=f"extend row {b}")
    close_tree(c, jc)


def check_dense_admission_and_extend(models):
    """The dense engine's admission (``prefill_paged`` with
    ``write_tables=None`` into ``init_cache`` strips at slots 1, 2) and
    the dense twin's ``extend`` (valid_len 3, 1, 2)."""
    jcfg, jparams, cfg, params = models
    rng = np.random.default_rng(8)
    key = extras_key(cfg)
    toks = rng.integers(0, cfg.vocab_size, (2, 16)).astype(np.int32)
    e = batch_extras(cfg, rng, 2)
    n = np.array([16, 9], np.int32)
    slots = np.array([1, 2], np.int32)
    jc = JM.init_cache(jcfg, B, MAX_LEN)
    c = M.init_cache(cfg, B, MAX_LEN, "cpu")
    jlog, jc = jax.jit(lambda p_, c_, t_, e_, s_, n_: JM.prefill_paged(
        jcfg, p_, {"tokens": t_, key: e_}, MAX_LEN, c_, slots=s_,
        true_len=n_))(jparams, jc, jnp.asarray(toks), jnp.asarray(e),
                      jnp.asarray(slots), jnp.asarray(n))
    log, c = M.prefill_paged(cfg, params, {"tokens": torch.from_numpy(toks),
                                           key: torch.from_numpy(e)},
                             MAX_LEN, c, slots=torch.from_numpy(slots),
                             true_len=torch.from_numpy(n))
    close(log, jlog, what="dense admission")
    close_tree(c, jc)
    P = prefix(cfg)
    pos = np.array([0, 16 + P, 9 + P], np.int32)
    ext = rng.integers(0, cfg.vocab_size, (B, 3)).astype(np.int32)
    valid = np.array([3, 1, 2], np.int32)
    jlog, jc = jax.jit(lambda *a: JM.extend(jcfg, *a))(
        jparams, jc, jnp.asarray(ext), jnp.asarray(pos), jnp.asarray(valid))
    log, c = M.extend(cfg, params, c, torch.from_numpy(ext),
                      torch.from_numpy(pos), torch.from_numpy(valid))
    for b in range(1, B):
        close(log[b, :valid[b]], np.asarray(jlog)[b, :valid[b]],
              what=f"extend row {b}")
    close_tree(c, jc)


# ---------------------------------------------------------------------------
# the engine against the JAX engine
# ---------------------------------------------------------------------------

ENGINE_BASE = dict(max_slots=3, max_len=MAX_LEN, prefill_buckets=(8, 16),
                   seed=3)
ENGINE_CASES = {
    "fifo": dict(policy="fifo"),
    "priority": dict(policy="priority"),
    "chunked": dict(policy="fifo", chunked_prefill=True, catch_chunk=6,
                    wave_tokens=14),
    "int8-kernel": dict(policy="priority", quant_kv="int8",
                        use_pallas_paged=True),
    "int8-chunked": dict(policy="fifo", quant_kv="int8",
                         use_pallas_paged=True, chunked_prefill=True),
    "dense-twin": dict(policy="fifo", paged=False),
}
LENS = (5, 21, 9, 40, 3, 17, 33)
MAX_NEW = (3, 8, 2, 6, 10, 4, 5)


def traffic(request_cls, cfg, shared=False):
    """Seven requests of 3-40 text tokens, each with its own extras;
    with ``shared`` the odd uids reuse the extras and the first 12
    prompt tokens of uid 0 (hits on the prefix cache)."""
    rng = np.random.default_rng(42)
    reqs = []
    for u, n in enumerate(LENS):
        e = extras(cfg, rng)
        p = rng.integers(0, cfg.vocab_size, n, dtype=np.int32)
        if shared and u % 2 and reqs:
            e = dict(reqs[0].extras)
            p = np.concatenate([reqs[0].prompt[:12], p])
        reqs.append(request_cls(uid=u, prompt=p, max_new_tokens=MAX_NEW[u],
                                priority=u % 3, deadline=float(u),
                                extras=e))
    return reqs


def drain(eng, reqs):
    for r in reqs:
        eng.submit(r)
    eng.run_until_drained()
    return {r.uid: tuple(r.generated) for r in eng.completed}


def replay(models, case, shared=False):
    """(JAX engine, its tokens, port engine, its tokens) on ``case``."""
    jcfg, jparams, cfg, params = models
    kw = dict(ENGINE_BASE, **ENGINE_CASES[case])
    jeng = JaxEngine(jcfg, jparams, JaxServeConfig(**kw))
    jtok = drain(jeng, traffic(JaxRequest, jcfg, shared))
    eng = EdgeServingEngine(cfg, params, ServeConfig(**kw), device="cpu")
    return jeng, jtok, eng, drain(eng, traffic(Request, cfg, shared))


def reference_decode(cfg, params, prompt, max_new, extras_, max_len):
    """``test_decode_consistency._reference_decode`` on the port: one
    unpadded prefill, then one ``decode_step`` a token."""
    batch = {"tokens": torch.from_numpy(np.asarray(prompt, np.int32))[None]}
    for k, v in extras_.items():
        batch[k] = torch.from_numpy(v)[None]
    logits, cache = M.prefill(cfg, params, batch, max_len)
    tok = int(torch.argmax(logits[0, -1]))
    out, pos = [tok], len(prompt) + prefix(cfg)
    for _ in range(max_new - 1):
        lg, cache = M.decode_step(cfg, params, cache,
                                  torch.tensor([[tok]], dtype=torch.int32),
                                  torch.full((1,), pos, dtype=torch.int32))
        tok = int(torch.argmax(lg[0, -1]))
        out.append(tok)
        pos += 1
    return out


def check_padded_admission(models):
    """``test_decode_consistency.test_padded_admission_matches_reference``
    on the port: 5 / 17 / 33 text tokens into buckets (8, 16), the
    longer two catching up through extend waves, each request's tokens
    equal to the sequential reference."""
    _, _, cfg, params = models
    rng = np.random.default_rng(0)
    eng = EdgeServingEngine(cfg, params, ServeConfig(
        max_slots=3, max_len=96, prefill_buckets=(8, 16)), device="cpu")
    reqs = []
    for uid, n in enumerate([5, 17, 33]):
        e = extras(cfg, rng)
        r = Request(uid=uid, prompt=rng.integers(0, cfg.vocab_size, n,
                                                 dtype=np.int32),
                    max_new_tokens=6, extras=e)
        reqs.append(r)
        eng.submit(r)
    eng.run_until_drained()
    assert eng.extend_waves >= 1
    for r in reqs:
        assert list(r.generated) == reference_decode(
            cfg, params, r.prompt, 6, r.extras, 96), len(r.prompt)


def check_decode_matches_forward(models):
    """``test_decode_consistency.test_decode_matches_forward`` on the
    port: a prefill of 8 text tokens and one decode step equal the
    full forward's last logits (at float32: within REL)."""
    _, _, cfg, params = models
    rng = np.random.default_rng(4)
    key = extras_key(cfg)
    toks = torch.from_numpy(rng.integers(0, cfg.vocab_size, (2, 9))
                            .astype(np.int32))
    e = torch.from_numpy(batch_extras(cfg, rng, 2))
    _, cache = M.prefill(cfg, params, {"tokens": toks[:, :8], key: e}, 48)
    pos = torch.full((2,), prefix(cfg) + 8, dtype=torch.int32)
    step, _ = M.decode_step(cfg, params, cache, toks[:, 8:9], pos)
    full, _ = M.apply(cfg, params, {"tokens": toks, key: e})
    close(step[:, 0], full[:, -1], what="decode vs forward")


# ---------------------------------------------------------------------------
# prefix cache, persistence and speculation (the JAX per-family cases)
# ---------------------------------------------------------------------------

def shared_traffic(request_cls, cfg, n=4, sys_len=24):
    """``tests/test_prefix_cache.py``'s ``_shared_traffic``: n requests
    on one system prompt and the same extras, mixed sampling."""
    rng = np.random.default_rng(7)
    sys_prompt = rng.integers(0, cfg.vocab_size, sys_len, dtype=np.int32)
    ext = extras(cfg, np.random.default_rng(0))
    reqs = []
    for uid in range(n):
        tail = np.random.default_rng(50 + uid).integers(
            0, cfg.vocab_size, 4 + uid, dtype=np.int32)
        reqs.append(request_cls(
            uid=uid, prompt=np.concatenate([sys_prompt, tail]),
            max_new_tokens=5, extras=dict(ext),
            temperature=0.8 if uid % 2 else 0.0, top_k=6 if uid % 2 else 0))
    return reqs


SEQ = dict(max_slots=2, max_len=96, prefill_buckets=(16, 32), seed=5)


def sequential(eng, reqs):
    for r in reqs:
        eng.submit(r)
        eng.run_until_drained()
    return {r.uid: tuple(r.generated) for r in eng.completed}


def no_leak(eng):
    eng.pool.assert_consistent()
    assert (eng.pool.num_free + eng.prefix_cache.num_blocks
            == eng.pool.num_blocks)


def check_hit_equals_cold_and_jax(models):
    """``test_prefix_hit_decode_bit_identical_to_cold`` on the port, and
    the port's hits, hit tokens and greedy tokens equal to the JAX
    prefix engine's (sampled tokens: equal to the port's own cold run,
    the generators differ from JAX's)."""
    jcfg, jparams, cfg, params = models
    cold = sequential(EdgeServingEngine(cfg, params, ServeConfig(
        prefix_cache=False, **SEQ), device="cpu"),
        shared_traffic(Request, cfg))
    eng = EdgeServingEngine(cfg, params, ServeConfig(prefix_cache=True,
                                                     **SEQ), device="cpu")
    hot = sequential(eng, shared_traffic(Request, cfg))
    assert hot == cold
    st = eng.prefix_cache.stats()
    assert st["hits"] >= 2, st
    no_leak(eng)
    jeng = JaxEngine(jcfg, jparams, JaxServeConfig(prefix_cache=True, **SEQ))
    jhot = sequential(jeng, shared_traffic(JaxRequest, jcfg))
    assert st == jeng.prefix_cache.stats()
    assert {u: t for u, t in hot.items() if u % 2 == 0} == \
        {u: t for u, t in jhot.items() if u % 2 == 0}
    return eng


def check_different_extras_never_share(models):
    """``test_different_extras_never_share`` on the port: the same
    tokens with other extras miss, and decode what a cold engine
    decodes."""
    _, _, cfg, params = models
    rng = np.random.default_rng(3)
    prompt = rng.integers(0, cfg.vocab_size, 24, dtype=np.int32)

    def reqs(*seeds):
        return [Request(uid=u, prompt=prompt.copy(), max_new_tokens=4,
                        extras=extras(cfg, np.random.default_rng(s)))
                for u, s in seeds]
    eng = EdgeServingEngine(cfg, params, ServeConfig(prefix_cache=True,
                                                     **SEQ), device="cpu")
    hot = sequential(eng, reqs((0, 0), (1, 1)))
    assert eng.prefix_cache.hits == 0
    cold = sequential(EdgeServingEngine(cfg, params, ServeConfig(
        prefix_cache=False, **SEQ), device="cpu"), reqs((1, 1)))
    assert hot[1] == cold[1]
    same = sequential(eng, reqs((2, 0)))
    assert eng.prefix_cache.hits == 1 and same[2] == hot[0]


def check_restart_warm(models, path):
    """``test_restart_warm_hit_bit_identical_to_cold`` on the port, with
    the saved and loaded chain counts equal to the JAX engine's."""
    jcfg, jparams, cfg, params = models

    def scfg(cls, persist=None, **kw):
        return cls(**{**SEQ, "prefix_cache": True,
                      "prefix_persist_path": persist, **kw})

    def three(cls, c):
        return shared_traffic(cls, c, n=3, sys_len=21)
    cold = sequential(EdgeServingEngine(cfg, params, scfg(
        ServeConfig, prefix_cache=False), device="cpu"),
        three(Request, cfg))
    counts = []
    for cls, jcls, eng_cls, c, p, dev in (
            (ServeConfig, Request, EdgeServingEngine, cfg, params, "cpu"),
            (JaxServeConfig, JaxRequest, JaxEngine, jcfg, jparams, None)):
        store = f"{path}-{dev or 'jax'}.npz"
        kw = {} if dev is None else {"device": dev}
        eng_a = eng_cls(c, p, scfg(cls, store), **kw)
        sequential(eng_a, three(jcls, c))
        saved = eng_a.close()
        eng_b = eng_cls(c, p, scfg(cls, store), **kw)
        assert eng_b.persist_rejected == ""
        warm = sequential(eng_b, three(jcls, c))
        counts.append((saved["persist_saved_chains"],
                       saved["persist_saved_blocks"],
                       eng_b.persist_loaded_chains,
                       eng_b.persist_loaded_blocks,
                       eng_b.prefix_cache.stats()))
        if dev is not None:
            assert warm == cold
            assert eng_b.prefix_cache.stats()["hits"] >= len(warm)
            no_leak(eng_b)
    assert counts[0] == counts[1]
    assert counts[0][0] >= 1


SPEC = dict(max_slots=4, max_len=96, prefill_buckets=(8, 16))


def spec_reqs(request_cls, cfg, lens=(5, 9, 17, 33), max_new=8):
    """``tests/test_spec_decode.py``'s ``_reqs``."""
    rng = np.random.default_rng(3)
    out = []
    for uid, n in enumerate(lens):
        e = extras(cfg, rng)
        out.append(request_cls(
            uid=uid, prompt=rng.integers(0, cfg.vocab_size, n,
                                         dtype=np.int32),
            max_new_tokens=max_new, extras=e))
    return out


def check_spec_equals_vanilla(models):
    """``test_spec_greedy_bit_equals_vanilla`` on the port: spec on ==
    spec off, token for token, under the identity draft (the verify
    model itself, prefilling its own image or audio) and a chance-level
    cross draft (the gemma smoke config); ``stats()`` of the identity
    run equal to the JAX spec engine's."""
    jcfg, jparams, cfg, params = models
    base = drain(EdgeServingEngine(cfg, params, ServeConfig(**SPEC),
                                   device="cpu"),
                 spec_reqs(Request, cfg))
    eng = EdgeServingEngine(cfg, params, ServeConfig(spec_decode=True,
                                                     **SPEC),
                            device="cpu", draft=(cfg, params))
    assert eng.spec.prefix == prefix(cfg)
    assert drain(eng, spec_reqs(Request, cfg)) == base
    assert eng.spec_rounds >= 1 and eng.spec_accepted >= 1
    jeng = JaxEngine(jcfg, jparams, JaxServeConfig(spec_decode=True, **SPEC),
                     draft=(jcfg, jparams))
    drain(jeng, spec_reqs(JaxRequest, jcfg))
    assert eng.stats() == jeng.stats()
    gemma = get_smoke_config("gemma3-1b").replace(dtype="float32")
    gparams = M.init_params(gemma, torch.Generator().manual_seed(1), "cpu")
    eng = EdgeServingEngine(cfg, params, ServeConfig(spec_decode=True,
                                                     **SPEC),
                            device="cpu", draft=(gemma, gparams))
    assert eng.spec.prefix == 0
    assert drain(eng, spec_reqs(Request, cfg)) == base


def check_make_requests(arch):
    """``launch.serve.make_requests`` against the JAX CLI's
    ``_make_requests``: prompts and extras bitwise, at smoke and full
    widths."""
    from repro.configs import get_config as jax_config
    from repro_torch.configs import get_config
    for cfg, jcfg in ((get_smoke_config(arch), jax_smoke_config(arch)),
                      (get_config(arch), jax_config(arch))):
        args = argparse.Namespace(requests=4, min_prompt=4, max_prompt=24,
                                  max_new=7, policy="edf")
        theirs = jax_serve._make_requests(jcfg, args)
        mine = serve.make_requests(cfg, 4, 4, 24, 7, "edf")
        assert len(mine) == len(theirs) == 4
        for a, b in zip(mine, theirs):
            assert (a.uid, a.max_new_tokens, a.priority, a.deadline) == \
                (b.uid, b.max_new_tokens, b.priority, b.deadline)
            assert a.prompt.dtype == b.prompt.dtype
            assert np.array_equal(a.prompt, b.prompt)
            assert set(a.extras) == set(b.extras) == {extras_key(cfg)}
            for k in a.extras:
                assert a.extras[k].dtype == b.extras[k].dtype == np.float32
                assert a.extras[k].tobytes() == b.extras[k].tobytes()
