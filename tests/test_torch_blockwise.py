"""The port's blockwise long-sequence attention against the JAX package's.

``layers._blockwise_inner`` against JAX's on the same numpy inputs
(chunk 64, 512 queries, a query offset of 0 and of 256, softcap off and
binding, one and four query heads a kv head); ``attention_fwd`` at
S = 8192, where both packages take the blockwise branch, on the gemma3-1b
smoke widths with a binding attention softcap; the fall-through at
S = 8200 (not a multiple of the chunk) to the plain masked softmax in
both; ``model.loss_fn`` with its gradients and ``model.prefill`` on a
2-layer phi3-medium-14b smoke config at S = 8192; and one 8100-token
request admitted through an 8192 prefill bucket of both engines.

Tolerances: rtol = atol = 1e-5 at float32 (the same float32 math summed
in another order; gradients and the loss relative to the largest
magnitude of each compared quantity, 1e-4 for gradients summed over
8192 positions), and bf16 allclose (rtol 1.6e-2, atol 1e-2: one bf16
rounding of the output, 2**-8 relative, with room) at bfloat16.  Greedy
tokens are compared exactly.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as jax_smoke_config
from repro.models import layers as JL
from repro.models import model as JM
from repro.serving import EdgeServingEngine as JaxEngine
from repro.serving import Request as JaxRequest
from repro.serving import ServeConfig as JaxServeConfig
from repro_torch.bridge import params_from_numpy
from repro_torch.configs import get_smoke_config
from repro_torch.models import layers as L
from repro_torch.models import model as M
from repro_torch.serving import EdgeServingEngine, Request, ServeConfig

F32 = dict(rtol=1e-5, atol=1e-5)
BF16 = dict(rtol=1.6e-2, atol=1e-2)
LONG = 8192
CHUNK = 64


def _rng(seed):
    return np.random.default_rng(seed)


def _close(mine, theirs, **tol):
    np.testing.assert_allclose(mine.detach().float().numpy(),
                               np.asarray(theirs, np.float32), **tol)


def _rel_close(mine, theirs, rel, what=""):
    mine = mine.detach().float().numpy()
    theirs = np.asarray(theirs, np.float32)
    scale = max(float(np.abs(theirs).max()), 1e-30)
    err = float(np.abs(mine - theirs).max())
    assert err <= rel * scale, f"{what}: {err} > {rel} x {scale}"


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("softcap", [None, 5.0])
@pytest.mark.parametrize("q_offset", [0, 256])
@pytest.mark.parametrize("G", [1, 4])
def test_blockwise_inner_matches_jax(G, q_offset, softcap, dtype):
    """A 512-query shard at ``q_offset`` against the keys up to its last
    position (the sequence-parallel split's arithmetic), 3 x randn
    queries so the softmax is peaked and the softcap binds."""
    rng = _rng(G * 1000 + q_offset)
    B, S, K, hd = 2, 512, 2, 16
    T = S + q_offset
    q = rng.standard_normal((B, S, K, G, hd)).astype(np.float32) * 3
    k = rng.standard_normal((B, T, K, hd)).astype(np.float32)
    v = rng.standard_normal((B, T, K, hd)).astype(np.float32)
    theirs = JL._blockwise_inner(*(jnp.asarray(a, dtype) for a in (q, k, v)),
                                 0.25, softcap, CHUNK, q_offset=q_offset)
    tdt = getattr(torch, dtype)
    mine = L._blockwise_inner(*(torch.from_numpy(a).to(tdt)
                                for a in (q, k, v)),
                              0.25, softcap, CHUNK, q_offset=q_offset)
    assert mine.dtype == tdt and tuple(mine.shape) == theirs.shape
    _close(mine, theirs.astype(jnp.float32),
           **(F32 if dtype == "float32" else BF16))


def test_blockwise_skipping_changes_no_bit():
    """The skipped chunk pairs above the diagonal change no bit: the
    port's walk equals, bit for bit, a walk that visits and masks every
    pair as JAX's does."""
    rng = _rng(3)
    B, S, K, G, hd = 1, 512, 1, 4, 16
    q = torch.from_numpy(rng.standard_normal((B, S, K, G, hd))
                         .astype(np.float32) * 3)
    k = torch.from_numpy(rng.standard_normal((B, S, K, hd))
                         .astype(np.float32))
    v = torch.from_numpy(rng.standard_normal((B, S, K, hd))
                         .astype(np.float32))
    mine = L._blockwise_inner(q, k, v, 0.25, 5.0, CHUNK)
    n = S // CHUNK
    rel = torch.arange(CHUNK)
    kt, vt = k.permute(0, 2, 3, 1), v.permute(0, 2, 1, 3)
    outs = []
    for qi in range(n):
        qc = q[:, qi * CHUNK:(qi + 1) * CHUNK].permute(0, 2, 3, 1, 4) \
            .reshape(B, K, G * CHUNK, hd)
        m = torch.full((B, K, G, CHUNK), L.NEG_INF)
        l = torch.zeros((B, K, G, CHUNK))
        acc = torch.zeros((B, K, G, CHUNK, hd))
        for kj in range(n):
            s = torch.matmul(qc, kt[..., kj * CHUNK:(kj + 1) * CHUNK]) \
                .view(B, K, G, CHUNK, CHUNK) * 0.25
            s = L._softcap(s, 5.0)
            vis = (kj * CHUNK + rel)[None, :] <= (qi * CHUNK + rel)[:, None]
            s = torch.where(vis, s, L.NEG_INF)
            m_new = torch.maximum(m, s.amax(dim=-1))
            p = torch.where(vis, torch.exp(s - m_new[..., None]), 0.0)
            alpha = torch.exp(m - m_new)
            l = l * alpha + p.sum(dim=-1)
            pv = torch.matmul(p.view(B, K, G * CHUNK, CHUNK),
                              vt[:, :, kj * CHUNK:(kj + 1) * CHUNK])
            acc = acc * alpha[..., None] + pv.view(B, K, G, CHUNK, hd)
            m = m_new
        outs.append((acc / torch.clamp_min(l, 1e-30)[..., None])
                    .permute(0, 3, 1, 2, 4))
    assert torch.equal(mine, torch.cat(outs, dim=1))


def _gemma_cfgs(**kw):
    jcfg = jax_smoke_config("gemma3-1b").replace(dtype="float32", **kw)
    cfg = dataclasses.replace(get_smoke_config("gemma3-1b"),
                              dtype="float32", **kw)
    return jcfg, cfg


def _attn_params(rng, cfg):
    d, H, K, hd = cfg.d_model, cfg.num_heads, cfg.num_kv_heads, cfg.head_dim

    def w(*shape, fan):
        return (rng.standard_normal(shape) * fan ** -0.5).astype(np.float32)
    p = {"wq": w(d, H, hd, fan=d), "wk": w(d, K, hd, fan=d),
         "wv": w(d, K, hd, fan=d), "wo": w(H, hd, d, fan=H * hd)}
    if cfg.use_qk_norm:
        p["q_norm"] = {"scale": (rng.standard_normal(hd) * 0.1)
                       .astype(np.float32)}
        p["k_norm"] = {"scale": (rng.standard_normal(hd) * 0.1)
                       .astype(np.float32)}
    return p


def _both(p):
    return ({k: (_both(v)[0] if isinstance(v, dict) else jnp.asarray(v))
             for k, v in p.items()},
            {k: (_both(v)[1] if isinstance(v, dict)
                 else torch.from_numpy(v.copy())) for k, v in p.items()})


def test_attention_fwd_blockwise_matches_jax(monkeypatch):
    """S = 8192 on the gemma3-1b smoke widths (4 heads over 1 of 32,
    qk-norm, the global rope) with a softcap of 5 that binds on x scaled
    by 3: the blockwise branch in both packages, against JAX at float32
    and against the port's plain masked softmax on the first and last
    query chunks."""
    jcfg, cfg = _gemma_cfgs(attn_logit_softcap=5.0)
    rng = _rng(11)
    jp, p = _both(_attn_params(rng, cfg))
    x = (rng.standard_normal((1, LONG, cfg.d_model)) * 3).astype(np.float32)
    pos = np.arange(LONG, dtype=np.int32)[None]
    walked = []
    inner = L._blockwise_inner
    monkeypatch.setattr(L, "_blockwise_inner",
                        lambda *a, **k: walked.append(1) or inner(*a, **k))
    mine = L.attention_fwd(cfg, p, torch.from_numpy(x),
                           torch.from_numpy(pos), is_global=True)
    # eager: under jit XLA fuses the rope's sin / cos into an
    # approximation 2e-4 off the sine of the float32 angle at positions
    # near 8191, where eager JAX and the port are exact to 5.5e-7
    theirs = JL.attention_fwd(jcfg, jp, jnp.asarray(x), jnp.asarray(pos),
                              is_global=True)
    assert walked == [1]
    for a, b in zip(mine, theirs):
        _close(a, b, **F32)

    # the core against the plain masked softmax on two query chunks
    q, k, v = L._project_seq(cfg, p, torch.from_numpy(x),
                             torch.from_numpy(pos), is_global=True)
    H, K, hd = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    qg = q.reshape(1, LONG, K, H // K, hd)
    scale = cfg.attn_scale if cfg.attn_scale is not None else hd ** -0.5
    out = L._blockwise_causal_attention(qg, k, v, scale, 5.0)
    C = L.BLOCKWISE_CHUNK
    for r0 in (0, LONG - C):
        mask = L.causal_mask(C, LONG, q_offset=r0)[None, None, None]
        plain = L.attention_weights_and_out(qg[:, r0:r0 + C], k, v, mask,
                                            scale=scale, softcap=5.0)
        torch.testing.assert_close(out[:, r0:r0 + C], plain, **F32)


def test_attention_fwd_falls_through_at_8200(monkeypatch):
    """S = 8200 is long but not a multiple of 1024: both packages take
    the plain masked softmax (one head, a 269 MB score tensor)."""
    jcfg, cfg = _gemma_cfgs(num_heads=1, num_kv_heads=1,
                            attn_logit_softcap=5.0)
    S = 8200
    rng = _rng(12)
    jp, p = _both(_attn_params(rng, cfg))
    x = (rng.standard_normal((1, S, cfg.d_model)) * 3).astype(np.float32)
    pos = np.arange(S, dtype=np.int32)[None]

    def refuse(*a, **k):
        raise AssertionError("blockwise branch taken at S = 8200")
    monkeypatch.setattr(L, "_blockwise_causal_attention", refuse)
    monkeypatch.setattr(JL, "_blockwise_causal_attention", refuse)
    mine = L.attention_fwd(cfg, p, torch.from_numpy(x),
                           torch.from_numpy(pos), is_global=True)
    theirs = JL.attention_fwd(jcfg, jp, jnp.asarray(x), jnp.asarray(pos),
                              is_global=True)
    for a, b in zip(mine, theirs):
        _close(a, b, **F32)


@pytest.mark.parametrize("n", [2, 4])
def test_seq_parallel_knob_splits(monkeypatch, n):
    """A set ``SEQ_PARALLEL_ATTN`` walks n query shards of S / n, shard s
    at ``q_offset = s * S / n``, bit for bit the unsplit walk (each query
    chunk walks the same kv chunks in the same order); a shard shorter
    than the chunk falls through to the unsplit walk, as in JAX."""
    rng = _rng(21)
    q = torch.from_numpy(rng.standard_normal((1, 512, 1, 2, 8))
                         .astype(np.float32))
    k, v = (torch.from_numpy(rng.standard_normal((1, 512, 1, 8))
                             .astype(np.float32)) for _ in range(2))
    whole = L._blockwise_causal_attention(q, k, v, 0.5, 5.0, chunk=CHUNK)
    offsets = []
    inner = L._blockwise_inner

    def recording(*a, q_offset=0, **kw):
        offsets.append(q_offset)
        return inner(*a, q_offset=q_offset, **kw)
    monkeypatch.setattr(L, "_blockwise_inner", recording)
    monkeypatch.setattr(L, "SEQ_PARALLEL_ATTN", (n, None))
    split = L._blockwise_causal_attention(q, k, v, 0.5, 5.0, chunk=CHUNK)
    assert offsets == [s * 512 // n for s in range(n)]
    assert torch.equal(split, whole)
    offsets.clear()
    L._blockwise_causal_attention(q, k, v, 0.5, 5.0, chunk=512 // n * 2)
    assert offsets == [0]


# ---------------------------------------------------------------------------
# the model at S = 8192: loss, gradients, prefill; the engine
# ---------------------------------------------------------------------------

PHI_KW = dict(num_layers=2, num_heads=2, num_kv_heads=1)


@pytest.fixture(scope="module")
def phi():
    jcfg = jax_smoke_config("phi3-medium-14b").replace(dtype="float32",
                                                       **PHI_KW)
    cfg = get_smoke_config("phi3-medium-14b").replace(dtype="float32",
                                                      **PHI_KW)
    jparams = jax.jit(lambda key: JM.init_params(jcfg, key))(
        jax.random.PRNGKey(5))
    params = params_from_numpy(jax.tree.map(np.asarray, jparams),
                               device="cpu")
    toks = _rng(21).integers(0, cfg.vocab_size, (1, LONG + 1),
                             dtype=np.int32)
    return jcfg, jparams, cfg, params, toks


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _flat(tree[k], f"{prefix}/{k}")
    else:
        yield prefix, tree


def test_loss_and_gradients_at_8192(phi):
    jcfg, jparams, cfg, params, toks = phi
    jbatch = {"tokens": jnp.asarray(toks[:, :-1]),
              "targets": jnp.asarray(toks[:, 1:])}
    batch = {"tokens": torch.from_numpy(toks[:, :-1].copy()),
             "targets": torch.from_numpy(toks[:, 1:].copy())}
    leaves = [t.requires_grad_(True) for _, t in _flat(params)]
    loss, _ = M.loss_fn(cfg, params, batch)
    grads = torch.autograd.grad(loss, leaves)
    for t in leaves:
        t.requires_grad_(False)
    jloss, jgrads = jax.jit(jax.value_and_grad(
        lambda q: JM.loss_fn(jcfg, q, jbatch)[0]))(jparams)
    _rel_close(loss, jloss, 1e-5, "loss")
    theirs = [g for _, g in _flat(jax.tree.map(np.asarray, jgrads))]
    assert len(theirs) == len(grads)
    for (name, _), g, jg in zip(_flat(params), grads, theirs):
        _rel_close(g, jg, 1e-4, f"grad {name}")


def test_prefill_at_8192(phi):
    jcfg, jparams, cfg, params, toks = phi
    max_len = LONG + 64
    with torch.no_grad():
        logits, cache = M.prefill(cfg, params,
                                  {"tokens": torch.from_numpy(
                                      toks[:, :LONG].copy())}, max_len)
    jlogits, jcache = jax.jit(lambda p, t: JM.prefill(
        jcfg, p, {"tokens": t}, max_len))(jparams, jnp.asarray(toks[:, :LONG]))
    _rel_close(logits, jlogits, 1e-5, "logits")
    mine = dict(_flat(cache))
    theirs = dict(_flat(jax.tree.map(np.asarray, jcache)))
    assert set(mine) == set(theirs)
    for name in mine:
        # JAX's compiled layer scan fuses the rope's sin / cos into an
        # approximation up to 4.9e-4 x |k| off the sine of the float32
        # angle at positions near 8191 (measured against float64); the
        # port's torch.sin, like JAX's eager jnp.sin, is within 5.5e-7
        rel = 1e-4 if name.endswith("/k") else 1e-5
        _rel_close(mine[name], theirs[name], rel, name)


def test_engine_admits_through_an_8192_bucket(phi):
    """One 8100-token prompt padded to the 8192 bucket: the cold rows of
    ``prefill_paged`` walk ``attention_fwd``'s blockwise branch; greedy
    tokens equal the JAX engine's."""
    jcfg, jparams, cfg, params, toks = phi
    kw = dict(max_slots=1, max_len=LONG + 16,
              prefill_buckets=(16, 32, 64, 128, LONG), seed=3)
    prompt = toks[0, :8100]
    jeng = JaxEngine(jcfg, jparams, JaxServeConfig(**kw))
    jeng.submit(JaxRequest(uid=0, prompt=prompt, max_new_tokens=4))
    jeng.run_until_drained()
    eng = EdgeServingEngine(cfg, params, ServeConfig(**kw), device="cpu")
    eng.submit(Request(uid=0, prompt=prompt, max_new_tokens=4))
    eng.run_until_drained()
    theirs = [list(r.generated) for r in jeng.completed]
    mine = [list(r.generated) for r in eng.completed]
    assert mine == theirs and len(mine[0]) == 4
