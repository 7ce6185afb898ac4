"""The port's dense layers against ``repro.models.layers``, function by
function, on the same float32 inputs made from a numpy seed (phi3 smoke
widths; gemma3 smoke for qk-norm, softcaps and windows), on float and
int8 page pools.

Tolerance: rtol=atol=1e-5 — both sides run the same float32 math, in a
different summation order.  Integer outputs (masks, write targets) and
pages a write must leave alone are compared exactly.  The paged writes
update the port's pool in place; the JAX functions return a new pool,
and both must end up holding the same bytes — including every write the
JAX side drops with ``mode="drop"``: -1 tables, pad rows past
``valid_len`` and writes past ``n_blk * bs``.  int8 bytes and scales
are compared exactly: ``torch.round`` and ``jnp.round`` both round half
to even, so the same float32 input quantizes to the same bytes.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as jax_smoke_config
from repro.models import layers as JL
from repro_torch.configs import get_smoke_config
from repro_torch.models import layers as L

TOL = dict(rtol=1e-5, atol=1e-5)


def _cfgs(arch, **kw):
    return (jax_smoke_config(arch).replace(dtype="float32", **kw),
            get_smoke_config(arch).replace(dtype="float32", **kw))


PHI = _cfgs("phi3-medium-14b")
GEMMA = _cfgs("gemma3-1b", attn_logit_softcap=50.0, final_logit_softcap=30.0)


def _rng(seed):
    return np.random.default_rng(seed)


def _f32(rng, *shape, s=1.0):
    return (rng.standard_normal(shape) * s).astype(np.float32)


def _attn_params(rng, cfg, qk_norm=False):
    d, H, K, hd = cfg.d_model, cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    p = {"wq": _f32(rng, d, H, hd, s=d ** -0.5),
         "wk": _f32(rng, d, K, hd, s=d ** -0.5),
         "wv": _f32(rng, d, K, hd, s=d ** -0.5),
         "wo": _f32(rng, H, hd, d, s=(H * hd) ** -0.5)}
    if qk_norm:
        p["q_norm"] = {"scale": _f32(rng, hd, s=0.1)}
        p["k_norm"] = {"scale": _f32(rng, hd, s=0.1)}
    return p


def _j(tree):
    if isinstance(tree, dict):
        return {k: _j(v) for k, v in tree.items()}
    return jnp.asarray(tree)


def _t(tree):
    if isinstance(tree, dict):
        return {k: _t(v) for k, v in tree.items()}
    return torch.from_numpy(np.array(tree))


def _close(mine, theirs, **tol):
    np.testing.assert_allclose(mine.detach().numpy(), np.asarray(theirs),
                               **(tol or TOL))


def _pool(rng, cfg, nB, bs):
    K, hd = cfg.num_kv_heads, cfg.head_dim
    return {"k": _f32(rng, nB, bs, K, hd), "v": _f32(rng, nB, bs, K, hd)}


# ---------------------------------------------------------------------------
# norms, rope, softcap, masks, projections
# ---------------------------------------------------------------------------

def test_rmsnorm_and_layernorm():
    rng = _rng(0)
    x = _f32(rng, 2, 5, 64)
    p = {"scale": _f32(rng, 64, s=0.1)}
    _close(L.rmsnorm(_t(p), _t(x), 1e-6), JL.rmsnorm(_j(p), _j(x), 1e-6))
    lp = {"scale": _f32(rng, 64), "bias": _f32(rng, 64)}
    _close(L.layernorm(_t(lp), _t(x)), JL.layernorm(_j(lp), _j(x)))


@pytest.mark.parametrize("arch", ["phi3-medium-14b", "whisper-base"])
def test_make_norm(arch):
    jcfg, cfg = _cfgs(arch)
    x = _f32(_rng(1), 2, 3, cfg.d_model)
    (jinit, jnorm), (init, norm) = JL.make_norm(jcfg), L.make_norm(cfg)
    jp, p = jinit(cfg.d_model), init(cfg.d_model)
    assert set(p) == set(jp)
    _close(norm(p, _t(x)), jnorm(jp, _j(x)))


@pytest.mark.parametrize("theta", [10_000.0, 1_000_000.0])
def test_rope(theta):
    x = _f32(_rng(2), 2, 7, 4, 32)
    pos = np.array([[3, 4, 5, 6, 7, 8, 9], [0, 1, 2, 30, 31, 32, 400]],
                   np.int32)
    _close(L.rope_freqs(32, theta), JL.rope_freqs(32, theta))
    _close(L.apply_rope(_t(x), _t(pos), theta),
           JL.apply_rope(_j(x), _j(pos), theta), rtol=1e-5, atol=1e-4)


def test_softcap():
    x = _f32(_rng(3), 50, s=80.0)
    _close(L._softcap(_t(x), 30.0), JL._softcap(_j(x), 30.0))
    _close(L._softcap(_t(x), 0.0), JL._softcap(_j(x), 0.0))


def test_masks():
    assert np.array_equal(L.causal_mask(5, 9, 4).numpy(),
                          np.asarray(JL.causal_mask(5, 9, 4)))
    assert np.array_equal(L.window_mask(6, 6, 3).numpy(),
                          np.asarray(JL.window_mask(6, 6, 3)))


@pytest.mark.parametrize("softcap", [0.0, 20.0])
def test_attention_weights_and_out(softcap):
    rng = _rng(4)
    q = _f32(rng, 2, 5, 2, 3, 16)
    k, v = _f32(rng, 2, 7, 2, 16), _f32(rng, 2, 7, 2, 16)
    mask = np.asarray(JL.causal_mask(5, 7, 2))[None, None, None]
    _close(L.attention_weights_and_out(_t(q), _t(k), _t(v), _t(mask),
                                       scale=0.25, softcap=softcap),
           JL.attention_weights_and_out(_j(q), _j(k), _j(v), _j(mask),
                                        scale=0.25, softcap=softcap))


@pytest.mark.parametrize("cfgs", [PHI, GEMMA], ids=["phi3", "gemma3"])
def test_project_seq_and_decode_project(cfgs):
    jcfg, cfg = cfgs
    rng = _rng(5)
    p = _attn_params(rng, cfg, qk_norm=cfg.use_qk_norm)
    x = _f32(rng, 2, 6, cfg.d_model)
    pos = (np.arange(6, dtype=np.int32)[None] + np.array([[0], [9]])
           ).astype(np.int32)
    for is_global in (True, False):
        for a, b in zip(L._project_seq(cfg, _t(p), _t(x), _t(pos),
                                       is_global=is_global),
                        JL._project_seq(jcfg, _j(p), _j(x), _j(pos),
                                        is_global=is_global)):
            _close(a, b, rtol=1e-5, atol=1e-4)
    x1, p1 = x[:, :1], np.array([4, 17], np.int32)
    for a, b in zip(L._decode_project(cfg, _t(p), _t(x1), _t(p1),
                                      is_global=True),
                    JL._decode_project(jcfg, _j(p), _j(x1), _j(p1),
                                       is_global=True)):
        _close(a, b, rtol=1e-5, atol=1e-4)


@pytest.mark.parametrize("cfgs", [PHI, GEMMA], ids=["phi3", "gemma3"])
@pytest.mark.parametrize("is_global", [True, False])
def test_attention_fwd_plain_branch(cfgs, is_global):
    jcfg, cfg = cfgs
    rng = _rng(6)
    p = _attn_params(rng, cfg, qk_norm=cfg.use_qk_norm)
    S = 24                      # > local window 16: windowed mask, no chunks
    x = _f32(rng, 2, S, cfg.d_model)
    pos = np.broadcast_to(np.arange(S, dtype=np.int32), (2, S))
    mine = L.attention_fwd(cfg, _t(p), _t(x), _t(pos), is_global=is_global)
    theirs = JL.attention_fwd(jcfg, _j(p), _j(x), _j(pos),
                              is_global=is_global)
    for a, b in zip(mine, theirs):
        _close(a, b, rtol=1e-5, atol=1e-4)


def test_attention_fwd_seq_parallel_branch(monkeypatch):
    """Every branch of ``attention_fwd`` is ported: the blockwise
    long-sequence branch (tests/test_torch_blockwise.py), the chunked
    local and ``use_flash`` branches (tests/test_torch_training.py) and
    the sequence-parallel split the launch layer sets: at S = 8192 with
    ``SEQ_PARALLEL_ATTN = (2, None)`` the output is bit for bit the
    unsplit walk's."""
    _, cfg = GEMMA
    p = _t(_attn_params(_rng(7), cfg, qk_norm=True))
    x = torch.from_numpy(_f32(_rng(8), 1, 8192, cfg.d_model))
    pos = torch.arange(8192)[None]
    whole = L.attention_fwd(cfg, p, x, pos, is_global=True)
    monkeypatch.setattr(L, "SEQ_PARALLEL_ATTN", (2, None))
    split = L.attention_fwd(cfg, p, x, pos, is_global=True)
    for a, b in zip(split, whole):
        assert torch.equal(a, b)


# ---------------------------------------------------------------------------
# paged pool: init, scatter (write drops), gather
# ---------------------------------------------------------------------------

def test_init_kv_pages():
    jcfg, cfg = PHI
    mine = L.init_kv_pages(cfg, 7, 8, stack=(2,))
    theirs = JL.init_kv_pages(jcfg, 7, 8, stack=(2,))
    for k in ("k", "v"):
        assert tuple(mine[k].shape) == theirs[k].shape
        assert mine[k].dtype == torch.float32 and not mine[k].any()
    # the int8 layout: int8 pages plus float32 scale leaves (nB, bs, K)
    mine = L.init_kv_pages(cfg, 7, 8, stack=(2,), quant=True)
    theirs = JL.init_kv_pages(jcfg, 7, 8, stack=(2,), quant=True)
    assert set(mine) == set(theirs) == {"k", "v", "k_scale", "v_scale"}
    assert L.kv_pages_quantized(mine)
    for k in mine:
        assert tuple(mine[k].shape) == theirs[k].shape
        assert str(mine[k].dtype).replace("torch.", "") == \
            str(theirs[k].dtype)
        assert not mine[k].any()


def test_scatter_kv_pages_drops_unallocated_and_pads():
    """-1 table entries drop their page; the strip is right-padded up to
    ``n_wblk * bs`` and the pad lands in allocated pages as in JAX."""
    jcfg, cfg = PHI
    rng = _rng(8)
    nB, bs = 9, 4
    pages = _pool(rng, cfg, nB, bs)
    k = _f32(rng, 3, 10, cfg.num_kv_heads, cfg.head_dim)
    v = _f32(rng, 3, 10, cfg.num_kv_heads, cfg.head_dim)
    wt = np.array([[2, 5, -1], [-1, -1, -1], [7, 0, 3]], np.int32)
    theirs = JL.scatter_kv_pages(_j(pages), _j(k), _j(v), _j(wt))
    mine = _t(pages)
    out = L.scatter_kv_pages(mine, _t(k), _t(v), _t(wt))
    assert out is mine                                   # in place
    for key in ("k", "v"):
        assert np.array_equal(mine[key].numpy(), np.asarray(theirs[key]))
        untouched = [b for b in range(nB) if b not in wt]
        assert np.array_equal(mine[key].numpy()[untouched],
                              pages[key][untouched])


def test_scatter_all_dropped_leaves_pool_unchanged():
    _, cfg = PHI
    rng = _rng(9)
    pages = _pool(rng, cfg, 5, 4)
    mine = _t(pages)
    k = _f32(rng, 2, 8, cfg.num_kv_heads, cfg.head_dim)
    L.scatter_kv_pages(mine, _t(k), _t(k), torch.full((2, 2), -1,
                                                      dtype=torch.int32))
    L.scatter_kv_tokens(mine, _t(k), _t(k),
                        torch.full((2, 2), -1, dtype=torch.int32),
                        torch.tensor([0, 3], dtype=torch.int32))
    for key in ("k", "v"):
        assert np.array_equal(mine[key].numpy(), pages[key])


def test_gather_kv_pages():
    jcfg, cfg = PHI
    pages = _pool(_rng(10), cfg, 6, 4)
    ct = np.array([[3, 1, -1], [0, 5, 2]], np.int32)
    for a, b in zip(L.gather_kv_pages(_t(pages), _t(ct)),
                    JL.gather_kv_pages(_j(pages), _j(ct))):
        assert np.array_equal(a.numpy(), np.asarray(b))


def _token_case(seed):
    """Rows: a mid-page write, a row whose table has a -1 hole, a row
    past the table's span (n_blk * bs = 12), and pad rows cut by
    valid_len."""
    rng = _rng(seed)
    bt = np.array([[4, 1, 6], [2, -1, 0], [3, 5, 7], [8, -1, -1]], np.int32)
    pos = np.array([2, 1, 10, 0], np.int32)
    valid = np.array([5, 6, 6, 2], np.int32)
    return rng, bt, pos, valid


def test_token_write_targets():
    jcfg, cfg = PHI
    rng, bt, pos, valid = _token_case(11)
    pages = _pool(rng, cfg, 9, 4)
    for vl in (None, valid):
        mine = L._token_write_targets(_t(pages), 4, 6, _t(bt), _t(pos),
                                      None if vl is None else _t(vl))
        theirs = JL._token_write_targets(_j(pages), 4, 6, _j(bt), _j(pos),
                                         None if vl is None else _j(vl))
        for a, b in zip(mine, theirs):
            assert np.array_equal(a.numpy(), np.asarray(b))


@pytest.mark.parametrize("with_valid", [False, True])
def test_scatter_kv_tokens_drops_like_jax(with_valid):
    jcfg, cfg = PHI
    rng, bt, pos, valid = _token_case(12)
    pages = _pool(rng, cfg, 9, 4)
    k = _f32(rng, 4, 6, cfg.num_kv_heads, cfg.head_dim)
    v = _f32(rng, 4, 6, cfg.num_kv_heads, cfg.head_dim)
    vl = valid if with_valid else None
    theirs = JL.scatter_kv_tokens(_j(pages), _j(k), _j(v), _j(bt), _j(pos),
                                  None if vl is None else _j(vl))
    mine = _t(pages)
    L.scatter_kv_tokens(mine, _t(k), _t(v), _t(bt), _t(pos),
                        None if vl is None else _t(vl))
    for key in ("k", "v"):
        assert np.array_equal(mine[key].numpy(), np.asarray(theirs[key]))
    if with_valid:
        # row 3 keeps 2 of its 6 writes: the rest of its page is untouched
        assert np.array_equal(mine["k"].numpy()[8][2:], pages["k"][8][2:])


# ---------------------------------------------------------------------------
# paged attention: prefill, decode (gather and kernel read), extend
# ---------------------------------------------------------------------------

def _paged_state(seed, cfg, B=3, nB=12, bs=4, n_blk=4):
    rng = _rng(seed)
    pages = _pool(rng, cfg, nB, bs)
    bt = np.full((B, n_blk), -1, np.int32)
    perm = rng.permutation(nB)
    bt[0, :3] = perm[:3]
    bt[1, :4] = perm[3:7]
    bt[2, :2] = perm[7:9]
    pos = np.array([9, 14, 5], np.int32)
    return rng, pages, bt, pos


@pytest.mark.parametrize("cfgs", [PHI, GEMMA], ids=["phi3", "gemma3"])
def test_attention_prefill_paged(cfgs):
    jcfg, cfg = cfgs
    rng = _rng(13)
    p = _attn_params(rng, cfg, qk_norm=cfg.use_qk_norm)
    pages = _pool(rng, cfg, 8, 4)
    x = _f32(rng, 2, 7, cfg.d_model)
    pos = np.broadcast_to(np.arange(7, dtype=np.int32), (2, 7))
    wt = np.array([[5, 2], [-1, 7]], np.int32)
    o_j, pg_j = JL.attention_prefill_paged(jcfg, _j(p), _j(x), _j(pos),
                                           _j(pages), _j(wt))
    mine = _t(pages)
    o, _ = L.attention_prefill_paged(cfg, _t(p), _t(x), _t(pos), mine,
                                     _t(wt))
    _close(o, o_j, rtol=1e-5, atol=1e-4)
    for key in ("k", "v"):
        _close(mine[key], pg_j[key], rtol=1e-5, atol=1e-4)
    # the radix-hit branch (ported since): the context of each row's
    # full table below ctx_len (mid-page for row 0), the suffix at
    # ctx_len + i, written through the same table
    ctx = np.array([3, 4], np.int32)
    full = np.array([[5, 2, 6], [1, 7, 0]], np.int32)
    hpos = ctx[:, None] + np.arange(7, dtype=np.int32)[None, :]
    o_j, pg_j = JL.attention_prefill_paged(jcfg, _j(p), _j(x), _j(hpos),
                                           pg_j, _j(full), _j(full), _j(ctx))
    o, _ = L.attention_prefill_paged(cfg, _t(p), _t(x), _t(hpos), mine,
                                     _t(full), _t(full), _t(ctx))
    _close(o, o_j, rtol=1e-5, atol=1e-4)
    for key in ("k", "v"):
        _close(mine[key], pg_j[key], rtol=1e-5, atol=1e-4)


@pytest.mark.parametrize("cfgs", [PHI, GEMMA], ids=["phi3", "gemma3"])
@pytest.mark.parametrize("use_pallas", [False, True])
def test_attention_decode_paged(cfgs, use_pallas):
    """Gather read and kernel read (the plain version on CPU tensors, the
    Pallas kernel in interpret mode on the JAX side); row 3 is an
    inactive slot (all -1): its write is dropped, and its output is
    each read's own definition, so it is left out of the comparison."""
    jcfg, cfg = cfgs
    rng, pages, bt, pos = _paged_state(14, cfg)
    bt = np.concatenate([bt, np.full((1, 4), -1, np.int32)])
    pos = np.concatenate([pos, np.array([3], np.int32)])
    p = _attn_params(rng, cfg, qk_norm=cfg.use_qk_norm)
    x = _f32(rng, 4, 1, cfg.d_model)
    o_j, pg_j = JL.attention_decode_paged(jcfg, _j(p), _j(x), _j(pages),
                                          _j(pos), _j(bt),
                                          use_pallas=use_pallas)
    mine = _t(pages)
    o, _ = L.attention_decode_paged(cfg, _t(p), _t(x), mine, _t(pos),
                                    _t(bt), use_pallas=use_pallas)
    tol = dict(rtol=2e-3, atol=2e-3) if use_pallas else \
        dict(rtol=1e-5, atol=1e-4)
    _close(o[:3], o_j[:3], **tol)
    for key in ("k", "v"):
        _close(mine[key], pg_j[key], rtol=1e-5, atol=1e-4)


@pytest.mark.parametrize("cfgs", [PHI, GEMMA], ids=["phi3", "gemma3"])
def test_attention_extend_paged(cfgs):
    jcfg, cfg = cfgs
    rng, pages, bt, pos = _paged_state(15, cfg)
    p = _attn_params(rng, cfg, qk_norm=cfg.use_qk_norm)
    S = 5
    x = _f32(rng, 3, S, cfg.d_model)
    valid = np.array([5, 2, 3], np.int32)       # pad rows drop their writes
    o_j, pg_j = JL.attention_extend_paged(jcfg, _j(p), _j(x), _j(pos),
                                          _j(pages), _j(bt), _j(valid))
    mine = _t(pages)
    o, _ = L.attention_extend_paged(cfg, _t(p), _t(x), _t(pos), mine,
                                    _t(bt), _t(valid))
    _close(o, o_j, rtol=1e-5, atol=1e-4)
    for key in ("k", "v"):
        _close(mine[key], pg_j[key], rtol=1e-5, atol=1e-4)


# ---------------------------------------------------------------------------
# MLP, embeddings, projections
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("activation", ["silu", "gelu"])
def test_mlp(activation):
    rng = _rng(16)
    p = {"w_gate": _f32(rng, 32, 48, s=0.2), "w_up": _f32(rng, 32, 48, s=0.2),
         "w_down": _f32(rng, 48, 32, s=0.2)}
    x = _f32(rng, 2, 3, 32)
    _close(L.mlp(_t(p), _t(x), activation), JL.mlp(_j(p), _j(x), activation),
           rtol=1e-5, atol=1e-4)


@pytest.mark.parametrize("cfgs", [PHI, GEMMA], ids=["phi3", "gemma3"])
def test_embed_and_unembed(cfgs):
    jcfg, cfg = cfgs
    rng = _rng(17)
    emb = {"table": _f32(rng, cfg.vocab_size, cfg.d_model, s=0.1)}
    head = ({} if cfg.tie_embeddings
            else {"w": _f32(rng, cfg.d_model, cfg.vocab_size, s=0.1)})
    tokens = rng.integers(0, cfg.vocab_size, (2, 5)).astype(np.int32)
    _close(L.embed(cfg, _t(emb), _t(tokens)),
           JL.embed(jcfg, _j(emb), _j(tokens)))
    x = _f32(rng, 2, 5, cfg.d_model)
    _close(L.unembed(cfg, _t(emb), _t(head), _t(x)),
           JL.unembed(jcfg, _j(emb), _j(head), _j(x)), rtol=1e-5, atol=1e-4)


def test_weight_einsum():
    """Float weights, and an int8 {"q", "scale"} leaf, which the port
    takes now: on CPU tensors both equal the JAX function's result."""
    rng = _rng(18)
    x, w = _f32(rng, 2, 3, 8), _f32(rng, 8, 2, 4)
    _close(L.weight_einsum("bsd,dhq->bshq", _t(x), _t(w)),
           JL.weight_einsum("bsd,dhq->bshq", _j(x), _j(w)))
    qw = JL.quantize_weight(jnp.asarray(w), 1, 2)
    _close(L.weight_einsum("bsd,dhq->bshq", _t(x), _t(qw)),
           JL.weight_einsum("bsd,dhq->bshq", _j(x), qw), **QTOL)


# ---------------------------------------------------------------------------
# int8 projection weights
# ---------------------------------------------------------------------------

# the same float32 dequant product on both sides, summed in another order
QTOL = dict(rtol=1e-6, atol=1e-6)

# every projection of the dense family: (equation, weight shape, x shape)
_PROJ = {
    "wq": ("bsd,dhq->bshq", (16, 4, 8), (2, 3, 16)),
    "wk_seq": ("btd,dkq->btkq", (16, 2, 8), (2, 3, 16)),
    "wk_decode": ("bsd,dkq->bskq", (16, 2, 8), (3, 1, 16)),
    "wo": ("bshq,hqd->bsd", (4, 8, 16), (2, 3, 4, 8)),
    "w_gate": ("bsd,df->bsf", (16, 40), (2, 3, 16)),
    "w_down": ("bsf,fd->bsd", (40, 16), (2, 3, 40)),
}
_DIMS = {"wq": "wq", "wk_seq": "wk", "wk_decode": "wk", "wo": "wo",
         "w_gate": "w_gate", "w_down": "w_down"}


@pytest.mark.parametrize("name", sorted(_PROJ))
def test_weight_einsum_quantized_matches_jax(name):
    """A layer slice of a stacked int8 leaf, as the trunk loop takes it,
    through every projection equation: the JAX function's CPU branch
    (float32 dequant, float32 product) within 1e-6."""
    eq, wshape, xshape = _PROJ[name]
    rng = _rng(31)
    stack = _f32(rng, 3, *wshape, s=wshape[0] ** -0.5)
    x = _f32(rng, *xshape)
    dims = JL.QUANT_WEIGHT_DIMS[_DIMS[name]]
    jq = JL.quantize_weight(jnp.asarray(stack), *dims)
    q = L.quantize_weight(torch.from_numpy(stack), *dims)
    assert q["scale"].shape == tuple(jq["scale"].shape)
    layer = {k: v[1] for k, v in q.items()}
    jlayer = {k: v[1] for k, v in jq.items()}
    out = L.weight_einsum(eq, _t(x), layer)
    assert out.dtype == torch.float32
    _close(out, JL.weight_einsum(eq, _j(x), jlayer), **QTOL)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_quantize_matmul_params_equal_jax(dtype):
    """quantize_matmul_params of the phi3 smoke parameters: the same
    keys and shapes as JAX's, the same int8 bytes and the same scales,
    and the leaves it does not quantize shared, not copied."""
    import jax
    from repro.models import model as JM
    from repro_torch.bridge import params_from_numpy
    jcfg = jax_smoke_config("phi3-medium-14b").replace(param_dtype=dtype)
    jparams = JM.init_params(jcfg, jax.random.PRNGKey(2))
    params = params_from_numpy(jax.tree.map(np.asarray, jparams),
                               device="cpu")
    jq = JL.quantize_matmul_params(jparams)
    q = L.quantize_matmul_params(params)
    jflat = dict(jax.tree_util.tree_flatten_with_path(jq)[0])
    flat = dict(jax.tree_util.tree_flatten_with_path(
        q, is_leaf=torch.is_tensor)[0])
    assert flat.keys() == jflat.keys()
    n_quant = 0
    for path, leaf in flat.items():
        theirs = np.asarray(jflat[path])
        assert tuple(leaf.shape) == theirs.shape, path
        if path[-1].key == "q":
            n_quant += 1
            assert leaf.dtype == torch.int8
            assert np.array_equal(leaf.numpy(), theirs), path
        elif path[-1].key == "scale" and path[-2].key in L.QUANT_WEIGHT_DIMS:
            assert leaf.dtype == torch.float32
            assert np.array_equal(leaf.numpy(), theirs), path
    assert n_quant == 7
    assert q["embed"]["table"] is params["embed"]["table"]
    assert q["trunk"]["layers"]["ln1"]["scale"] is \
        params["trunk"]["layers"]["ln1"]["scale"]


# ---------------------------------------------------------------------------
# dense decode cache
# ---------------------------------------------------------------------------

def test_init_kv_cache():
    jcfg, cfg = PHI
    mine = L.init_kv_cache(cfg, 3, 10, stack=(2,), device="cpu")
    theirs = JL.init_kv_cache(jcfg, 3, 10, stack=(2,))
    assert mine.keys() == theirs.keys()
    for k in mine:
        _exact(mine[k], theirs[k])
        assert str(mine[k].dtype).replace("torch.", "") == \
            str(theirs[k].dtype)


def _dense_state(rng, cfg, B=3, T=12):
    """A dense cache with rows at frontiers 5, 0 and 11 (the last at the
    strip's end): written entries below each frontier, stale entries
    from rejected writes above it (slots holding their positions)."""
    K, hd = cfg.num_kv_heads, cfg.head_dim
    k, v = _f32(rng, B, T, K, hd), _f32(rng, B, T, K, hd)
    slots = np.full((B, T), -1, np.int32)
    slots[0, :8] = np.arange(8)               # 5..7 are stale
    slots[2, :11] = np.arange(11)
    return {"k": k, "v": v, "slots": slots}, np.array([5, 0, 11], np.int32)


@pytest.mark.parametrize("cfgs", [PHI, GEMMA], ids=["phi3", "gemma3"])
def test_attention_decode_dense(cfgs):
    """One token per row written in place at ``pos`` and read over the
    slots in [0, pos]: the JAX output and returned cache."""
    jcfg, cfg = cfgs
    rng = _rng(40)
    p = _attn_params(rng, cfg, qk_norm=cfg.use_qk_norm)
    cache, pos = _dense_state(rng, cfg)
    x = _f32(rng, 3, 1, cfg.d_model)
    mine = _t(cache)
    out, ret = L.attention_decode(cfg, _t(p), _t(x), mine,
                                  torch.from_numpy(pos), is_global=True)
    jout, jcache = JL.attention_decode(jcfg, _j(p), _j(x), _j(cache),
                                       jnp.asarray(pos), is_global=True)
    assert ret is mine
    _close(out, jout)
    for k in ("k", "v", "slots"):
        _close(mine[k], jcache[k])


def test_attention_decode_local_ring_raises():
    """The local ring branch is ported: the 12-entry cache read as a
    ring (write at ``pos % 12``, slots inside gemma's window) gives the
    JAX output and cache.  The name is older than the encdec port: the
    cross-attention branch, which raised before it, now gives the JAX
    output over 12 entries and leaves the cache untouched."""
    jcfg, cfg = GEMMA
    rng = _rng(41)
    cache, pos = _dense_state(rng, cfg)
    p = _attn_params(_rng(42), cfg, qk_norm=True)
    x = _f32(rng, 3, 1, cfg.d_model)
    mine = _t(cache)
    out, _ = L.attention_decode(cfg, _t(p), _t(x), mine,
                                torch.from_numpy(pos), is_global=False)
    jout, jcache = JL.attention_decode(jcfg, _j(p), _j(x), _j(cache),
                                       jnp.asarray(pos), is_global=False)
    _close(out, jout)
    for k in ("k", "v", "slots"):
        _close(mine[k], jcache[k])
    before = {k: v.clone() for k, v in mine.items()}
    out, ret = L.attention_decode(cfg, _t(p), _t(x), mine,
                                  torch.from_numpy(pos), is_global=False,
                                  cross_kv=(mine["k"], mine["v"]))
    jout, _ = JL.attention_decode(jcfg, _j(p), _j(x), jcache,
                                  jnp.asarray(pos), is_global=False,
                                  cross_kv=(jcache["k"], jcache["v"]))
    _close(out, jout)
    assert ret is mine
    assert all(torch.equal(mine[k], before[k]) for k in mine)


# ---------------------------------------------------------------------------
# int8 pools: quantization, writes, gather, decode and extend reads
# ---------------------------------------------------------------------------

def _exact(mine, theirs):
    assert np.array_equal(mine.detach().numpy(), np.asarray(theirs))


def _pools_equal(mine, theirs):
    assert set(mine) == set(theirs)
    for key in mine:
        _exact(mine[key], theirs[key])


def _qpools_close(mine, theirs):
    """Pools written from projected K/V: the projections of the two
    frameworks differ by float noise, which moves a scale by a few ulps
    (rtol 1e-6); the int8 bytes must still be equal."""
    assert set(mine) == set(theirs)
    for key in ("k", "v"):
        _exact(mine[key], theirs[key])
    for key in ("k_scale", "v_scale"):
        _close(mine[key], theirs[key], rtol=1e-6, atol=0.0)


def _qpool(rng, cfg, nB, bs):
    """A random int8 pool, quantized by the JAX function."""
    pages = _pool(rng, cfg, nB, bs)
    kq, ks = JL.quantize_kv(jnp.asarray(pages["k"]))
    vq, vs = JL.quantize_kv(jnp.asarray(pages["v"]))
    return {"k": np.array(kq), "v": np.array(vq), "k_scale": np.array(ks),
            "v_scale": np.array(vs)}


@pytest.mark.parametrize("std", [1e-3, 1.0, 300.0])
def test_quantize_kv_bytes_and_scales_equal(std):
    x = _f32(_rng(20), 4, 6, 2, 32, s=std)
    x[0, 0, 0] = 0.0                              # an all-zero row: eps scale
    for a, b in zip(L.quantize_kv(_t(x)), JL.quantize_kv(_j(x))):
        assert a.dtype == (torch.int8 if b.dtype == jnp.int8
                           else torch.float32)
        _exact(a, b)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_dequantize_kv(dtype):
    q, s = JL.quantize_kv(_j(_f32(_rng(21), 3, 5, 16)))
    mine = L.dequantize_kv(_t(q), _t(s), getattr(torch, dtype))
    theirs = JL.dequantize_kv(q, s, getattr(jnp, dtype))
    assert mine.dtype == getattr(torch, dtype)
    _exact(mine.float(), np.asarray(theirs, np.float32))


def test_scatter_kv_pages_int8_drops_like_jax():
    """-1 table entries drop bytes and scales alike; the pad of the strip
    quantizes to zeros with the eps scale, as in JAX."""
    jcfg, cfg = PHI
    rng = _rng(22)
    pages = _qpool(rng, cfg, 9, 4)
    k = _f32(rng, 3, 10, cfg.num_kv_heads, cfg.head_dim)
    v = _f32(rng, 3, 10, cfg.num_kv_heads, cfg.head_dim)
    wt = np.array([[2, 5, -1], [-1, -1, -1], [7, 0, 3]], np.int32)
    theirs = JL.scatter_kv_pages(_j(pages), _j(k), _j(v), _j(wt))
    mine = _t(pages)
    assert L.scatter_kv_pages(mine, _t(k), _t(v), _t(wt)) is mine
    _pools_equal(mine, theirs)
    untouched = [b for b in range(9) if b not in wt]
    for key in mine:
        assert np.array_equal(mine[key].numpy()[untouched],
                              pages[key][untouched])


@pytest.mark.parametrize("with_valid", [False, True])
def test_scatter_kv_tokens_int8_drops_like_jax(with_valid):
    """-1 holes, writes past ``n_blk * bs`` and pad rows past
    ``valid_len`` leave bytes and scales alike untouched."""
    jcfg, cfg = PHI
    rng, bt, pos, valid = _token_case(23)
    pages = _qpool(rng, cfg, 9, 4)
    k = _f32(rng, 4, 6, cfg.num_kv_heads, cfg.head_dim)
    v = _f32(rng, 4, 6, cfg.num_kv_heads, cfg.head_dim)
    vl = valid if with_valid else None
    theirs = JL.scatter_kv_tokens(_j(pages), _j(k), _j(v), _j(bt), _j(pos),
                                  None if vl is None else _j(vl))
    mine = _t(pages)
    L.scatter_kv_tokens(mine, _t(k), _t(v), _t(bt), _t(pos),
                        None if vl is None else _t(vl))
    _pools_equal(mine, theirs)
    if with_valid:
        # row 3 keeps 2 of its 6 writes: the rest of its page is untouched
        for key in mine:
            assert np.array_equal(mine[key].numpy()[8][2:], pages[key][8][2:])


def test_scatter_tokens_quant_writes_the_given_ints():
    jcfg, cfg = PHI
    rng, bt, pos, valid = _token_case(24)
    pages = _qpool(rng, cfg, 9, 4)
    kq, ks = JL.quantize_kv(_j(_f32(rng, 4, 6, cfg.num_kv_heads,
                                    cfg.head_dim)))
    vq, vs = JL.quantize_kv(_j(_f32(rng, 4, 6, cfg.num_kv_heads,
                                    cfg.head_dim)))
    theirs = JL._scatter_tokens_quant(_j(pages), kq, ks, vq, vs, _j(bt),
                                      _j(pos), _j(valid))
    mine = _t(pages)
    L._scatter_tokens_quant(mine, _t(kq), _t(ks), _t(vq), _t(vs), _t(bt),
                            _t(pos), _t(valid))
    _pools_equal(mine, theirs)


def test_int8_all_dropped_writes_leave_pool_unchanged():
    _, cfg = PHI
    rng = _rng(25)
    pages = _qpool(rng, cfg, 5, 4)
    mine = _t(pages)
    k = _f32(rng, 2, 8, cfg.num_kv_heads, cfg.head_dim)
    none = torch.full((2, 2), -1, dtype=torch.int32)
    L.scatter_kv_pages(mine, _t(k), _t(k), none)
    L.scatter_kv_tokens(mine, _t(k), _t(k), none,
                        torch.tensor([0, 3], dtype=torch.int32))
    for key in mine:
        assert np.array_equal(mine[key].numpy(), pages[key])


def test_gather_kv_pages_int8():
    jcfg, cfg = PHI
    pages = _qpool(_rng(26), cfg, 6, 4)
    ct = np.array([[3, 1, -1], [0, 5, 2]], np.int32)
    for a, b in zip(L.gather_kv_pages(_t(pages), _t(ct)),
                    JL.gather_kv_pages(_j(pages), _j(ct))):
        assert a.dtype == torch.float32
        _exact(a, b)


def _qpaged_state(seed, cfg):
    rng, pages, bt, pos = _paged_state(seed, cfg)
    return rng, _qpool(rng, cfg, 12, 4), bt, pos


@pytest.mark.parametrize("cfgs", [PHI, GEMMA], ids=["phi3", "gemma3"])
@pytest.mark.parametrize("use_pallas", [False, True])
def test_attention_decode_paged_int8(cfgs, use_pallas):
    """The new token's bytes and scales land in place and the read sees
    them; row 3 is an inactive slot (its output is each read's own
    definition, left out)."""
    jcfg, cfg = cfgs
    rng, pages, bt, pos = _qpaged_state(27, cfg)
    bt = np.concatenate([bt, np.full((1, 4), -1, np.int32)])
    pos = np.concatenate([pos, np.array([3], np.int32)])
    p = _attn_params(rng, cfg, qk_norm=cfg.use_qk_norm)
    x = _f32(rng, 4, 1, cfg.d_model)
    o_j, pg_j = JL.attention_decode_paged(jcfg, _j(p), _j(x), _j(pages),
                                          _j(pos), _j(bt),
                                          use_pallas=use_pallas)
    mine = _t(pages)
    o, out_pages = L.attention_decode_paged(cfg, _t(p), _t(x), mine, _t(pos),
                                            _t(bt), use_pallas=use_pallas)
    assert out_pages is mine
    _close(o[:3], o_j[:3], rtol=1e-5, atol=1e-4)
    _qpools_close(mine, pg_j)


@pytest.mark.parametrize("cfgs", [PHI, GEMMA], ids=["phi3", "gemma3"])
@pytest.mark.parametrize("use_pallas", [False, True])
def test_attention_extend_paged_int8(cfgs, use_pallas):
    """The suffix attends its own int8 round trip and the same ints are
    written; pad rows past ``valid_len`` drop their writes; a row at
    pos 0 sees no context."""
    jcfg, cfg = cfgs
    rng, pages, bt, pos = _qpaged_state(28, cfg)
    pos[2] = 0
    p = _attn_params(rng, cfg, qk_norm=cfg.use_qk_norm)
    S = 5
    x = _f32(rng, 3, S, cfg.d_model)
    valid = np.array([5, 2, 3], np.int32)
    o_j, pg_j = JL.attention_extend_paged(jcfg, _j(p), _j(x), _j(pos),
                                          _j(pages), _j(bt), _j(valid),
                                          use_pallas=use_pallas)
    mine = _t(pages)
    o, _ = L.attention_extend_paged(cfg, _t(p), _t(x), _t(pos), mine,
                                    _t(bt), _t(valid), use_pallas=use_pallas)
    _close(o, o_j, rtol=1e-5, atol=1e-4)
    _qpools_close(mine, pg_j)


def test_extend_kernel_reads_the_pre_write_pool(monkeypatch):
    """The kernel read runs before the in-place scatter: at the call the
    pages still hold their old bytes in the span the extend then writes
    (stale entries at and past ``pos``), and they hold the new tokens
    after it.  The output is the gather read's, which copies the old
    context before its scatter (``test_attention_extend_paged_int8``
    holds both to JAX)."""
    from repro_torch.kernels import ops as kernel_ops
    _, cfg = PHI
    rng, pages, bt, pos = _qpaged_state(29, cfg)
    p = _attn_params(rng, cfg)
    x = _f32(rng, 3, 4, cfg.d_model)
    seen = {}
    real = kernel_ops.paged_extend_attention

    def spy(q, k_pages, v_pages, *args, k_scale, v_scale, **kw):
        seen.update(k=k_pages.clone(), v=v_pages.clone(),
                    k_scale=k_scale.clone(), v_scale=v_scale.clone())
        return real(q, k_pages, v_pages, *args, k_scale=k_scale,
                    v_scale=v_scale, **kw)
    monkeypatch.setattr(kernel_ops, "paged_extend_attention", spy)
    mine = _t(pages)
    o, _ = L.attention_extend_paged(cfg, _t(p), _t(x), _t(pos), mine, _t(bt),
                                    use_pallas=True)
    for key in mine:
        assert np.array_equal(seen[key].numpy(), pages[key])      # pre-write
        assert not np.array_equal(mine[key].numpy(), pages[key])  # written
    gathered = _t(pages)
    o_g, _ = L.attention_extend_paged(cfg, _t(p), _t(x), _t(pos), gathered,
                                      _t(bt))
    _close(o, o_g, rtol=1e-5, atol=1e-4)
    _pools_equal(mine, gathered)


def test_float_pool_extend_ignores_use_pallas(monkeypatch):
    """As in JAX, only an int8 pool sends the extend read to the kernel."""
    from repro_torch.kernels import ops as kernel_ops
    _, cfg = PHI
    rng, pages, bt, pos = _paged_state(30, cfg)
    p = _attn_params(rng, cfg)
    x = _t(_f32(rng, 3, 2, cfg.d_model))

    def refuse(*a, **kw):
        raise AssertionError("float pool reached the extend kernel")
    monkeypatch.setattr(kernel_ops, "paged_extend_attention", refuse)
    a, _ = L.attention_extend_paged(cfg, _t(p), x, _t(pos), _t(pages),
                                    _t(bt), use_pallas=True)
    b, _ = L.attention_extend_paged(cfg, _t(p), x, _t(pos), _t(pages),
                                    _t(bt))
    assert torch.equal(a, b)
