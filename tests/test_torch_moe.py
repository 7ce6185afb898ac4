"""The moe family on the port (``repro_torch.models.moe``) against
``repro.models.moe`` and the JAX engine, under capacity pressure.

Capacity dispatch makes a token's output depend on every other row of
its call: which (token, choice) pairs an expert takes is decided by the
stable sort of the flat expert ids over all N = B * S tokens, the
bound ``c = ceil(N * k * capacity_factor / E)`` comes from the static
shape, and pad rows go to a sentinel expert.  So the port is held here
at the configs' default ``capacity_factor`` 1.25 and at 1.0, where
pairs drop, and not only at the 100 the JAX tests use to switch
dropping off.

The granite-moe-1b-a400m and kimi-k2-1t-a32b smoke configs (kimi: one
dense first layer and a shared expert) at float32, with the JAX weights
bridged into the port.  Tolerances, relative to the largest magnitude
of each compared quantity: model outputs, logits, aux losses and
float pages within rtol 1e-5 / atol 1e-5 x max (the same float32 math
summed in another order); gradients within 1e-4; int8 pages one level
in at most 1e-3 of the bytes (float noise across a rounding boundary).
The discrete routing (experts, positions, kept pairs, the inverse map)
must be equal.  The engine's greedy tokens and every ``stats()``
counter must be the JAX engine's, with idle slots mid-run, chunked
catch-up, an int8 pool and the hand-kernel reads (the plain versions
here; the Pallas kernels in interpret mode on the JAX side).  About
75 s serially on one intra-op thread, most of it the JAX engines.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import lax

from repro.configs import get_smoke_config as jax_smoke_config
from repro.models import layers as JL
from repro.models import model as JM
from repro.models import moe as JMOE
from repro.serving import EdgeServingEngine as JaxEngine
from repro.serving import Request as JaxRequest
from repro.serving import ServeConfig as JaxServeConfig
from repro_torch.bridge import params_from_numpy
from repro_torch.configs import get_smoke_config
from repro_torch.launch import serve
from repro_torch.models import layers as L
from repro_torch.models import model as M
from repro_torch.models import moe
from repro_torch.models import transformer as T
from repro_torch.serving import EdgeServingEngine, Request, ServeConfig

torch.set_num_threads(1)

GRANITE, KIMI = "granite-moe-1b-a400m", "kimi-k2-1t-a32b"
REL = 1e-5
GRAD_REL = 1e-4
INT8_MOVED = 1e-3
# logits of a call on an int8 pool: the call quantizes the K/V it
# writes and attends that round trip, so a value within float noise of a
# rounding boundary moves one level inside the call (as
# tests/test_torch_gemma_serve.py's TOL)
INT8_REL = 1e-4
B, MAX_LEN, NB, BS = 3, 64, 24, 8
N_BLK = MAX_LEN // BS


def _bridge(arch, seed=0, **kw):
    jcfg = jax_smoke_config(arch).replace(dtype="float32", **kw)
    jparams = jax.jit(lambda key: JM.init_params(jcfg, key))(
        jax.random.PRNGKey(seed))
    cfg = get_smoke_config(arch).replace(dtype="float32", **kw)
    return jcfg, jparams, cfg, params_from_numpy(
        jax.tree.map(np.asarray, jparams), device="cpu")


@pytest.fixture(scope="module")
def granite():
    return _bridge(GRANITE)


@pytest.fixture(scope="module")
def kimi():
    return _bridge(KIMI)


@pytest.fixture
def models(request, granite, kimi):
    return granite if request.param == GRANITE else kimi


def _np(t):
    return t.detach().numpy() if isinstance(t, torch.Tensor) \
        else np.asarray(t)


def _close(mine, theirs, rel=REL, what=""):
    a, b = _np(mine).astype(np.float64), _np(theirs).astype(np.float64)
    assert a.shape == b.shape, what
    np.testing.assert_allclose(a, b, rtol=rel,
                               atol=rel * max(np.abs(b).max(), 1e-30),
                               err_msg=what)


def _close_tree(mine, theirs):
    """Caches: int leaves equal, int8 pages within one level in at most
    ``INT8_MOVED`` of the bytes, float leaves within ``REL``."""
    assert set(mine) == set(theirs)
    for key, leaf in mine.items():
        if isinstance(leaf, dict):
            _close_tree(leaf, theirs[key])
            continue
        a, b = _np(leaf), _np(theirs[key])
        assert a.shape == b.shape and a.dtype == b.dtype, key
        if a.dtype == np.int8:
            d = np.abs(a.astype(np.int32) - b.astype(np.int32))
            assert d.max() <= 1 and (d > 0).mean() <= INT8_MOVED, key
        elif a.dtype.kind in "iu":
            assert np.array_equal(a, b), key
        else:
            _close(a, b, what=key)


# ---------------------------------------------------------------------------
# routing: the discrete decisions and the dispatch
# ---------------------------------------------------------------------------

def _jax_route(jcfg, router, xf, mask):
    """The routing lines of ``repro.models.moe._moe_tokens`` run on the
    JAX side (``lax.top_k``, the stable ``jnp.argsort``, the
    ``associative_scan`` segment starts, the ``mode="drop"`` scatter),
    returning what the function keeps to itself: (gate, eidx, pos,
    valid, inv)."""
    N = xf.shape[0]
    E, k = jcfg.num_experts, jcfg.num_experts_per_tok
    c = JMOE.capacity(jcfg, N)
    logits = jnp.einsum("nd,de->ne", xf.astype(jnp.float32),
                        router.astype(jnp.float32))
    probs = jax.nn.softmax(logits, axis=-1)
    gate, eidx = lax.top_k(probs, k)
    gate = gate / jnp.sum(gate, axis=-1, keepdims=True)
    if mask is not None:
        eidx = jnp.where(mask[:, None], eidx, E)
        gate = gate * mask[:, None].astype(gate.dtype)
    ef = eidx.reshape(-1)
    order = jnp.argsort(ef, stable=True)
    es = ef[order]
    idx = jnp.arange(N * k, dtype=jnp.int32)
    is_start = jnp.concatenate([jnp.ones((1,), bool), es[1:] != es[:-1]])
    seg = lax.associative_scan(jnp.maximum, jnp.where(is_start, idx, 0))
    pos = jnp.zeros((N * k,), jnp.int32).at[order].set(idx - seg)
    pos = pos.reshape(N, k)
    valid = pos < c
    tok = jnp.broadcast_to(jnp.arange(N, dtype=jnp.int32)[:, None], (N, k))
    inv = jnp.full((E, c), N, jnp.int32).at[
        eidx, jnp.where(valid, pos, c)].set(tok, mode="drop")
    return gate, eidx, pos, valid, inv


def _layer0_moe(models, quant=False):
    """The first moe layer's expert params, both sides (int8 expert
    weights with ``quant``)."""
    _, jparams, _, params = models
    jp = jax.tree.map(lambda a: a[0], jparams["moe_layers"]["moe"])
    p = T._layer(params["moe_layers"], 0)["moe"]
    if quant:
        jp, p = JL.quantize_matmul_params(jp), L.quantize_matmul_params(p)
        assert isinstance(p["w_gate"], dict)
    return jp, p


ROUTE_CASES = [(arch, cf, masked, rowwise)
               for arch in (GRANITE, KIMI) for cf in (100.0, 1.25, 1.0)
               for masked in (False, True) for rowwise in (False, True)]


def _route_inputs(cfg, seed, Bq=4, S=16):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((Bq, S, cfg.d_model)).astype(np.float32)
    n = rng.integers(1, S + 1, Bq)
    mask = np.arange(S)[None, :] < n[:, None]
    return x, mask


@pytest.mark.parametrize("models, cf, masked, rowwise", ROUTE_CASES,
                         indirect=["models"])
def test_routing_and_moe_mlp_match_jax(models, cf, masked, rowwise):
    """``moe_mlp`` (out, aux) against JAX's, and every row set's routing
    (``_route`` / ``_inverse``) equal to the JAX lines' on the same
    inputs: all 64 tokens flattened, or each row alone with
    ``moe_rowwise``.  At 1.0 (capacity = the mean load) pairs drop;
    at 100 none do."""
    jcfg, _, cfg, _ = models
    jcfg = jcfg.replace(capacity_factor=cf, moe_rowwise=rowwise)
    cfg = cfg.replace(capacity_factor=cf, moe_rowwise=rowwise)
    jp, p = _layer0_moe(models)
    x, mask = _route_inputs(cfg, 7 + int(cf * 4))
    m = mask if masked else None
    jout, jaux = JMOE.moe_mlp(jcfg, jp, jnp.asarray(x),
                              None if m is None else jnp.asarray(m))
    out, aux = moe.moe_mlp(cfg, p, torch.from_numpy(x),
                           None if m is None else torch.from_numpy(m))
    _close(out, jout, what="out")
    _close(aux, jaux, what="aux")

    rows = ([(x[b], None if m is None else m[b]) for b in range(len(x))]
            if rowwise else
            [(x.reshape(-1, x.shape[-1]), None if m is None
              else m.reshape(-1))])
    dropped = 0
    for xf, mf in rows:
        jg, je, jpos, jv, jinv = _jax_route(
            jcfg, jp["router"], jnp.asarray(xf),
            None if mf is None else jnp.asarray(mf))
        g, e, pos, v, _ = moe._route(cfg, p["router"], torch.from_numpy(xf),
                                     None if mf is None
                                     else torch.from_numpy(mf))
        inv = moe._inverse(e, pos, v, cfg.num_experts,
                           moe.capacity(cfg, len(xf)), len(xf))
        assert np.array_equal(e.numpy(), np.asarray(je))
        assert np.array_equal(pos.numpy(), np.asarray(jpos))
        assert np.array_equal(v.numpy(), np.asarray(jv))
        assert np.array_equal(inv.numpy(), np.asarray(jinv))
        _close(g, jg, what="gate")
        real = e.numpy() < cfg.num_experts
        dropped += int((real & ~v.numpy()).sum())
    if cf == 1.0 and not masked:
        assert dropped > 0              # capacity really bound
    if cf == 100.0:
        assert dropped == 0


@pytest.mark.parametrize("models", [GRANITE, KIMI], indirect=True)
def test_int8_expert_weights_match_jax(models):
    """int8 expert dicts (``quantize_matmul_params``: the E-stacked
    experts dequantized densely, kimi's shared expert through
    ``weight_einsum``) at capacity factor 1.0, masked."""
    jcfg, _, cfg, _ = models
    jcfg, cfg = (c.replace(capacity_factor=1.0) for c in (jcfg, cfg))
    jp, p = _layer0_moe(models, quant=True)
    x, mask = _route_inputs(cfg, 3)
    jout, jaux = JMOE.moe_mlp(jcfg, jp, jnp.asarray(x), jnp.asarray(mask))
    out, aux = moe.moe_mlp(cfg, p, torch.from_numpy(x),
                           torch.from_numpy(mask))
    _close(out, jout, what="out")
    _close(aux, jaux, what="aux")


def test_capacity_keeps_the_jax_expression():
    cfg = get_smoke_config(GRANITE)
    jcfg = jax_smoke_config(GRANITE)
    full = get_smoke_config(GRANITE).replace(num_experts=32,
                                             num_experts_per_tok=8)
    assert moe.capacity(full, 4) == 2        # a 4-slot decode wave
    assert moe.capacity(full, 4 * 16) == 20  # a 16-token catch-up wave
    assert moe.capacity(full, 4 * 512) == 640
    for n in (1, 3, 7, 64, 2048):
        for cf in (0.01, 1.0, 1.25, 100.0):
            assert moe.capacity(cfg.replace(capacity_factor=cf), n) == \
                JMOE.capacity(jcfg.replace(capacity_factor=cf), n)


def test_sentinel_rows_take_no_capacity():
    """Pad rows go to expert E with gate 0: no pair of theirs is in the
    inverse map, their mixture output is the zero row (granite has no
    shared expert), and the aux counts them for no expert."""
    cfg = get_smoke_config(GRANITE).replace(dtype="float32",
                                            capacity_factor=1.0)
    p = moe.init_moe_mlp(cfg, torch.Generator().manual_seed(0))
    x = torch.randn((12, cfg.d_model), generator=torch.Generator()
                    .manual_seed(1))
    mask = torch.arange(12) < 5
    _, e, pos, v, _ = moe._route(cfg, p["router"], x, mask)
    assert (e[~mask] == cfg.num_experts).all()
    inv = moe._inverse(e, pos, v, cfg.num_experts, moe.capacity(cfg, 12), 12)
    assert not bool(((inv >= 5) & (inv < 12)).any())
    out, _ = moe._moe_tokens(cfg, p, x, mask)
    assert bool((out[~mask] == 0).all())


# ---------------------------------------------------------------------------
# every entry point of models.moe against JAX
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("models", [GRANITE, KIMI], indirect=True)
def test_forward_loss_and_aux_match_jax(models):
    jcfg, jparams, cfg, params = models
    rng = np.random.default_rng(1)
    toks = rng.integers(0, cfg.vocab_size, (2, 24)).astype(np.int32)
    tgt = rng.integers(0, cfg.vocab_size, (2, 24)).astype(np.int32)
    jb = {"tokens": jnp.asarray(toks), "targets": jnp.asarray(tgt)}
    b = {"tokens": torch.from_numpy(toks), "targets": torch.from_numpy(tgt)}
    jlog, jaux = jax.jit(lambda p_, b_: JM.apply(jcfg, p_, b_))(jparams, jb)
    log, aux = M.apply(cfg, params, b)
    _close(log, jlog, what="logits")
    _close(aux, jaux, what="aux")
    assert float(aux) > 0
    jloss, jm = jax.jit(lambda p_, b_: JM.loss_fn(jcfg, p_, b_))(jparams, jb)
    loss, m = M.loss_fn(cfg, params, b)
    _close(loss, jloss, what="loss")
    for k in ("ce", "aux"):
        _close(m[k], jm[k], what=k)
    _close(loss, m["ce"] + cfg.router_aux_coef * m["aux"], what="sum")


def _flat(tree, prefix=""):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _flat(v, f"{prefix}{k}.")
        else:
            yield f"{prefix}{k}", v


def test_gradients_match_jax(granite):
    """``loss_fn`` gradients (CE + router_aux_coef x aux, at the default
    capacity factor) against ``jax.value_and_grad`` on granite smoke."""
    jcfg, jparams, cfg, params = granite
    rng = np.random.default_rng(2)
    toks = rng.integers(0, cfg.vocab_size, (2, 32)).astype(np.int32)
    tgt = rng.integers(0, cfg.vocab_size, (2, 32)).astype(np.int32)

    def grad_tree(node):
        if isinstance(node, dict):
            return {k: grad_tree(v) for k, v in node.items()}
        return node.clone().requires_grad_(True)
    p = grad_tree(params)
    loss, _ = M.loss_fn(cfg, p, {"tokens": torch.from_numpy(toks),
                                 "targets": torch.from_numpy(tgt)})
    names, leaves = zip(*_flat(p))
    grads = torch.autograd.grad(loss, leaves)
    jloss, jgrads = jax.jit(jax.value_and_grad(lambda q: JM.loss_fn(
        jcfg, q, {"tokens": jnp.asarray(toks),
                  "targets": jnp.asarray(tgt)})[0]))(jparams)
    _close(loss, jloss, rel=GRAD_REL, what="loss")
    theirs = dict(_flat(jax.tree.map(np.asarray, jgrads)))
    assert set(names) == set(theirs)
    for name, g in zip(names, grads):
        _close(g, theirs[name], rel=GRAD_REL, what=name)
    assert float(grads[names.index("moe_layers.moe.router")].abs().max()) > 0


@pytest.mark.parametrize("models", [GRANITE, KIMI], indirect=True)
def test_prefill_and_decode_match_jax(models):
    """Dense ``prefill`` with ragged ``true_len`` (pads take no capacity)
    and two ``decode_step`` waves: logits and strips."""
    jcfg, jparams, cfg, params = models
    rng = np.random.default_rng(3)
    toks = rng.integers(0, cfg.vocab_size, (B, 20)).astype(np.int32)
    n = np.array([20, 13, 4], np.int32)
    jlog, jc = jax.jit(lambda p_, t_, n_: JM.prefill(
        jcfg, p_, {"tokens": t_}, MAX_LEN, true_len=n_))(
            jparams, jnp.asarray(toks), jnp.asarray(n))
    log, c = M.prefill(cfg, params, {"tokens": torch.from_numpy(toks)},
                       MAX_LEN, true_len=torch.from_numpy(n))
    _close(log, jlog, what="prefill")
    _close_tree(c, jc)
    pos = n.copy()
    for step in range(2):
        tok = rng.integers(0, cfg.vocab_size, (B, 1)).astype(np.int32)
        jlog, jc = jax.jit(lambda *a: JM.decode_step(jcfg, *a))(
            jparams, jc, jnp.asarray(tok), jnp.asarray(pos))
        log, c = M.decode_step(cfg, params, c, torch.from_numpy(tok),
                               torch.from_numpy(pos))
        _close(log, jlog, what=f"decode {step}")
        pos = pos + 1
    _close_tree(c, jc)


def _copy_into(mine, theirs):
    for key, leaf in mine.items():
        if isinstance(leaf, dict):
            _copy_into(leaf, theirs[key])
        else:
            leaf.copy_(torch.from_numpy(np.array(theirs[key])))


PAGED = [(arch, kv, kern) for arch in (GRANITE, KIMI)
         for kv, kern in ((None, False), (None, True), ("int8", True))]


@pytest.mark.parametrize("models, kv_dtype, use_pallas", PAGED,
                         indirect=["models"])
def test_paged_entry_points_match_jax(models, kv_dtype, use_pallas):
    """``prefill_paged`` cold (true lengths 24, 17, 6 into slots 2, 0, 1),
    a radix-hit suffix prefill (ctx_len 13 mid-page and 8 page-aligned
    through full tables), a decode wave (the third row idle: its table
    is -1, as an idle slot's) and an extend wave (valid_len 4, 2, 4),
    through the gather read or the kernel read, on a float and an int8
    pool: logits of real rows, and every page (on the int8 pool each
    call reads the JAX call's pages, and logits are held at INT8_REL)."""
    jcfg, jparams, cfg, params = models
    rel = REL if kv_dtype is None else INT8_REL
    rng = np.random.default_rng(6)
    tokens = rng.integers(0, cfg.vocab_size, (B, 24)).astype(np.int32)
    true_len = np.array([24, 17, 6], np.int32)
    slots = np.array([2, 0, 1], np.int32)
    tables = np.full((B, N_BLK), -1, np.int32)
    tables[2, :5], tables[0, :4], tables[1, :2] = [3, 9, 14, 20, 21], \
        [0, 12, 4, 5], [7, 22]
    wt = tables[slots, :3].copy()
    jc = JM.init_paged_cache(jcfg, B, MAX_LEN, NB, BS, kv_dtype=kv_dtype)
    c = M.init_paged_cache(cfg, B, MAX_LEN, NB, BS, kv_dtype=kv_dtype,
                           device="cpu")

    def both(jfn, fn, args):
        jout = jax.jit(jfn)(jparams, jc, *[jnp.asarray(a) for a in args])
        out = fn(params, c, *[torch.from_numpy(a) for a in args])
        if kv_dtype == "int8":
            # one int8 level may move between the frameworks (held by
            # _close_tree): each call then reads the JAX pages, so its
            # outputs are held at REL on identical inputs
            _close_tree(out[1], jout[1])
            _copy_into(out[1], jout[1])
        return jout, out

    (jlog, jc), (log, c) = both(
        lambda p_, c_, t_, s_, w_, n_: JM.prefill_paged(
            jcfg, p_, {"tokens": t_}, MAX_LEN, c_, slots=s_,
            write_tables=w_, true_len=n_),
        lambda p_, c_, t_, s_, w_, n_: M.prefill_paged(
            cfg, p_, {"tokens": t_}, MAX_LEN, c_, slots=s_,
            write_tables=w_, true_len=n_),
        (tokens, slots, wt, true_len))
    _close(log, jlog, rel=rel, what="cold prefill")

    # hit suffixes for two fresh rows reading rows 2 and 0's chains
    hit_tables = np.full((2, 4), -1, np.int32)
    hit_tables[0] = [3, 9, 10, 11]           # ctx 13: page 9 half used
    hit_tables[1] = [0, 15, 16, -1]          # ctx 8: page-aligned
    suffix = rng.integers(0, cfg.vocab_size, (2, 6)).astype(np.int32)
    ctx = np.array([13, 8], np.int32)
    hit_n = np.array([6, 4], np.int32)
    (jlog, jc), (log, c) = both(
        lambda p_, c_, t_, s_, w_, x_, n_: JM.prefill_paged(
            jcfg, p_, {"tokens": t_}, MAX_LEN, c_, slots=s_,
            write_tables=w_, ctx_tables=w_, ctx_len=x_, true_len=n_),
        lambda p_, c_, t_, s_, w_, x_, n_: M.prefill_paged(
            cfg, p_, {"tokens": t_}, MAX_LEN, c_, slots=s_,
            write_tables=w_, ctx_tables=w_, ctx_len=x_, true_len=n_),
        (suffix, np.array([0, 1], np.int32), hit_tables, ctx, hit_n))
    _close(log, jlog, rel=rel, what="hit prefill")
    _close_tree(c, jc)

    pos = np.zeros((B,), np.int32)
    pos[slots] = true_len
    wave_tables = tables.copy()
    wave_tables[1] = -1                       # an idle slot mid-run
    tok = rng.integers(0, cfg.vocab_size, (B, 1)).astype(np.int32)
    (jlog, jc), (log, c) = both(
        lambda p_, c_, t_, q_, b_: JM.decode_step_paged(
            jcfg, p_, c_, t_, q_, b_, use_pallas),
        lambda p_, c_, t_, q_, b_: M.decode_step_paged(
            cfg, p_, c_, t_, q_, b_, use_pallas),
        (tok, pos, wave_tables))
    _close(log[[0, 2]], np.asarray(jlog)[[0, 2]], rel=rel, what="decode")

    toks = rng.integers(0, cfg.vocab_size, (B, 4)).astype(np.int32)
    valid = np.array([4, 2, 4], np.int32)
    (jlog, jc), (log, c) = both(
        lambda p_, c_, t_, q_, b_, v_: JM.extend_paged(
            jcfg, p_, c_, t_, q_, b_, v_, use_pallas),
        lambda p_, c_, t_, q_, b_, v_: M.extend_paged(
            cfg, p_, c_, t_, q_, b_, v_, use_pallas),
        (toks, pos + 1, tables, valid))
    for b in range(B):
        _close(log[b, :valid[b]], np.asarray(jlog)[b, :valid[b]],
               rel=rel, what=f"extend row {b}")
    _close_tree(c, jc)


@pytest.mark.parametrize("models", [GRANITE, KIMI], indirect=True)
def test_dense_admission_and_extend_match_jax(models):
    """The dense engine's admission (``prefill_paged`` with
    ``write_tables=None`` into ``init_cache`` strips at slots 1, 2) and
    the dense twin's ``extend`` (valid_len 3, 1, 2), at capacity factor
    1.0."""
    jcfg, jparams, cfg, params = models
    jcfg, cfg = (x.replace(capacity_factor=1.0) for x in (jcfg, cfg))
    rng = np.random.default_rng(8)
    toks = rng.integers(0, cfg.vocab_size, (2, 16)).astype(np.int32)
    n = np.array([16, 9], np.int32)
    slots = np.array([1, 2], np.int32)
    jc = JM.init_cache(jcfg, B, MAX_LEN)
    c = M.init_cache(cfg, B, MAX_LEN, "cpu")
    jlog, jc = jax.jit(lambda p_, c_, t_, s_, n_: JM.prefill_paged(
        jcfg, p_, {"tokens": t_}, MAX_LEN, c_, slots=s_, true_len=n_))(
            jparams, jc, jnp.asarray(toks), jnp.asarray(slots),
            jnp.asarray(n))
    log, c = M.prefill_paged(cfg, params, {"tokens": torch.from_numpy(toks)},
                             MAX_LEN, c, slots=torch.from_numpy(slots),
                             true_len=torch.from_numpy(n))
    _close(log, jlog, what="dense admission")
    _close_tree(c, jc)
    pos = np.array([0, 16, 9], np.int32)
    ext = rng.integers(0, cfg.vocab_size, (B, 3)).astype(np.int32)
    valid = np.array([3, 1, 2], np.int32)
    jlog, jc = jax.jit(lambda *a: JM.extend(jcfg, *a))(
        jparams, jc, jnp.asarray(ext), jnp.asarray(pos), jnp.asarray(valid))
    log, c = M.extend(cfg, params, c, torch.from_numpy(ext),
                      torch.from_numpy(pos), torch.from_numpy(valid))
    for b in range(B):
        _close(log[b, :valid[b]], np.asarray(jlog)[b, :valid[b]],
               what=f"extend row {b}")
    _close_tree(c, jc)


def test_layout_and_walk(kimi):
    """The JAX layout (``dense_layers`` then ``moe_layers``, stacked) and
    the walk order; ``paged_layers`` hands every layer's pool, dense
    first, for a per-layer criterion."""
    jcfg, jparams, cfg, params = kimi
    mine = dict(_flat(M.init_params(cfg, torch.Generator().manual_seed(0),
                                    "cpu")))
    theirs = dict(_flat(jax.tree.map(np.asarray, jparams)))
    assert mine.keys() == theirs.keys()
    for k, v in mine.items():
        assert tuple(v.shape) == theirs[k].shape, k
    cache = M.init_paged_cache(cfg, 2, 32, 8, 8, device="cpu")
    pairs = M.paged_layers(cfg, params, cache)
    assert [("mlp" in lp, "moe" in lp) for lp, _ in pairs] == \
        [(True, False), (False, True), (False, True)]
    assert pairs[0][1]["k"].data_ptr() == cache["dense_layers"]["k"].data_ptr()
    assert M.init_params(cfg.replace(param_dtype="bfloat16"),
                         torch.Generator().manual_seed(0), "cpu")[
        "moe_layers"]["moe"]["w_up"].dtype == torch.bfloat16


# ---------------------------------------------------------------------------
# the engine under capacity pressure
# ---------------------------------------------------------------------------

ENGINE_BASE = dict(max_slots=3, max_len=96, prefill_buckets=(8, 16, 32),
                   seed=3, prefix_cache=False)
# (capacity factor, ServeConfig keywords)
ENGINE_CASES = {
    "fifo-1.25": (1.25, dict(policy="fifo")),
    "priority-1.25": (1.25, dict(policy="priority")),
    "chunked-1.25": (1.25, dict(policy="fifo", chunked_prefill=True,
                                catch_chunk=6, wave_tokens=14)),
    "int8-kernel-1.25": (1.25, dict(policy="priority", quant_kv="int8",
                                    use_pallas_paged=True)),
    "kernel-1.0": (1.0, dict(policy="priority", use_pallas_paged=True)),
    "int8-kernel-1.0": (1.0, dict(policy="fifo", quant_kv="int8",
                                  use_pallas_paged=True)),
}
# budgets that free slots at different waves: idle slots ride the
# decode waves beside live ones
MAX_NEW = (3, 8, 2, 6, 10, 4, 5)


def _prompts(vocab):
    rng = np.random.default_rng(42)
    return [rng.integers(0, vocab, n, dtype=np.int32)
            for n in (5, 21, 9, 40, 3, 17, 33)]


def _traffic(request_cls, vocab):
    return [request_cls(uid=u, prompt=p, max_new_tokens=MAX_NEW[u],
                        priority=u % 3, deadline=float(u))
            for u, p in enumerate(_prompts(vocab))]


def _drain(eng, reqs):
    for r in reqs:
        eng.submit(r)
    eng.run_until_drained()
    return {r.uid: tuple(r.generated) for r in eng.completed}


@pytest.fixture(scope="module")
def granite_1_0():
    return _bridge(GRANITE, capacity_factor=1.0)


@pytest.fixture(scope="module", params=list(ENGINE_CASES))
def replay(request, granite, granite_1_0):
    """(case, JAX engine, JAX tokens, port engine, port tokens) on the
    granite smoke weights."""
    cf, kw = ENGINE_CASES[request.param]
    jcfg, jparams, cfg, params = granite if cf == 1.25 else granite_1_0
    kw = dict(ENGINE_BASE, **kw)
    jeng = JaxEngine(jcfg, jparams, JaxServeConfig(**kw))
    jtok = _drain(jeng, _traffic(JaxRequest, jcfg.vocab_size))
    eng = EdgeServingEngine(cfg, params, ServeConfig(**kw), device="cpu")
    return request.param, jeng, jtok, eng, _drain(
        eng, _traffic(Request, cfg.vocab_size))


def test_moe_engine_tokens_match_jax_engine(replay):
    case, _, jtok, _, tok = replay
    assert len(tok) == 7
    assert tok == jtok, f"token drift vs the JAX engine ({case})"


def test_moe_engine_stats_match_jax_engine(replay):
    case, jeng, _, eng, _ = replay
    assert eng.stats() == jeng.stats(), case
    assert eng.extend_waves >= 1 and eng.decode_waves >= 1, case
    eng.pool.assert_consistent()
    assert eng.pool.num_free == eng.pool.num_blocks


def test_idle_slots_change_tokens_under_pressure(granite_1_0):
    """The contract the replay holds: a decode wave's idle rows compete
    for capacity (c = ceil(3 * 2 * 1.0 / 4) = 2 here), so the same
    requests served alone give other tokens than served together.  The
    port's idle rows must therefore be the JAX engine's: their stale
    token and position, and a read of 0 where the row has no page (the
    kernels' definition, on the CPU too)."""
    jcfg, jparams, cfg, params = granite_1_0
    kw = dict(ENGINE_BASE, policy="fifo")
    together = _drain(EdgeServingEngine(cfg, params, ServeConfig(**kw),
                                        device="cpu"),
                      _traffic(Request, cfg.vocab_size))
    alone = {}
    for r in _traffic(Request, cfg.vocab_size):
        eng = EdgeServingEngine(cfg, params, ServeConfig(**kw), device="cpu")
        alone.update(_drain(eng, [r]))
    assert together != alone


@pytest.fixture(scope="module")
def kimi_1_0():
    return _bridge(KIMI, capacity_factor=1.0)


def test_kimi_engine_matches_jax_engine(kimi_1_0):
    """kimi's dense first layer and shared expert in the paged engine at
    capacity factor 1.0, priority, the kernel reads."""
    jcfg, jparams, cfg, params = kimi_1_0
    kw = dict(ENGINE_BASE, policy="priority", use_pallas_paged=True)
    jeng = JaxEngine(jcfg, jparams, JaxServeConfig(**kw))
    jtok = _drain(jeng, _traffic(JaxRequest, cfg.vocab_size))
    eng = EdgeServingEngine(cfg, params, ServeConfig(**kw), device="cpu")
    assert _drain(eng, _traffic(Request, cfg.vocab_size)) == jtok
    assert eng.stats() == jeng.stats()


@pytest.mark.parametrize("paged", [True, False])
def test_defaults_and_dense_twin_match_jax(granite, paged):
    """``ServeConfig()``'s defaults (the radix prefix cache on: moe is
    ``prefix_sharable``) on the paged engine, and the dense twin
    (``paged=False``), each against the JAX engine of the same config."""
    jcfg, jparams, cfg, params = granite
    kw = dict(max_len=96, prefill_buckets=(8, 16, 32), paged=paged)
    jeng = JaxEngine(jcfg, jparams, JaxServeConfig(**kw))
    jtok = _drain(jeng, _traffic(JaxRequest, cfg.vocab_size))
    eng = EdgeServingEngine(cfg, params, ServeConfig(**kw), device="cpu")
    assert (eng.prefix_cache is not None) == paged
    assert _drain(eng, _traffic(Request, cfg.vocab_size)) == jtok
    assert eng.stats() == jeng.stats()


# ---------------------------------------------------------------------------
# replays of the JAX package's moe cases on the port
# ---------------------------------------------------------------------------

def _reference_decode(cfg, params, prompt, max_new, max_len):
    logits, cache = M.prefill(cfg, params,
                              {"tokens": torch.from_numpy(prompt)[None]},
                              max_len)
    tok = int(torch.argmax(logits[0, -1]))
    out, pos = [tok], len(prompt)
    for _ in range(max_new - 1):
        lg, cache = M.decode_step(cfg, params, cache,
                                  torch.tensor([[tok]], dtype=torch.int32),
                                  torch.tensor([pos], dtype=torch.int32))
        tok = int(torch.argmax(lg[0, -1]))
        out.append(tok)
        pos += 1
    return out


@pytest.mark.parametrize("arch", [GRANITE, KIMI])
def test_decode_matches_forward(arch):
    """``test_decode_consistency.test_decode_matches_forward``'s moe cases
    (capacity factor 100) on the port, on the JAX test's weights: a
    prefill of 8 then one decode step equals the full forward's last
    row, and the JAX package's step."""
    jcfg, jparams, cfg, params = _bridge(arch, capacity_factor=100.0)
    rng = np.random.default_rng(0)
    toks = rng.integers(0, cfg.vocab_size, (2, 9)).astype(np.int32)
    _, cache = M.prefill(cfg, params,
                         {"tokens": torch.from_numpy(toks[:, :8])}, 48)
    step, _ = M.decode_step(cfg, params, cache,
                            torch.from_numpy(toks[:, 8:9]),
                            torch.full((2,), 8, dtype=torch.int32))
    full, _ = M.apply(cfg, params, {"tokens": torch.from_numpy(toks)})
    _close(step[:, 0], full[:, -1], rel=1e-4, what="decode vs forward")
    _, jcache = JM.prefill(jcfg, jparams, {"tokens": jnp.asarray(toks[:, :8])},
                           48)
    jstep, _ = JM.decode_step(jcfg, jparams, jcache,
                              jnp.asarray(toks[:, 8:9]),
                              jnp.full((2,), 8, jnp.int32))
    _close(step, jstep, what="decode vs JAX")


def test_padded_admission_matches_reference():
    """``test_decode_consistency.test_padded_admission_matches_reference``
    for granite (capacity factor 100, the JAX test's config): prompts of
    5, 17 and 33 tokens (buckets 8 and 16: two catch up) decode token
    for token like the sequential prefill + decode reference, the
    port's and the JAX package's."""
    jcfg, jparams, cfg, params = _bridge(GRANITE, capacity_factor=100.0)
    rng = np.random.default_rng(0)
    eng = EdgeServingEngine(cfg, params, ServeConfig(
        max_slots=3, max_len=96, prefill_buckets=(8, 16)), device="cpu")
    reqs = [Request(uid=u, prompt=rng.integers(0, cfg.vocab_size, n,
                                               dtype=np.int32),
                    max_new_tokens=6) for u, n in enumerate([5, 17, 33])]
    _drain(eng, reqs)
    jpre = jax.jit(lambda p_, t_: JM.prefill(jcfg, p_, {"tokens": t_}, 96))
    jdec = jax.jit(lambda *a: JM.decode_step(jcfg, *a))
    for r in reqs:
        ref = _reference_decode(cfg, params, r.prompt, 6, 96)
        lg, c = jpre(jparams, jnp.asarray(r.prompt)[None])
        jref = [int(jnp.argmax(lg[0, -1]))]
        for i in range(5):
            lg, c = jdec(jparams, c, jnp.asarray([[jref[-1]]], jnp.int32),
                         jnp.full((1,), len(r.prompt) + i, jnp.int32))
            jref.append(int(jnp.argmax(lg[0, -1])))
        assert list(r.generated) == ref == jref, r.uid


def _sharable_setup():
    return _bridge(GRANITE, capacity_factor=100.0)


@pytest.fixture(scope="module")
def granite_100():
    return _sharable_setup()


def _shared_traffic(cls, cfg, n=4, sys_len=24, seed=7, tail0=4, sample=True):
    """``test_prefix_cache._shared_traffic``: one system prompt, unique
    tails, odd requests sampled (with ``sample``)."""
    rng = np.random.default_rng(seed)
    sys_prompt = rng.integers(0, cfg.vocab_size, sys_len, dtype=np.int32)
    reqs = []
    for uid in range(n):
        tail = np.random.default_rng(50 + uid).integers(
            0, cfg.vocab_size, tail0 + uid, dtype=np.int32)
        samp = sample and uid % 2
        reqs.append(cls(uid=uid, prompt=np.concatenate([sys_prompt, tail]),
                        max_new_tokens=5, temperature=0.8 if samp else 0.0,
                        top_k=6 if samp else 0))
    return reqs


def _sequential(eng, reqs):
    for r in reqs:
        eng.submit(r)
        eng.run_until_drained()
    return {r.uid: tuple(r.generated) for r in eng.completed}


SEQ_KW = dict(max_slots=2, max_len=96, prefill_buckets=(16, 32), seed=5)


@pytest.mark.parametrize("sys_len", [24, 21])
def test_prefix_hit_equals_cold_and_jax(granite_100, sys_len):
    """``test_prefix_cache``'s granite cases: page-aligned hits (24: the
    case at ``test_prefix_hit_decode_bit_identical_to_cold``, odd
    requests sampled) and token-granular ones (21: mid-page, a
    copy-on-write fork).  On the port hit tokens equal the cache-off
    run's, greedy and sampled; the greedy rows equal the JAX cache-off
    engine's."""
    jcfg, jparams, cfg, params = granite_100
    cold_eng = EdgeServingEngine(cfg, params, ServeConfig(
        **SEQ_KW, prefix_cache=False), device="cpu")
    cold = _sequential(cold_eng, _shared_traffic(Request, cfg,
                                                 sys_len=sys_len))
    hot_eng = EdgeServingEngine(cfg, params, ServeConfig(
        **SEQ_KW, prefix_cache=True), device="cpu")
    hot = _sequential(hot_eng, _shared_traffic(Request, cfg,
                                               sys_len=sys_len))
    assert hot == cold
    st = hot_eng.prefix_cache.stats()
    assert st["hits"] >= 2, st
    if sys_len % 16:
        assert st["hit_tokens"] > st["hit_tokens_block"]
        assert hot_eng.cow_forks >= 1
    hot_eng.pool.assert_consistent()
    assert (hot_eng.pool.num_free + hot_eng.prefix_cache.num_blocks
            == hot_eng.pool.num_blocks)
    jeng = JaxEngine(jcfg, jparams, JaxServeConfig(**SEQ_KW,
                                                   prefix_cache=False))
    jcold = _sequential(jeng, _shared_traffic(JaxRequest, jcfg,
                                              sys_len=sys_len))
    for uid in (0, 2):
        assert cold[uid] == jcold[uid], uid


def test_preempt_shared_pages_resumes_exactly(granite_100):
    """``test_preempt_shared_pages_resumes_bit_identical[granite]``: a
    request whose prefix pages the radix cache shares is preempted
    mid-decode and resumed; its tokens (sampled) equal an uninterrupted
    cache-on run's and a cache-off run's, and no page leaks."""
    _, _, cfg, params = granite_100
    rng = np.random.default_rng(11)
    sys_prompt = rng.integers(0, cfg.vocab_size, 16, dtype=np.int32)
    tail = rng.integers(0, cfg.vocab_size, 5, dtype=np.int32)

    def run(cache_on, preempt=False):
        eng = EdgeServingEngine(cfg, params, ServeConfig(
            max_slots=1, max_len=96, prefill_buckets=(8, 32), seed=9,
            prefix_cache=cache_on), device="cpu")
        eng.submit(Request(uid=0, prompt=sys_prompt.copy(),
                           max_new_tokens=2))
        eng.run_until_drained()
        r = Request(uid=1, prompt=np.concatenate([sys_prompt, tail]),
                    max_new_tokens=8, temperature=0.9, top_k=8)
        eng.submit(r)
        if preempt:
            eng.step()
            eng.step()
            assert not r.done and r.generated
            assert any(eng.pool.refcount(b) > 1 for b in eng.slot_blocks[0])
            assert eng.preempt(0) is r
            eng.pool.assert_consistent()
            eng.submit(r)
        eng.run_until_drained()
        if cache_on:
            assert eng.prefix_cache.hits >= 1 and r.saved_state is None
            eng.pool.assert_consistent()
            assert (eng.pool.num_free + eng.prefix_cache.num_blocks
                    == eng.pool.num_blocks)
        return tuple(r.generated)

    base = run(True)
    assert run(False) == base
    assert run(True, preempt=True) == base


def test_in_flight_hit_equals_cold_and_jax(granite_100):
    """``test_in_flight_hit_bit_identical_to_cold[granite]``: a reader
    admitted while the writer still decodes hits the writer's published
    frontier; both decode what each decodes alone on a cache-off engine,
    which is the JAX cache-off engine's output."""
    jcfg, jparams, cfg, params = granite_100
    rng = np.random.default_rng(17)
    sys_prompt = rng.integers(0, cfg.vocab_size, 24, dtype=np.int32)
    tail = np.asarray([3, 1, 4, 1, 5], np.int32)

    def pair(cls):
        return (cls(uid=0, prompt=sys_prompt.copy(), max_new_tokens=16),
                cls(uid=1, prompt=np.concatenate([sys_prompt, tail]),
                    max_new_tokens=5))
    eng = EdgeServingEngine(cfg, params, ServeConfig(
        **SEQ_KW, prefix_cache=True), device="cpu")
    writer, reader = pair(Request)
    eng.submit(writer)
    for _ in range(3):
        eng.drain_step()
    assert not writer.done and eng.published_frontiers >= 1
    eng.submit(reader)
    eng.drain_step()
    assert eng.prefix_cache.hits >= 1 and not writer.done
    eng.run_until_drained()
    eng.pool.assert_consistent()
    for i, got in enumerate((writer, reader)):
        ref = EdgeServingEngine(cfg, params, ServeConfig(
            **SEQ_KW, prefix_cache=False), device="cpu")
        alone = _sequential(ref, [pair(Request)[i]])
        jref = JaxEngine(jcfg, jparams, JaxServeConfig(**SEQ_KW,
                                                       prefix_cache=False))
        jalone = _sequential(jref, [pair(JaxRequest)[i]])
        assert tuple(got.generated) == alone[i] == jalone[i], i


def test_prefix_store_rejects_another_config_and_restarts_warm(
        granite_100, tmp_path):
    """``test_prefix_persist``'s granite cases: a store written by a phi3
    engine is rejected by a granite engine (a mismatched config) that
    then serves cold; a granite store restarts warm, its hits equal to
    the cold run."""
    _, _, cfg, params = granite_100
    path = str(tmp_path / "store.npz")
    pcfg = get_smoke_config("phi3-medium-14b")
    pparams = M.init_params(pcfg, torch.Generator().manual_seed(0), "cpu")
    kw = dict(SEQ_KW, prefix_cache=True)
    phi = EdgeServingEngine(pcfg, pparams, ServeConfig(
        **kw, prefix_persist_path=path), device="cpu")
    _sequential(phi, _shared_traffic(Request, pcfg, n=2, sample=False))
    assert phi.close()["persist_saved_chains"] >= 1
    eng = EdgeServingEngine(cfg, params, ServeConfig(
        **kw, prefix_persist_path=path), device="cpu")
    assert eng.persist_loaded_chains == 0
    assert "mismatched" in eng.persist_rejected
    cold = _sequential(EdgeServingEngine(cfg, params, ServeConfig(
        **dict(SEQ_KW, prefix_cache=False)), device="cpu"),
        _shared_traffic(Request, cfg, n=3, sample=False))
    assert _sequential(eng, _shared_traffic(Request, cfg, n=3,
                                            sample=False)) == cold
    assert eng.close()["persist_saved_chains"] >= 1
    warm = EdgeServingEngine(cfg, params, ServeConfig(
        **kw, prefix_persist_path=path), device="cpu")
    assert warm.persist_loaded_chains >= 1 and not warm.persist_rejected
    assert _sequential(warm, _shared_traffic(Request, cfg, n=3,
                                             sample=False)) == cold
    assert warm.prefix_cache.hits >= 3


SPEC_KW = dict(max_slots=4, max_len=96, prefill_buckets=(8, 16))


def _spec_reqs(cls, cfg, lens=(5, 9, 17, 33)):
    rng = np.random.default_rng(3)
    return [cls(uid=u, prompt=rng.integers(0, cfg.vocab_size, n,
                                           dtype=np.int32),
                max_new_tokens=8) for u, n in enumerate(lens)]


def test_spec_verify_with_identity_and_chance_drafts(granite_100):
    """``test_spec_greedy_bit_equals_vanilla[granite]``: the moe verify
    model served speculatively with the identity draft (moe's dense
    ``prefill`` / ``decode_step``) and with a chance-level gemma3-1b
    draft equals vanilla serving token for token, and vanilla equals
    the JAX engine."""
    jcfg, jparams, cfg, params = granite_100
    base = _drain(EdgeServingEngine(cfg, params, ServeConfig(**SPEC_KW),
                                    device="cpu"),
                  _spec_reqs(Request, cfg))
    jbase = _drain(JaxEngine(jcfg, jparams, JaxServeConfig(**SPEC_KW)),
                   _spec_reqs(JaxRequest, jcfg))
    assert base == jbase
    ident = EdgeServingEngine(cfg, params, ServeConfig(
        **SPEC_KW, spec_decode=True, spec_gamma=4), draft=(cfg, params),
        device="cpu")
    assert _drain(ident, _spec_reqs(Request, cfg)) == base
    st = ident.stats()
    assert st["spec_active"] and st["spec_rounds"] > 0
    assert st["spec_acceptance"] > 0
    dcfg = get_smoke_config("gemma3-1b")
    dparams = M.init_params(dcfg, torch.Generator().manual_seed(9), "cpu")
    cross = EdgeServingEngine(cfg, params, ServeConfig(
        **SPEC_KW, spec_decode=True, spec_gamma=4), draft=(dcfg, dparams),
        device="cpu")
    assert _drain(cross, _spec_reqs(Request, cfg)) == base
    st = cross.stats()
    assert st["spec_accepted"] < st["spec_proposed"]
    assert cross.pool.num_free + cross.prefix_cache.stats()[
        "cached_blocks"] == cross.pool.num_blocks


def test_extend_pad_rows_are_inert(kimi_1_0):
    """``test_spec_decode.test_extend_pad_rows_are_inert`` on kimi at
    capacity factor 1.0: rows past ``valid_len`` take no capacity, so
    their token content leaks neither into real rows' logits nor into
    the pages; the real rows equal JAX's."""
    jcfg, jparams, cfg, params = kimi_1_0
    rng = np.random.default_rng(0)
    max_len, bs, Bq, K = 64, 8, 2, 4
    n_blk = max_len // bs
    tables = np.stack([np.arange(n_blk) + i * n_blk
                       for i in range(Bq)]).astype(np.int32)
    prompt = rng.integers(0, cfg.vocab_size, (Bq, 6)).astype(np.int32)
    real = rng.integers(0, cfg.vocab_size, (Bq, 2)).astype(np.int32)

    def run(pad_tok):
        cache = M.init_paged_cache(cfg, Bq, max_len, Bq * n_blk, bs,
                                   device="cpu")
        M.prefill_paged(cfg, params, {"tokens": torch.from_numpy(prompt)},
                        max_len, cache, slots=torch.arange(Bq),
                        write_tables=torch.from_numpy(tables[:, :1]))
        toks = np.concatenate([real, np.full((Bq, K - 2), pad_tok,
                                             np.int32)], axis=1)
        lg, cache = M.extend_paged(cfg, params, cache, torch.from_numpy(toks),
                                   torch.full((Bq,), 6, dtype=torch.int32),
                                   torch.from_numpy(tables),
                                   torch.full((Bq,), 2, dtype=torch.int32))
        return lg[:, :2], cache, toks

    la, ca, toks = run(int(real[0, -1]))
    lb, cb, _ = run(int((real[0, -1] + 1) % cfg.vocab_size))
    assert torch.equal(la, lb)
    for key in ("dense_layers", "moe_layers"):
        for leaf in ("k", "v"):
            assert torch.equal(ca[key][leaf], cb[key][leaf])
    jc = JM.init_paged_cache(jcfg, Bq, max_len, Bq * n_blk, bs)
    _, jc = JM.prefill_paged(jcfg, jparams, {"tokens": jnp.asarray(prompt)},
                             max_len, jc, slots=jnp.arange(Bq),
                             write_tables=jnp.asarray(tables[:, :1]))
    jl, _ = JM.extend_paged(jcfg, jparams, jc, jnp.asarray(toks),
                            jnp.full((Bq,), 6, jnp.int32),
                            jnp.asarray(tables), jnp.full((Bq,), 2,
                                                          jnp.int32))
    _close(la, np.asarray(jl)[:, :2], what="real rows")


def test_engine_other_families_granite(granite):
    """``test_serving.test_engine_other_families[granite]`` on the port
    (the registry config's capacity factor): three requests finish with
    4 tokens each, the JAX engine's."""
    jcfg, jparams, cfg, params = granite
    kw = dict(max_slots=2, max_len=64, prefill_buckets=(8,))

    def reqs(cls):
        rng = np.random.default_rng(0)
        return [cls(uid=u, prompt=rng.integers(0, cfg.vocab_size, 6,
                                               dtype=np.int32),
                    max_new_tokens=4) for u in range(3)]
    eng = EdgeServingEngine(cfg, params, ServeConfig(**kw), device="cpu")
    got = _drain(eng, reqs(Request))
    assert len(got) == 3 and all(len(t) == 4 for t in got.values())
    assert got == _drain(JaxEngine(jcfg, jparams, JaxServeConfig(**kw)),
                         reqs(JaxRequest))


def test_serve_cli_runs_granite_on_the_cpu(capsys):
    """``launch.serve --arch granite-moe-1b-a400m --scale smoke --device
    cpu`` at its defaults (async, the prefix cache on)."""
    import json
    serve.main(["--arch", GRANITE, "--scale", "smoke", "--device", "cpu",
                "--requests", "3", "--max-new", "4", "--max-prompt", "40"])
    line = next(json.loads(ln) for ln in capsys.readouterr().out
                .splitlines() if ln.startswith("{"))
    assert line["requests"] == 3 and line["tokens"] == 12
