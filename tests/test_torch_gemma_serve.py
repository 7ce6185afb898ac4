"""gemma3-1b served by the port: local ring layers beside paged global
layers, against ``repro.models`` and the JAX engine.

The gemma3-1b smoke config at float32 (period 3: two local layers and
one global per super-block, window 16) with the JAX weights bridged into
the port.  The ring functions (``attention_decode`` / ``attention_extend``
on a ring and on a strip, ``transformer._fill_local``) are held to their
JAX functions on identical inputs; the model entry points
(``prefill`` + ``decode_step`` past the window, ``prefill_paged`` +
``decode_step_paged`` + ``extend_paged`` with the gather and the kernel
reads, on a float and an int8 pool) run an 8-layer variant of the smoke
config, so that the two ``rem_local`` layers after the super-blocks are
walked too.  Logits within rtol=atol=1e-4, as
``tests/test_torch_model.py``; ring contents and slots exactly as JAX's
float32 results allow (slots equal, values within the same tolerance).
The engine replays ``tests/test_engine_matrix.py``'s traffic through
both engines (fifo, priority, chunked catch-up with a chunk of 6 <= W,
a pool tight enough to preempt and resume slots with their ring rows,
and an int8 pool through the kernel reads): greedy tokens and every
``stats()`` counter must be the JAX engine's.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as jax_smoke_config
from repro.models import layers as JL
from repro.models import model as JM
from repro.models import transformer as JT
from repro.serving import EdgeServingEngine as JaxEngine
from repro.serving import Request as JaxRequest
from repro.serving import ServeConfig as JaxServeConfig
from repro_torch.bridge import params_from_numpy
from repro_torch.configs import get_smoke_config
from repro_torch.kernels import checks
from repro_torch.kernels import paged_attention as pa
from repro_torch.launch import serve
from repro_torch.models import layers as L
from repro_torch.models import model as M
from repro_torch.models import transformer as T
from repro_torch.serving import EdgeServingEngine, Request, ServeConfig
from repro_torch.serving.engine import (extract_slot, insert_slot,
                                        paged_cache_axes)
from repro_torch.training import checkpoint as ckpt

ARCH = "gemma3-1b"
TOL = dict(rtol=1e-4, atol=1e-4)
# int8 pages after 8 float32 layers of two frameworks: a K/V value that
# lands within float noise of a rounding boundary takes the next level
INT8_MOVED = 1e-3
DEEP_LAYERS = 8          # two super-blocks of 3 and two rem_local layers
B, MAX_LEN, NB, BS = 3, 64, 24, 8
N_BLK = MAX_LEN // BS
BASE = dict(max_slots=3, max_len=96, prefill_buckets=(8, 16, 32), seed=3,
            prefix_cache=False)
CASES = {
    "fifo": dict(policy="fifo"),
    "priority": dict(policy="priority"),
    "chunked": dict(policy="fifo", chunked_prefill=True, catch_chunk=6,
                    wave_tokens=14),
    # 5 pages of 16 tokens for 3 slots: a wave runs out of pages,
    # preempts a slot (pages detached, ring rows copied out) and later
    # resumes it
    "tight_pool": dict(policy="priority", kv_pool_blocks=5),
    "int8": dict(policy="priority", quant_kv="int8", use_pallas_paged=True),
}


def _bridge(jcfg, seed):
    jparams = jax.jit(lambda key: JM.init_params(jcfg, key))(
        jax.random.PRNGKey(seed))
    return jparams, params_from_numpy(jax.tree.map(np.asarray, jparams),
                                      device="cpu")


@pytest.fixture(scope="module")
def models():
    """The smoke config (6 layers), JAX and port, bridged weights."""
    jcfg = jax_smoke_config(ARCH).replace(dtype="float32")
    jparams, params = _bridge(jcfg, 0)
    return jcfg, jparams, get_smoke_config(ARCH).replace(dtype="float32"), \
        params


@pytest.fixture(scope="module")
def deep():
    """An 8-layer variant: 2 super-blocks and 2 ``rem_local`` layers."""
    jcfg = jax_smoke_config(ARCH).replace(dtype="float32",
                                          num_layers=DEEP_LAYERS)
    jparams, params = _bridge(jcfg, 1)
    cfg = get_smoke_config(ARCH).replace(dtype="float32",
                                         num_layers=DEEP_LAYERS)
    assert cfg.pattern_blocks() == (2, 2)
    return jcfg, jparams, cfg, params


def _np(t):
    return t.numpy() if isinstance(t, torch.Tensor) else np.asarray(t)


def _close(mine, theirs):
    """Trees of tensors against trees of JAX arrays: slots equal, int8
    pages within one level in at most ``INT8_MOVED`` of the bytes, float
    leaves (K/V, scales) within TOL."""
    assert set(mine) == set(theirs)
    for key, leaf in mine.items():
        if isinstance(leaf, dict):
            _close(leaf, theirs[key])
            continue
        a, b = _np(leaf), _np(theirs[key])
        assert a.shape == b.shape and a.dtype == b.dtype, key
        if a.dtype == np.int8:
            # float noise between the frameworks can move a value across
            # a rounding boundary: one level, in a handful of bytes
            d = np.abs(a.astype(np.int32) - b.astype(np.int32))
            assert d.max() <= 1 and (d > 0).mean() <= INT8_MOVED, key
        elif a.dtype.kind in "iu":
            assert np.array_equal(a, b), key
        else:
            np.testing.assert_allclose(a, b, **TOL)


# ---------------------------------------------------------------------------
# layers: the ring branch of attention_decode, attention_extend
# ---------------------------------------------------------------------------

def _attn(deep, is_global):
    """The first local (or global) layer's attention params, both sides."""
    _, jparams, _, params = deep
    if is_global:
        return (jax.tree.map(lambda a: a[0],
                             jparams["trunk"]["super"]["global"]["attn"]),
                T._layer(params["trunk"]["super"]["global"], 0)["attn"])
    return (jax.tree.map(lambda a: a[0, 0],
                         jparams["trunk"]["super"]["local"]["attn"]),
            T._layer(T._layer(params["trunk"]["super"]["local"], 0),
                     0)["attn"])


def _dense_state(cfg, rng, pos, length):
    """A ring (``window``) or strip of ``length`` entries per row as the
    sequential decode leaves it before position ``pos[b]``: entry j holds
    the largest p < pos[b] with p % length == j, with a -1 hole per
    row."""
    K, hd = cfg.num_kv_heads, cfg.head_dim
    slots = np.full((len(pos), length), -1, np.int32)
    for b, p in enumerate(pos):
        for j in range(length):
            q = j + ((p - 1 - j) // length) * length
            if q >= 0:
                slots[b, j] = q
        slots[b, (3 * b + 1) % length] = -1
    k = rng.standard_normal((len(pos), length, K, hd)).astype(np.float32)
    v = rng.standard_normal((len(pos), length, K, hd)).astype(np.float32)
    return {"k": k, "v": v, "slots": slots}


def _both(state):
    return ({k: jnp.asarray(a) for k, a in state.items()},
            {k: torch.from_numpy(a.copy()) for k, a in state.items()})


@pytest.mark.parametrize("is_global", [False, True])
def test_attention_decode_matches_jax(deep, is_global):
    """Rows before, at and past the window (pos 3, 16, 37 on a 16-entry
    ring; a 64-entry strip on the global layer), each with a -1 hole."""
    jcfg, _, cfg, _ = deep
    jp, p = _attn(deep, is_global)
    rng = np.random.default_rng(2)
    pos = np.array([3, 16, 37], np.int32)
    length = MAX_LEN if is_global else cfg.local_window
    jc, c = _both(_dense_state(cfg, rng, pos, length))
    x = rng.standard_normal((B, 1, cfg.d_model)).astype(np.float32)
    jo, jc = jax.jit(lambda *a: JL.attention_decode(
        jcfg, *a, is_global=is_global))(jp, jnp.asarray(x), jc,
                                        jnp.asarray(pos))
    o, c = L.attention_decode(cfg, p, torch.from_numpy(x), c,
                              torch.from_numpy(pos), is_global=is_global)
    np.testing.assert_allclose(o.numpy(), np.asarray(jo), **TOL)
    _close(c, jc)


@pytest.mark.parametrize("is_global", [False, True])
def test_attention_extend_matches_jax(deep, is_global):
    """S=5 tokens at pos 3 (inside the window), 14 (wrapping the ring)
    and 40 (past it), with valid_len 5, 2 and 0: pad rows write
    nothing."""
    jcfg, _, cfg, _ = deep
    jp, p = _attn(deep, is_global)
    rng = np.random.default_rng(3)
    S = 5
    pos = np.array([3, 14, 40], np.int32)
    valid = np.array([5, 2, 0], np.int32)
    length = MAX_LEN if is_global else cfg.local_window
    jc, c = _both(_dense_state(cfg, rng, pos, length))
    x = rng.standard_normal((B, S, cfg.d_model)).astype(np.float32)
    jo, jc = jax.jit(lambda p_, x_, c_, pos_, n_: JL.attention_extend(
        jcfg, p_, x_, c_, pos_, is_global=is_global, valid_len=n_))(
            jp, jnp.asarray(x), jc, jnp.asarray(pos), jnp.asarray(valid))
    before = c["slots"].clone()
    o, c = L.attention_extend(cfg, p, torch.from_numpy(x), c,
                              torch.from_numpy(pos), is_global=is_global,
                              valid_len=torch.from_numpy(valid))
    np.testing.assert_allclose(o.numpy(), np.asarray(jo), **TOL)
    _close(c, jc)
    assert torch.equal(c["slots"][2], before[2])      # valid_len 0


@pytest.mark.parametrize("S", [10, 40])
@pytest.mark.parametrize("ragged", [False, True])
def test_fill_local_matches_jax(deep, S, ragged):
    """The ring a prefill leaves, for prompts shorter and longer than
    the window, with and without true lengths: exactly JAX's."""
    jcfg, _, cfg, _ = deep
    rng = np.random.default_rng(4)
    K, hd = cfg.num_kv_heads, cfg.head_dim
    k = rng.standard_normal((B, S, K, hd)).astype(np.float32)
    v = rng.standard_normal((B, S, K, hd)).astype(np.float32)
    n = np.array([S, S - 3, 1], np.int32) if ragged else None
    jc = JT._fill_local(jcfg, B, MAX_LEN, jnp.asarray(k), jnp.asarray(v),
                        None if n is None else jnp.asarray(n))
    c = L.init_kv_cache(cfg, B, min(cfg.local_window, MAX_LEN),
                        dtype=torch.float32, device="cpu")
    T._fill_local(c, torch.from_numpy(k), torch.from_numpy(v),
                  None if n is None else torch.from_numpy(n))
    for key in ("k", "v", "slots"):
        assert np.array_equal(c[key].numpy(), np.asarray(jc[key])), key


# ---------------------------------------------------------------------------
# model entry points
# ---------------------------------------------------------------------------

def _shapes(tree):
    return {k: (_shapes(v) if isinstance(v, dict)
                else (tuple(v.shape), str(v.dtype).replace("torch.", "")))
            for k, v in tree.items()}


@pytest.mark.parametrize("kind", ["dense", "paged", "paged-int8"])
def test_cache_layout_matches_jax(deep, kind):
    """``init_cache`` / ``init_paged_cache`` build JAX's tree: super-block
    rings stacked (nb, period-1), global strips or pool (nb,), and the
    ``rem_local`` rings; rings stay in the activation dtype under int8."""
    jcfg, _, cfg, _ = deep
    if kind == "dense":
        jc = JM.init_cache(jcfg, B, MAX_LEN)
        c = M.init_cache(cfg, B, MAX_LEN, device="meta")
    else:
        kv = "int8" if kind == "paged-int8" else None
        jc = JM.init_paged_cache(jcfg, B, MAX_LEN, NB, BS, kv_dtype=kv)
        c = M.init_paged_cache(cfg, B, MAX_LEN, NB, BS, kv_dtype=kv,
                               device="meta")
    assert _shapes(c) == _shapes(jc)


def test_prefill_and_decode_past_the_window_match_jax(deep):
    """A ragged prefill (true lengths 20 and 13 of a 20-token bucket),
    then three decode steps: logits and every ring and strip."""
    jcfg, jparams, cfg, params = deep
    rng = np.random.default_rng(5)
    tokens = rng.integers(0, cfg.vocab_size, (2, 20)).astype(np.int32)
    true_len = np.array([20, 13], np.int32)
    jlog, jc = jax.jit(lambda p_, t_, n_: JM.prefill(
        jcfg, p_, {"tokens": t_}, MAX_LEN, true_len=n_))(
            jparams, jnp.asarray(tokens), jnp.asarray(true_len))
    jdecode = jax.jit(lambda *a: JM.decode_step(jcfg, *a))
    log, c = M.prefill(cfg, params, {"tokens": torch.from_numpy(tokens)},
                       MAX_LEN, true_len=torch.from_numpy(true_len))
    np.testing.assert_allclose(log.numpy(), np.asarray(jlog), **TOL)
    _close(c, jc)
    for step in range(3):
        tok = rng.integers(0, cfg.vocab_size, (2, 1)).astype(np.int32)
        pos = true_len + step
        jlog, jc = jdecode(jparams, jc, jnp.asarray(tok), jnp.asarray(pos))
        log, c = M.decode_step(cfg, params, c, torch.from_numpy(tok),
                               torch.from_numpy(pos))
        np.testing.assert_allclose(log.numpy(), np.asarray(jlog), **TOL)
    _close(c, jc)


@pytest.mark.parametrize("kv_dtype, use_pallas", [
    (None, False), (None, True), ("int8", True)])
def test_paged_prefill_decode_extend_match_jax(deep, kv_dtype, use_pallas):
    """``prefill_paged`` of three ragged rows (true lengths 24, 17, 6)
    into slots 2, 0, 1, then a decode wave and an extend wave of S=4
    (valid_len 4, 2, 4) past the window, through the gather read or the
    kernel read (the plain versions here; the Pallas kernels in
    interpret mode on the JAX side): logits, rings and pages."""
    jcfg, jparams, cfg, params = deep
    rng = np.random.default_rng(6)
    tokens = rng.integers(0, cfg.vocab_size, (B, 24)).astype(np.int32)
    true_len = np.array([24, 17, 6], np.int32)
    slots = np.array([2, 0, 1], np.int32)
    tables = np.full((B, N_BLK), -1, np.int32)
    tables[2, :4], tables[0, :3], tables[1, :2] = [3, 9, 14, 20], \
        [0, 12, 4], [7, 22]
    wt = tables[slots, :3].copy()
    jc = JM.init_paged_cache(jcfg, B, MAX_LEN, NB, BS, kv_dtype=kv_dtype)
    c = M.init_paged_cache(cfg, B, MAX_LEN, NB, BS, kv_dtype=kv_dtype,
                           device="cpu")
    jlog, jc = jax.jit(lambda p_, t_, c_, s_, w_, n_: JM.prefill_paged(
        jcfg, p_, {"tokens": t_}, MAX_LEN, c_, slots=s_, write_tables=w_,
        true_len=n_))(jparams, jnp.asarray(tokens), jc, jnp.asarray(slots),
                      jnp.asarray(wt), jnp.asarray(true_len))
    log, c = M.prefill_paged(cfg, params, {"tokens": torch.from_numpy(tokens)},
                             MAX_LEN, c, slots=torch.from_numpy(slots),
                             write_tables=torch.from_numpy(wt),
                             true_len=torch.from_numpy(true_len))
    np.testing.assert_allclose(log.numpy(), np.asarray(jlog), **TOL)
    _close(c, jc)

    pos = np.zeros((B,), np.int32)
    pos[slots] = true_len
    tok = rng.integers(0, cfg.vocab_size, (B, 1)).astype(np.int32)
    jlog, jc = jax.jit(lambda *a: JM.decode_step_paged(
        jcfg, *a, use_pallas))(jparams, jc, jnp.asarray(tok),
                               jnp.asarray(pos), jnp.asarray(tables))
    log, c = M.decode_step_paged(cfg, params, c, torch.from_numpy(tok),
                                 torch.from_numpy(pos),
                                 torch.from_numpy(tables), use_pallas)
    np.testing.assert_allclose(log.numpy(), np.asarray(jlog), **TOL)

    toks = rng.integers(0, cfg.vocab_size, (B, 4)).astype(np.int32)
    valid = np.array([4, 2, 4], np.int32)
    jlog, jc = jax.jit(lambda *a: JM.extend_paged(jcfg, *a, use_pallas))(
        jparams, jc, jnp.asarray(toks), jnp.asarray(pos + 1),
        jnp.asarray(tables), jnp.asarray(valid))
    log, c = M.extend_paged(cfg, params, c, torch.from_numpy(toks),
                            torch.from_numpy(pos + 1),
                            torch.from_numpy(tables),
                            torch.from_numpy(valid), use_pallas)
    for b in range(B):
        np.testing.assert_allclose(log[b, :valid[b]].numpy(),
                                   np.asarray(jlog)[b, :valid[b]], **TOL)
    _close(c, jc)


def test_int8_extend_plan_fits_the_served_catch_chunk():
    """The card's int8 catch-up waves at gemma3-1b's global shape (4 slots,
    4 query heads over 1 kv head, hd 256, 128 pages of 16, bf16 queries)
    and ``chip_smoke.py``'s 16-token chunk: the extend read plans a
    tensor-core launch within a block's shared memory (a block holds one
    tile of at most 64 query rows, so any chunk width fits)."""
    plan = pa.paged_plan(4, 1, 4, 16, 128, 16, 256, torch.int8,
                         torch.bfloat16, 132, suffix=True)
    assert plan.mma and plan.smem <= checks.SMEM_LIMIT


def test_paged_cache_axes_carry_the_ring_rows(deep):
    """The engine's batch axes: super-block rings at axis 2, ``rem_local``
    rings at axis 1, pool leaves -1; a slot's rows survive an
    extract / insert round trip (preemption and resumption)."""
    _, _, cfg, _ = deep
    axes = paged_cache_axes(cfg, MAX_LEN, NB, BS, kv_dtype="int8")
    assert axes == {
        "super": {"local": dict(k=2, v=2, slots=2),
                  "global": dict(k=-1, v=-1, k_scale=-1, v_scale=-1)},
        "rem_local": dict(k=1, v=1, slots=1)}
    c = M.init_paged_cache(cfg, B, MAX_LEN, NB, BS, kv_dtype="int8",
                           device="cpu")
    gen = torch.Generator().manual_seed(0)
    rings = (c["super"]["local"], c["rem_local"])
    for part in rings:
        part["k"].normal_(generator=gen)
        part["slots"].random_(0, 50, generator=gen)
    want = extract_slot(c, 1, axes)
    for part in rings:
        for leaf in part.values():
            leaf.zero_()
    insert_slot(c, want, 1, axes)
    got = extract_slot(c, 1, axes)
    for part in ("super", "rem_local"):
        ring = (lambda t: t["local"]) if part == "super" else (lambda t: t)
        for key in ("k", "v", "slots"):
            assert torch.equal(ring(got[part])[key], ring(want[part])[key])
    assert int(c["rem_local"]["slots"][:, 0].abs().sum()) == 0


# ---------------------------------------------------------------------------
# the engine against the JAX engine
# ---------------------------------------------------------------------------

def _prompts(vocab):
    """``test_engine_matrix._traffic``'s prompts, made the same way."""
    rng = np.random.default_rng(42)
    sys_a = rng.integers(0, vocab, 21, dtype=np.int32)
    sys_b = rng.integers(0, vocab, 16, dtype=np.int32)
    return [
        np.concatenate([sys_a, rng.integers(0, vocab, 4, dtype=np.int32)]),
        np.concatenate([sys_a, rng.integers(0, vocab, 7, dtype=np.int32)]),
        np.concatenate([sys_b, rng.integers(0, vocab, 3, dtype=np.int32)]),
        np.concatenate([sys_b, rng.integers(0, vocab, 9, dtype=np.int32)]),
        rng.integers(0, vocab, 5, dtype=np.int32),
        rng.integers(0, vocab, 32, dtype=np.int32),
        rng.integers(0, vocab, 47, dtype=np.int32),
    ]


def _traffic(request_cls, vocab):
    return [request_cls(uid=uid, prompt=p, max_new_tokens=6,
                        priority=uid % 3, deadline=float(uid))
            for uid, p in enumerate(_prompts(vocab))]


def _drain(eng, reqs):
    for r in reqs:
        eng.submit(r)
    eng.run_until_drained()
    return {r.uid: tuple(r.generated) for r in eng.completed}


def _engines(models, kw):
    jcfg, jparams, cfg, params = models
    jeng = JaxEngine(jcfg, jparams, JaxServeConfig(**kw))
    jtok = _drain(jeng, _traffic(JaxRequest, jcfg.vocab_size))
    eng = EdgeServingEngine(cfg, params, ServeConfig(**kw), device="cpu")
    tok = _drain(eng, _traffic(Request, cfg.vocab_size))
    return jeng, jtok, eng, tok


@pytest.fixture(scope="module")
def fifo(models):
    return _engines(models, dict(BASE, **CASES["fifo"]))


@pytest.fixture(scope="module", params=list(CASES))
def replay(request, models):
    """(case, JAX engine, JAX tokens, port engine, port tokens)."""
    if request.param == "fifo":
        return ("fifo", *request.getfixturevalue("fifo"))
    return (request.param,
            *_engines(models, dict(BASE, **CASES[request.param])))


def test_gemma_greedy_tokens_match_jax_engine(replay):
    case, _, jtok, _, tok = replay
    assert len(tok) == 7
    assert tok == jtok, f"token drift vs the JAX paged engine ({case})"


def test_gemma_stats_match_jax_engine(replay):
    case, jeng, _, eng, _ = replay
    assert eng.stats() == jeng.stats(), case
    assert eng.extend_ok and eng.extend_waves >= 1, case
    if case == "tight_pool":
        assert eng.stats()["exhaust_preempts"] > 0
    if case == "chunked":
        assert eng.stats()["wave_admitted"] >= 1


def test_gemma_pool_consistent_and_no_leak(replay):
    _, _, _, eng, _ = replay
    eng.pool.assert_consistent()
    assert eng.pool.num_free == eng.pool.num_blocks
    assert not eng.active.any() and not eng.queue
    assert (eng.block_tables == -1).all()
    assert eng.decode_waves + eng.extend_waves == eng.steps


def test_extend_gate_needs_the_chunk_within_the_window(models, fifo):
    """A catch-up chunk of W + 1 cannot extend a W-entry ring with
    pre-write semantics: ``extend_ok`` is False on both engines (True at
    W), the long prompts catch up one token a decode wave, and the
    tokens stay the JAX fifo engine's."""
    jcfg, jparams, cfg, params = models
    W = min(cfg.local_window, BASE["max_len"])
    for chunk, ok in ((W, True), (W + 1, False)):
        kw = dict(BASE, policy="fifo", catch_chunk=chunk)
        eng = EdgeServingEngine(cfg, params, ServeConfig(**kw), device="cpu")
        assert eng.extend_ok is ok
        assert JaxEngine(jcfg, jparams, JaxServeConfig(**kw)).extend_ok is ok
    assert _drain(eng, _traffic(Request, cfg.vocab_size)) == fifo[1]
    assert eng.extend_waves == 0 and eng.decode_waves == eng.steps


def test_gemma_cancel_mid_catch_up_and_decode_leaks_nothing(models):
    _, _, cfg, params = models
    eng = EdgeServingEngine(cfg, params, ServeConfig(**BASE, policy="fifo"),
                            device="cpu")
    for r in _traffic(Request, cfg.vocab_size):
        eng.submit(r)
    eng.drain_step()
    live = [eng.slot_req[s].uid for s in range(3) if eng.active[s]]
    assert eng.cancel(live[0]) and eng.cancel(live[-1])
    eng.run_until_drained()
    assert len(eng.completed) == 5 and len(eng.cancelled) == 2
    assert all(len(r.generated) == 6 for r in eng.completed)
    eng.pool.assert_consistent()
    assert eng.pool.num_free == eng.pool.num_blocks


def _reference_decode(cfg, params, prompt, max_new, max_len):
    """Single-request greedy decode through the port's model API:
    unpadded prefill, then one ``decode_step`` a token."""
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


def test_padded_admission_matches_reference():
    """``test_decode_consistency.test_padded_admission_matches_reference``
    for gemma3-1b on the port, on its smoke config and the JAX test's
    weights: prompts of 5, 17 and 33 tokens (buckets 8/16, so two catch
    up past the window) decode token for token like the sequential
    prefill + decode reference."""
    jcfg = jax_smoke_config(ARCH)
    _, params = _bridge(jcfg, 0)
    cfg = get_smoke_config(ARCH)
    eng = EdgeServingEngine(cfg, params, ServeConfig(
        max_slots=3, max_len=96, prefill_buckets=(8, 16),
        prefix_cache=False), device="cpu")
    rng = np.random.default_rng(0)
    reqs = [Request(uid=uid, prompt=rng.integers(0, cfg.vocab_size, n,
                                                 dtype=np.int32),
                    max_new_tokens=6)
            for uid, n in enumerate([5, 17, 33])]
    for r in reqs:
        eng.submit(r)
    eng.run_until_drained()
    for r in reqs:
        ref = _reference_decode(cfg, params, r.prompt, 6, 96)
        assert list(r.generated) == ref, (len(r.prompt), r.generated, ref)


# ---------------------------------------------------------------------------
# the serve CLI
# ---------------------------------------------------------------------------

def test_cli_defaults_to_gemma():
    assert serve.parse_args([]).arch == ARCH


def test_cli_params_restores_a_checkpoint(tmp_path, capsys):
    """``--params`` serves the checkpoint's weights: the same tokens as an
    engine given the same params in memory (not the seeded ones)."""
    cfg = get_smoke_config(ARCH)
    params = M.init_params(cfg, torch.Generator().manual_seed(11), "cpu")
    path = str(tmp_path / "gemma")
    ckpt.save(path, params)
    kw = dict(max_slots=2, max_len=64, policy="fifo")
    _, eng = serve.build_engine(ARCH, "smoke", kw, "cpu", params_path=path)
    _, seeded = serve.build_engine(ARCH, "smoke", kw, "cpu")
    mem = EdgeServingEngine(cfg, params, ServeConfig(prefix_cache=False,
                                                     **kw), device="cpu")
    toks = {}
    for name, e in (("restored", eng), ("memory", mem), ("seeded", seeded)):
        toks[name] = _drain(e, serve.make_requests(cfg, 3, 4, 30, 5, "fifo"))
    assert toks["restored"] == toks["memory"] != toks["seeded"]
    serve.main(["--device", "cpu", "--params", path, "--requests", "2",
                "--max-new", "3"])
    out = capsys.readouterr().out.strip().splitlines()[0]
    assert '"requests": 2' in out and '"tokens": 6' in out
