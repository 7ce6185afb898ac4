"""The port's radix prefix cache (``repro_torch.serving.prefix_cache``)
and its engine integration, against the JAX package.

* The host-only cases of ``tests/test_prefix_cache.py`` run on the port's
  and JAX's ``KVBlockPool`` / ``RadixPrefixCache`` over the same
  operation sequences; every call's return value and every cache's final
  ``stats()`` are recorded on both sides and must be equal.  The oracle
  fuzz of ``tests/test_prefix_cache_property.py`` runs on the port's
  classes with its own settings.
* ``prefill_paged`` with a radix hit (context pages, a mid-page start)
  against JAX's, on a float and an int8 pool.
* On the phi3 smoke config at float32 (JAX weights bridged in): the
  port's prefix engine gives the JAX prefix engine's tokens and
  ``stats()`` on ``tests/test_engine_matrix.py``'s traffic, and hit
  tokens equal a cold engine's for page-aligned, mid-page and in-flight
  hits, the copy-on-write guard, preemption of shared pages, eviction
  under pressure and a speculating writer's rollback.
* ``ServeConfig()`` constructs and serves every ported family, the cache
  armed only where ``model.prefix_sharable``.
* Persistence: restart-warm hits, rejected stores (corrupt, another
  config, other weights, another page layout, a store of the JAX
  engine), an overlapping store, ``close()``'s dedup, spilled chains,
  and a bfloat16 pool's pages back bit for bit.
* ``benchmarks/serving_throughput.py``'s shared-prefix leg replayed on
  the port gives ``benchmarks/serving_baseline.json``'s counters.
"""
import json
import os
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.serving.kv_pool as jax_kv_pool
import repro.serving.prefix_cache as jax_prefix_cache
from repro.configs import get_smoke_config as jax_smoke_config
from repro.models import model as JM
from repro.serving import EdgeServingEngine as JaxEngine
from repro.serving import Request as JaxRequest
from repro.serving import ServeConfig as JaxServeConfig
from repro_torch.bridge import params_from_numpy
from repro_torch.configs import get_smoke_config
from repro_torch.models import model as M
from repro_torch.serving import EdgeServingEngine, Request, ServeConfig
from repro_torch.serving import kv_pool, prefix_cache
from repro_torch.serving.prefix_cache import load_store, save_store

from tests import test_prefix_cache as jax_cases
from tests import test_prefix_cache_property as jax_property

ARCH = "phi3-medium-14b"
MATRIX = dict(max_slots=3, max_len=96, prefill_buckets=(8, 16, 32), seed=3)


# ---------------------------------------------------------------------------
# host-only: the radix index side by side
# ---------------------------------------------------------------------------

HOST_CASES = [
    "test_insert_then_match_shares_pages",
    "test_match_is_token_granular",
    "test_min_match_tokens_admission_floor",
    "test_partial_tail_is_indexed_and_upgraded",
    "test_mid_page_divergent_insert_is_refused",
    "test_insert_duplicate_chain_is_deduped",
    "test_insert_extension_adopts_only_the_tail",
    "test_insert_divergent_chain_splits_edge",
    "test_unrecord_hit_rolls_back_retry_stats",
    "test_namespaces_do_not_cross_match",
    "test_evict_lru_skips_pinned_chains",
]
_POOL_CALLS = ("alloc", "free", "incref", "share", "fork", "refcount")
_CACHE_CALLS = ("match", "insert", "evict", "evictable_blocks",
                "unrecord_hit", "stats")


def _plain(x):
    if isinstance(x, (list, tuple)):
        return [_plain(v) for v in x]
    if isinstance(x, np.integer):
        return int(x)
    return x


def _recorded(cls, names, log, made):
    """A subclass of ``cls`` that appends ``(name, return value)`` of
    every call of ``names`` to ``log`` and its instances to ``made``."""
    def wrap(name):
        def method(self, *a, **k):
            out = getattr(super(rec, self), name)(*a, **k)
            log.append((name, _plain(out)))
            return out
        return method

    def init(self, *a, **k):
        super(rec, self).__init__(*a, **k)
        made.append(self)
    rec = type(f"Recorded{cls.__name__}", (cls,),
               {"__init__": init, **{n: wrap(n) for n in names}})
    return rec


def _replay(case, pool_cls, cache_cls, monkeypatch):
    """Run ``tests/test_prefix_cache.py``'s ``case`` (its own assertions
    included) on the given classes; return every recorded call and each
    cache's final stats."""
    log, made = [], []
    monkeypatch.setattr(jax_cases, "KVBlockPool",
                        _recorded(pool_cls, _POOL_CALLS, log, made))
    monkeypatch.setattr(jax_cases, "RadixPrefixCache",
                        _recorded(cache_cls, _CACHE_CALLS, log, made))
    getattr(jax_cases, case)()
    return log, [m.stats() for m in made if hasattr(m, "stats")]


@pytest.mark.parametrize("case", HOST_CASES)
def test_radix_index_matches_jax_call_for_call(case, monkeypatch):
    theirs = _replay(case, jax_kv_pool.KVBlockPool,
                     jax_prefix_cache.RadixPrefixCache, monkeypatch)
    mine = _replay(case, kv_pool.KVBlockPool, prefix_cache.RadixPrefixCache,
                   monkeypatch)
    assert mine == theirs
    assert len(mine[0]) > 3 and mine[1]


def test_radix_cache_matches_oracle_on_the_port(monkeypatch):
    """``tests/test_prefix_cache_property.py``'s fuzz (``max_examples=12``,
    its oracle, pool invariant after every operation, zero leaked pages)
    on the port's pool and cache."""
    monkeypatch.setattr(jax_property, "KVBlockPool", kv_pool.KVBlockPool)
    monkeypatch.setattr(jax_property, "RadixPrefixCache",
                        prefix_cache.RadixPrefixCache)
    jax_property.test_radix_cache_matches_oracle()


# ---------------------------------------------------------------------------
# model level: the radix-hit prefill
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def models():
    jcfg = jax_smoke_config(ARCH).replace(dtype="float32")
    jparams = jax.jit(lambda key: JM.init_params(jcfg, key))(
        jax.random.PRNGKey(0))
    cfg = get_smoke_config(ARCH).replace(dtype="float32")
    return jcfg, jparams, cfg, params_from_numpy(
        jax.tree.map(np.asarray, jparams), device="cpu")


@pytest.mark.parametrize("kv_dtype", [None, "int8"])
def test_hit_prefill_matches_jax(models, kv_dtype):
    """Two rows prefilled cold (true lengths 13 and 8 of a 16 bucket),
    then their suffixes (6 and 4 tokens) prefilled as hits at ctx_len 13
    (mid-page) and 8 (page-aligned) through full tables: logits and
    every page, float and int8 pools."""
    jcfg, jparams, cfg, params = models
    NB, BS, MAX_LEN = 12, 8, 64
    rng = np.random.default_rng(9)
    prompt = rng.integers(0, cfg.vocab_size, (2, 16)).astype(np.int32)
    suffix = rng.integers(0, cfg.vocab_size, (2, 6)).astype(np.int32)
    ctx = np.array([13, 8], np.int32)
    cold_tables = np.array([[3, 7], [5, 0]], np.int32)
    full = np.array([[3, 7, 9, -1], [5, 2, -1, -1]], np.int32)
    args = [
        (prompt, dict(write_tables=cold_tables, true_len=ctx)),
        (suffix, dict(write_tables=full, ctx_tables=full, ctx_len=ctx,
                      true_len=np.array([6, 4], np.int32)))]
    jc = JM.init_paged_cache(jcfg, 2, MAX_LEN, NB, BS, kv_dtype=kv_dtype)
    c = M.init_paged_cache(cfg, 2, MAX_LEN, NB, BS, kv_dtype=kv_dtype,
                           device="cpu")
    slots = np.array([0, 1], np.int32)
    for toks, kw in args:
        jlog, jc = jax.jit(lambda p_, t_, c_, kw_: JM.prefill_paged(
            jcfg, p_, {"tokens": t_}, MAX_LEN, c_, slots=slots, **kw_))(
                jparams, jnp.asarray(toks), jc,
                {k: jnp.asarray(v) for k, v in kw.items()})
        log, c = M.prefill_paged(
            cfg, params, {"tokens": torch.from_numpy(toks)}, MAX_LEN, c,
            slots=torch.from_numpy(slots),
            **{k: torch.from_numpy(v) for k, v in kw.items()})
        b = np.asarray(jlog)
        np.testing.assert_allclose(log.numpy(), b, rtol=1e-5,
                                   atol=1e-5 * np.abs(b).max())
    for key, leaf in c["layers"].items():
        a, b = leaf.numpy(), np.asarray(jc["layers"][key])
        if a.dtype == np.int8:
            # float noise between the frameworks may move a value across
            # a rounding boundary: one level, in a handful of bytes
            d = np.abs(a.astype(np.int32) - b.astype(np.int32))
            assert d.max() <= 1 and (d > 0).mean() <= 1e-3, key
        else:
            np.testing.assert_allclose(a, b, rtol=1e-5,
                                       atol=1e-5 * np.abs(b).max())


# ---------------------------------------------------------------------------
# engine: against the JAX prefix engine, and hit == cold
# ---------------------------------------------------------------------------

def _matrix_traffic(request_cls, vocab):
    """``test_engine_matrix._traffic``: two shared-prefix families (one
    ending mid-page), a bucket-aligned prompt, a long catch-up prompt."""
    rng = np.random.default_rng(42)
    sys_a = rng.integers(0, vocab, 21, dtype=np.int32)
    sys_b = rng.integers(0, vocab, 16, dtype=np.int32)
    prompts = [
        np.concatenate([sys_a, rng.integers(0, vocab, 4, dtype=np.int32)]),
        np.concatenate([sys_a, rng.integers(0, vocab, 7, dtype=np.int32)]),
        np.concatenate([sys_b, rng.integers(0, vocab, 3, dtype=np.int32)]),
        np.concatenate([sys_b, rng.integers(0, vocab, 9, dtype=np.int32)]),
        rng.integers(0, vocab, 5, dtype=np.int32),
        rng.integers(0, vocab, 32, dtype=np.int32),
        rng.integers(0, vocab, 47, dtype=np.int32),
    ]
    return [request_cls(uid=uid, prompt=p, max_new_tokens=6,
                        priority=uid % 3, deadline=float(uid))
            for uid, p in enumerate(prompts)]


def _drain(eng, reqs):
    for r in reqs:
        eng.submit(r)
    eng.run_until_drained()
    return {r.uid: tuple(r.generated) for r in eng.completed}


def _no_leak(eng):
    eng.pool.assert_consistent()
    cached = eng.prefix_cache.num_blocks if eng.prefix_cache else 0
    assert eng.pool.num_free + cached == eng.pool.num_blocks


def test_prefix_engine_matches_jax_prefix_engine(models):
    """``ServeConfig``'s defaults (prefix cache on, priority) on the
    matrix's traffic: tokens and every ``stats()`` key — the prefix
    cache's ``prefix_*`` counters and ``published_frontiers`` among
    them — equal the JAX engine's."""
    jcfg, jparams, cfg, params = models
    jeng = JaxEngine(jcfg, jparams, JaxServeConfig(**MATRIX))
    jtok = _drain(jeng, _matrix_traffic(JaxRequest, jcfg.vocab_size))
    eng = EdgeServingEngine(cfg, params, ServeConfig(**MATRIX), device="cpu")
    tok = _drain(eng, _matrix_traffic(Request, cfg.vocab_size))
    assert eng.sharable and tok == jtok
    st = eng.stats()
    assert st == jeng.stats()
    assert st["prefix_hits"] >= 2 and st["published_frontiers"] >= 1
    assert st["prefix_hit_tokens"] > st["prefix_hit_tokens_block"]
    _no_leak(eng)


def _sequential(cfg, params, reqs, prefix, **kw):
    eng = EdgeServingEngine(cfg, params, ServeConfig(**dict(
        dict(max_slots=2, max_len=96, prefill_buckets=(16, 32), seed=5,
             prefix_cache=prefix), **kw)), device="cpu")
    for r in reqs:
        eng.submit(r)
        eng.run_until_drained()
    return eng, {r.uid: tuple(r.generated) for r in eng.completed}


def _shared(cfg, sys_len, n=4):
    """n requests on one system prompt with their own tails, greedy and
    sampled (temperature 0.8, top-k 6) in turn."""
    sys_prompt = np.random.default_rng(7).integers(0, cfg.vocab_size,
                                                   sys_len, dtype=np.int32)
    return [Request(uid=uid, prompt=np.concatenate([
        sys_prompt, np.random.default_rng(50 + uid).integers(
            0, cfg.vocab_size, 4 + uid, dtype=np.int32)]),
        max_new_tokens=5, temperature=0.8 if uid % 2 else 0.0,
        top_k=6 if uid % 2 else 0) for uid in range(n)]


@pytest.mark.parametrize("sys_len", [16, 21])
def test_hit_tokens_equal_cold(models, sys_len):
    """A page-aligned (16) and a mid-page (21) shared prefix: every later
    request hits and decodes what a cache-off engine decodes, greedy and
    sampled; the mid-page hits fork their partial page and beat the
    block-granular count."""
    _, _, cfg, params = models
    _, cold = _sequential(cfg, params, _shared(cfg, sys_len), False)
    eng, hot = _sequential(cfg, params, _shared(cfg, sys_len), True)
    assert hot == cold
    st = eng.prefix_cache.stats()
    assert st["hits"] >= 3, st
    if sys_len % 16:
        assert st["hit_tokens"] > st["hit_tokens_block"]
        assert eng.cow_forks >= 1
    else:
        assert st["hit_tokens"] == st["hit_tokens_block"]
    _no_leak(eng)


def test_in_flight_hit_equals_cold(models):
    """A reader admitted while the writer still decodes hits the
    writer's published frontier; both decode what each decodes alone on
    a cache-off engine."""
    _, _, cfg, params = models
    sys_prompt = np.random.default_rng(17).integers(0, cfg.vocab_size, 24,
                                                    dtype=np.int32)

    def pair():
        return (Request(uid=0, prompt=sys_prompt.copy(), max_new_tokens=16),
                Request(uid=1, prompt=np.concatenate(
                    [sys_prompt, np.asarray([3, 1, 4, 1, 5], np.int32)]),
                    max_new_tokens=5))
    eng = EdgeServingEngine(cfg, params, ServeConfig(
        max_slots=2, max_len=96, prefill_buckets=(16, 32), seed=5),
        device="cpu")
    writer, reader = pair()
    eng.submit(writer)
    for _ in range(3):
        eng.drain_step()
    assert eng.published_frontiers >= 1
    eng.submit(reader)
    eng.drain_step()
    assert eng.prefix_cache.hits >= 1 and not writer.done
    eng.run_until_drained()
    _no_leak(eng)
    for req, got in zip(pair(), (writer, reader)):
        _, cold = _sequential(cfg, params, [req], False)
        assert cold[req.uid] == tuple(got.generated)


def test_cow_guard_forks_a_shared_write_page(models):
    """A second owner of the page a slot is about to write makes the
    engine fork it before the wave: tokens unchanged, refcounts
    balanced."""
    _, _, cfg, params = models
    prompt = np.random.default_rng(4).integers(0, cfg.vocab_size, 6,
                                               dtype=np.int32)

    def run(poke):
        eng = EdgeServingEngine(cfg, params, ServeConfig(
            max_slots=1, max_len=64, prefill_buckets=(8,), seed=1),
            device="cpu")
        eng.submit(Request(uid=0, prompt=prompt.copy(), max_new_tokens=6))
        eng.step()
        stolen = None
        if poke:
            stolen = eng.slot_blocks[0][int(eng.pos[0]) // eng.block_size]
            eng.pool.share([stolen])        # a simulated second owner
        eng.run_until_drained()
        if poke:
            assert eng.cow_forks >= 1 and eng.stats()["cow_forks"] >= 1
            assert eng.pool.refcount(stolen) == 1
            eng.pool.free([stolen])
        _no_leak(eng)
        return tuple(eng.completed[0].generated)

    assert run(True) == run(False)


def test_preempt_with_shared_pages_resumes_exactly(models):
    """A sampled request whose prefix pages are shared with the cache is
    preempted mid-decode and resumed: its tokens equal an uninterrupted
    cache-on run's and a cache-off run's, and no page leaks."""
    _, _, cfg, params = models
    rng = np.random.default_rng(11)
    sys_prompt = rng.integers(0, cfg.vocab_size, 16, dtype=np.int32)
    tail = rng.integers(0, cfg.vocab_size, 5, dtype=np.int32)

    def fresh():
        return Request(uid=1, prompt=np.concatenate([sys_prompt, tail]),
                       max_new_tokens=8, temperature=0.9, top_k=8)

    def engine(prefix):
        eng = EdgeServingEngine(cfg, params, ServeConfig(
            max_slots=1, max_len=96, prefill_buckets=(8, 32), seed=9,
            prefix_cache=prefix), device="cpu")
        _drain(eng, [Request(uid=0, prompt=sys_prompt.copy(),
                             max_new_tokens=2)])
        return eng

    outs = []
    for prefix in (True, False):
        eng = engine(prefix)
        outs.append(_drain(eng, [fresh()])[1])
    assert outs[0] == outs[1]
    eng = engine(True)
    req = fresh()
    eng.submit(req)
    eng.step()
    eng.step()
    assert not req.done and req.generated
    assert any(eng.pool.refcount(b) > 1 for b in eng.slot_blocks[0])
    got = eng.preempt(0)
    eng.pool.assert_consistent()
    eng.submit(got)
    eng.run_until_drained()
    assert tuple(got.generated) == outs[0]
    _no_leak(eng)


def test_eviction_under_pressure_keeps_tokens(models):
    """An 8-page pool below the traffic's chains: admission and page
    growth evict LRU chains, the pool invariant holds after every step,
    and the tokens are the cache-off engine's."""
    _, _, cfg, params = models
    rng = np.random.default_rng(2)
    prompts = [rng.integers(0, cfg.vocab_size, 20 + 3 * i, dtype=np.int32)
               for i in range(6)]

    def run(prefix):
        eng = EdgeServingEngine(cfg, params, ServeConfig(
            max_slots=2, max_len=64, prefill_buckets=(8, 16, 32),
            kv_block_size=16, kv_pool_blocks=8, seed=0,
            prefix_cache=prefix), device="cpu")
        for uid, p in enumerate(prompts):
            eng.submit(Request(uid=uid, prompt=p.copy(), max_new_tokens=6))
        while eng.queue or eng.active.any():
            eng.drain_step()
            eng.pool.assert_consistent()
        return eng, {r.uid: tuple(r.generated) for r in eng.completed}

    eng, hot = run(True)
    assert len(hot) == 6 and hot == run(False)[1]
    assert eng.prefix_cache.evicted_blocks > 0
    _no_leak(eng)


def test_published_pages_survive_writer_rollback(models):
    """A speculating writer rolls back (tail pages freed) strictly above
    its published frontier while a reader shares the pages below it:
    greedy tokens equal the vanilla engine's for both."""
    _, _, cfg, params = models
    sys_prompt = np.random.default_rng(23).integers(0, cfg.vocab_size, 24,
                                                    dtype=np.int32)

    def run(spec):
        eng = EdgeServingEngine(cfg, params, ServeConfig(
            max_slots=2, max_len=96, prefill_buckets=(16, 32), seed=5,
            spec_decode=spec, draft_arch="self"), device="cpu")
        eng.submit(Request(uid=0, prompt=sys_prompt.copy(),
                           max_new_tokens=14))
        for _ in range(2):
            eng.drain_step()
        eng.submit(Request(uid=1, prompt=np.concatenate(
            [sys_prompt, np.asarray([2, 7, 1, 8], np.int32)]),
            max_new_tokens=5))
        eng.run_until_drained()
        _no_leak(eng)
        if spec:
            assert eng.spec_rounds >= 1 and eng.prefix_cache.hits >= 1
        return {r.uid: tuple(r.generated) for r in eng.completed}

    assert run(True) == run(False)


@pytest.mark.parametrize("arch", ["phi3-medium-14b", "gemma3-1b",
                                  "mamba2-370m", "zamba2-7b",
                                  "granite-moe-1b-a400m", "kimi-k2-1t-a32b",
                                  "internvl2-76b", "whisper-base"])
def test_serve_config_defaults_serve_every_family(arch):
    """``ServeConfig()`` constructs and serves each ported family (the
    vlm and encdec requests with one image or audio between them); the
    cache is armed exactly where ``model.prefix_sharable``; the tracer's
    fields, ported last, construct too."""
    cfg = get_smoke_config(arch)
    params = M.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    scfg = ServeConfig()
    assert scfg.prefix_cache and scfg.paged
    eng = EdgeServingEngine(cfg, params, scfg, device="cpu")
    assert eng.sharable == M.prefix_sharable(cfg)
    assert (eng.prefix_cache is not None) == M.prefix_sharable(cfg)
    rng = np.random.default_rng(0)
    sys_prompt = rng.integers(0, cfg.vocab_size, 20, dtype=np.int32)
    extras = {}
    if cfg.family == "vlm":
        extras["image_embeds"] = rng.normal(
            0, 0.1, (cfg.num_image_tokens, cfg.image_embed_dim)
        ).astype(np.float32)
    if cfg.family == "encdec":
        extras["audio_embeds"] = rng.normal(
            0, 0.1, (cfg.encoder_seq, cfg.d_model)).astype(np.float32)
    reqs = [Request(uid=u, prompt=np.concatenate(
        [sys_prompt, rng.integers(0, cfg.vocab_size, 3, dtype=np.int32)]),
        max_new_tokens=3, extras=dict(extras)) for u in range(2)]
    _drain(eng, reqs[:1])
    assert len(_drain(eng, reqs[1:])) == 2
    st = eng.stats()
    assert ("prefix_hits" in st) == eng.sharable
    if eng.sharable:
        assert st["prefix_hits"] == 1
    for field in ("trace", "trace_clock"):
        scfg = ServeConfig(**{field: True if field == "trace"
                              else (lambda: 0.0)})
        assert getattr(scfg, field) is not None


# ---------------------------------------------------------------------------
# persistence
# ---------------------------------------------------------------------------

def _scfg(persist=None, **kw):
    return ServeConfig(**dict(dict(
        max_slots=2, max_len=96, prefill_buckets=(16, 32), seed=5,
        prefix_persist_path=persist), **kw))


def _three(cfg, n=3):
    sys_prompt = np.random.default_rng(7).integers(0, cfg.vocab_size, 21,
                                                   dtype=np.int32)
    return [Request(uid=uid, prompt=np.concatenate([
        sys_prompt, np.random.default_rng(50 + uid).integers(
            0, cfg.vocab_size, 4 + uid, dtype=np.int32)]),
        max_new_tokens=5) for uid in range(n)]


def _serve(eng, reqs):
    for r in reqs:
        eng.submit(r)
        eng.run_until_drained()
    return {r.uid: tuple(r.generated) for r in reqs}


def _saved(cfg, params, path, **kw):
    eng = EdgeServingEngine(cfg, params, _scfg(path, **kw), device="cpu")
    live = _serve(eng, _three(cfg))
    saved = eng.close()
    assert saved["persist_saved_chains"] >= 1 and os.path.exists(path)
    return eng, live, saved


@pytest.mark.parametrize("kv_dtype", [None, "int8"])
def test_restart_warm_hits_equal_live_hits(models, tmp_path, kv_dtype):
    """close() writes the warm cache; a new engine on the same path reads
    it and serves every request as a hit, with the live run's tokens
    (and, on the float pool, the cold run's)."""
    _, _, cfg, params = models
    path = str(tmp_path / "prefix.npz")
    _, live, saved = _saved(cfg, params, path, quant_kv=kv_dtype)
    eng = EdgeServingEngine(cfg, params, _scfg(path, quant_kv=kv_dtype),
                            device="cpu")
    assert eng.persist_rejected == ""
    assert eng.persist_loaded_blocks == saved["persist_saved_blocks"]
    st = eng.stats()
    assert st["persist_loaded_chains"] == saved["persist_saved_chains"]
    warm = _serve(eng, _three(cfg))
    assert warm == live
    assert eng.prefix_cache.hits >= len(warm)
    _no_leak(eng)
    if kv_dtype is None:
        cold = _serve(EdgeServingEngine(cfg, params, _scfg(
            prefix_cache=False), device="cpu"), _three(cfg))
        assert warm == cold


def test_mismatched_and_corrupt_stores_are_rejected(models, tmp_path):
    """Each store the engine must not trust leaves it cold with the
    reason in ``persist_rejected`` (and ``stats()``), still serving:
    corrupt bytes, another page size, another model config, other
    weights, the other pool layout, and a store the JAX engine wrote for
    the same weights (its fingerprint hashes JAX's dtype names: a store
    is valid for the framework that wrote it)."""
    jcfg, jparams, cfg, params = models
    path = str(tmp_path / "prefix.npz")
    _saved(cfg, params, path)
    bad = str(tmp_path / "bad.npz")
    with open(bad, "wb") as f:
        f.write(b"definitely not a prefix store")
    jax_path = str(tmp_path / "jax.npz")
    jeng = JaxEngine(jcfg, jparams, JaxServeConfig(
        max_slots=2, max_len=96, prefill_buckets=(16, 32), seed=5,
        prefix_persist_path=jax_path))
    jax_prefix_cache.save_store(jax_path, jeng._persist_meta(), [])
    cases = [
        (cfg, params, bad, {}, "unreadable"),
        (cfg, params, path, dict(kv_block_size=8), "block_size"),
        (cfg.replace(num_layers=3), M.init_params(
            cfg.replace(num_layers=3), torch.Generator().manual_seed(0),
            "cpu"), path, {}, "config"),
        (cfg, M.init_params(cfg, torch.Generator().manual_seed(99), "cpu"),
         path, {}, "params"),
        (cfg, params, path, dict(quant_kv="int8"), "quant_kv"),
        (cfg, params, jax_path, {}, "params"),
    ]
    for c, p, store, kw, reason in cases:
        eng = EdgeServingEngine(c, p, _scfg(store, **kw), device="cpu")
        assert eng.persist_loaded_chains == 0, reason
        assert reason in eng.persist_rejected, eng.persist_rejected
        assert eng.stats()["persist_rejected"] == eng.persist_rejected
        assert len(_serve(eng, _three(c, 1))[0]) == 5


def test_overlapping_store_rehydrates_without_aliasing(models, tmp_path):
    """A hand-merged store holding a partial-tail chain, its extension
    and an unrelated chain drives insert's tail replacement while it
    loads; the page freed then is reused by the next chain, whose bytes
    must win: warm hits decode what a cold engine decodes."""
    _, _, cfg, params = models
    vocab = cfg.vocab_size
    rng = np.random.default_rng(31)
    S = rng.integers(0, vocab, 21, dtype=np.int32)
    tail = rng.integers(0, vocab, 5, dtype=np.int32)
    other = rng.integers(0, vocab, 30, dtype=np.int32)
    other[0] = (S[0] + 1) % vocab

    def chains_of(prompt, name):
        path = str(tmp_path / name)
        eng = EdgeServingEngine(cfg, params, _scfg(path), device="cpu")
        _serve(eng, [Request(uid=0, prompt=prompt.copy(), max_new_tokens=1)])
        eng.close()
        return load_store(path, eng._persist_meta()), eng

    cx, eng_ref = chains_of(S, "x.npz")
    cy, _ = chains_of(np.concatenate([S, tail]), "y.npz")
    cz, _ = chains_of(other, "z.npz")
    merged = str(tmp_path / "merged.npz")
    save_store(merged, eng_ref._persist_meta(), cx + cy + cz)
    eng = EdgeServingEngine(cfg, params, _scfg(merged), device="cpu")
    assert eng.persist_rejected == "" and eng.persist_loaded_chains == 3
    for probe in (np.concatenate([S, tail, np.asarray([1, 2, 3], np.int32)]),
                  np.concatenate([other, np.asarray([4], np.int32)])):
        cold = _serve(EdgeServingEngine(cfg, params, _scfg(
            prefix_cache=False), device="cpu"),
            [Request(uid=0, prompt=probe.copy(), max_new_tokens=5)])
        hits = eng.prefix_cache.hits
        warm = _serve(eng, [Request(uid=0, prompt=probe.copy(),
                                    max_new_tokens=5)])
        assert eng.prefix_cache.hits == hits + 1 and warm == cold
    _no_leak(eng)


def test_close_dedups_prefix_and_twin_chains(models, tmp_path):
    """A spilled strict prefix of the resident chain and its exact twin
    are covered by the resident chain: the store holds one chain."""
    _, _, cfg, params = models
    eng = EdgeServingEngine(cfg, params, _scfg(str(tmp_path / "p.npz")),
                            device="cpu")
    S = np.random.default_rng(5).integers(0, cfg.vocab_size, 21,
                                          dtype=np.int32)
    _serve(eng, [Request(uid=0, prompt=S.copy(), max_new_tokens=1)])
    key = eng._key_tokens(Request(uid=9, prompt=S.copy()))[:21]
    pages = eng._chain_pages_host(eng.prefix_cache._leaves()[0][1].blocks)
    eng._spilled.append((0, key[:16].copy(), [p[:, :1] for p in pages]))
    eng._spilled.append((0, key.copy(), pages))
    assert eng.close()["persist_saved_chains"] == 1


def test_pressure_evicted_chains_are_spilled(models, tmp_path):
    """Chains evicted under pool pressure while serving reach the store
    through the host spill, beyond what stays resident."""
    _, _, cfg, params = models
    rng = np.random.default_rng(2)
    eng = EdgeServingEngine(cfg, params, ServeConfig(
        max_slots=2, max_len=64, prefill_buckets=(8, 16, 32),
        kv_block_size=16, kv_pool_blocks=8, seed=0,
        prefix_persist_path=str(tmp_path / "p.npz")), device="cpu")
    for uid in range(6):
        eng.submit(Request(uid=uid, prompt=rng.integers(
            0, cfg.vocab_size, 20 + 3 * uid, dtype=np.int32),
            max_new_tokens=6))
    eng.run_until_drained()
    assert eng.prefix_cache.evicted_blocks > 0 and eng._spilled
    assert eng.stats()["persist_spilled_chains"] == len(eng._spilled)
    saved = eng.close()
    assert saved["persist_saved_blocks"] > eng.prefix_cache.num_blocks


def test_bfloat16_store_round_trips_bit_identical(tmp_path):
    """A bfloat16 pool's pages travel through the store as int16 bits
    (numpy has no bfloat16; the header keeps the name) and come back
    bit for bit; the warm hit decodes the live hit's tokens."""
    cfg = get_smoke_config(ARCH)
    params = M.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    path = str(tmp_path / "bf16.npz")
    eng_a, live, _ = _saved(cfg, params, path)
    assert eng_a.cache["layers"]["k"].dtype == torch.bfloat16
    meta = eng_a._persist_meta()
    assert {sig[1] for sig in meta["leaves"]} == {"bfloat16"}
    chains = load_store(path, meta)
    assert all(pg.dtype == np.int16 for _, _, pages in chains
               for pg in pages)
    eng_b = EdgeServingEngine(cfg, params, _scfg(path), device="cpu")
    for ns, key, _ in chains:
        blocks_a, n = eng_a.prefix_cache.match(key, namespace=ns)
        blocks_b, m = eng_b.prefix_cache.match(key, namespace=ns)
        assert n == m == len(key)
        for pa_, pb_ in zip(eng_a._chain_pages_host(blocks_a),
                            eng_b._chain_pages_host(blocks_b)):
            assert np.array_equal(pa_, pb_)
        eng_a.pool.free(blocks_a)
        eng_b.pool.free(blocks_b)
    assert _serve(eng_b, _three(cfg)) == live


# ---------------------------------------------------------------------------
# the benchmark's shared-prefix leg
# ---------------------------------------------------------------------------

def test_shared_prefix_leg_gives_the_baseline_counters(tmp_path):
    """``serving_throughput._shared_prefix_demo``'s traffic (8 users on a
    45-token system prompt that ends mid-page, 5 common persona tokens,
    3 own tokens, 8 new) and its restart-warm leg on the port: the
    schedule-only counters of ``benchmarks/serving_baseline.json``."""
    base = json.loads((pathlib.Path(__file__).resolve().parents[1]
                       / "benchmarks" / "serving_baseline.json").read_text())
    cfg = get_smoke_config(ARCH)
    params = M.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    rng = np.random.default_rng(0)
    sys_warm = rng.integers(0, cfg.vocab_size, 45, dtype=np.int32)
    sys_meas = rng.integers(0, cfg.vocab_size, 45, dtype=np.int32)
    tail_common = rng.integers(0, cfg.vocab_size, 5, dtype=np.int32)

    def user(uid, sys_prompt):
        tail = np.random.default_rng(1000 + uid).integers(
            0, cfg.vocab_size, 3, dtype=np.int32)
        return Request(uid=uid, prompt=np.concatenate(
            [sys_prompt, tail_common, tail]), max_new_tokens=8)

    store = str(tmp_path / "store.npz")
    scfg = ServeConfig(max_slots=4, max_len=192, prefill_buckets=(16, 32, 64),
                       prefix_cache=True, prefix_persist_path=store)
    eng = EdgeServingEngine(cfg, params, scfg, device="cpu")
    _serve(eng, [user(900, sys_warm), user(901, sys_warm)])
    pc = eng.prefix_cache
    before = (pc.hits, pc.misses, pc.hit_blocks, pc.hit_tokens,
              pc.hit_tokens_block, sum(len(r.generated)
                                       for r in eng.completed))
    hit_users = [user(uid, sys_meas) for uid in range(1, 8)]
    _serve(eng, [user(0, sys_meas)] + hit_users)
    after = (pc.hits, pc.misses, pc.hit_blocks, pc.hit_tokens,
             pc.hit_tokens_block, sum(len(r.generated)
                                      for r in eng.completed))
    got = dict(zip(("shared_hits", "shared_misses", "shared_hit_blocks",
                    "shared_hit_tokens", "shared_hit_tokens_block",
                    "shared_tokens"),
                   (a - b for a, b in zip(after, before))))
    _no_leak(eng)
    saved = eng.close()
    warm_eng = EdgeServingEngine(cfg, params, scfg, device="cpu")
    assert warm_eng.persist_rejected == ""
    _serve(warm_eng, [user(902, sys_warm)])
    wh0 = warm_eng.prefix_cache.hits
    replay = user(1, sys_meas)
    _serve(warm_eng, [replay])
    _no_leak(warm_eng)
    got.update(
        persist_chains=saved["persist_saved_chains"],
        persist_blocks=saved["persist_saved_blocks"],
        persist_loaded_blocks=warm_eng.persist_loaded_blocks,
        persist_warm_hits=warm_eng.prefix_cache.hits - wh0,
        persist_warm_tokens=len(replay.generated),
        persist_warm_matches=(tuple(replay.generated)
                              == tuple(hit_users[0].generated)))
    assert got == {k: base[k] for k in got}
