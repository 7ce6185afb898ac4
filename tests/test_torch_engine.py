"""The port's serving engine against the JAX paged engine.

The traffic of ``tests/test_engine_matrix.py`` (shared-prefix families,
a bucket-aligned prompt, a prompt past the largest bucket that catches
up through extend waves) is replayed through both engines on the
phi3 smoke config at float32, with the JAX weights bridged into the
port.  Greedy tokens must be equal token for token (at float32 no
argmax lands on a near-tie), and so must every ``stats()`` counter:
the two engines make the same schedule.  Pool accounting must hold and
no page may leak.  The same holds on an int8 pool (``quant_kv="int8"``)
against the JAX int8 engine, gather and kernel reads alike, and the
capacity leg of ``benchmarks/serving_throughput.py`` replays on the
port to the counters of ``benchmarks/serving_baseline.json``.
"""
import json
import pathlib

import jax
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as jax_smoke_config
from repro.models import model as JM
from repro.serving import EdgeServingEngine as JaxEngine
from repro.serving import Request as JaxRequest
from repro.serving import ServeConfig as JaxServeConfig
from repro_torch.bridge import params_from_numpy
from repro_torch.configs import get_smoke_config
from repro_torch.models import model as M
from repro_torch.serving import EdgeServingEngine, Request, ServeConfig
from repro_torch.serving.engine import _NOT_PORTED

ARCH = "phi3-medium-14b"
BASE = dict(max_slots=3, max_len=96, prefill_buckets=(8, 16, 32), seed=3,
            prefix_cache=False)
CHUNK_WAVE = dict(chunked_prefill=True, catch_chunk=6, wave_tokens=14)
CASES = {
    "fifo": dict(policy="fifo"),
    "priority": dict(policy="priority"),
    "edf": dict(policy="edf"),
    "chunked": dict(policy="fifo", **CHUNK_WAVE),
    # 5 pages of 16 tokens for 3 slots: a decode wave runs out of pages,
    # preempts a slot (pages detached) and later resumes it
    "tight_pool": dict(policy="priority", kv_pool_blocks=5),
}


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


def _traffic(request_cls, vocab, **kw):
    return [request_cls(uid=uid, prompt=p, max_new_tokens=6,
                        priority=uid % 3, deadline=float(uid), **kw)
            for uid, p in enumerate(_prompts(vocab))]


def _drain(eng, reqs):
    for r in reqs:
        eng.submit(r)
    eng.run_until_drained()
    return {r.uid: tuple(r.generated) for r in eng.completed}


@pytest.fixture(scope="module")
def models():
    jcfg = jax_smoke_config(ARCH).replace(dtype="float32")
    jparams = JM.init_params(jcfg, jax.random.PRNGKey(0))
    cfg = get_smoke_config(ARCH).replace(dtype="float32")
    params = params_from_numpy(jax.tree.map(np.asarray, jparams),
                               device="cpu")
    return jcfg, jparams, cfg, params


@pytest.fixture(scope="module", params=list(CASES))
def replay(request, models):
    """(case, JAX engine, JAX tokens, port engine, port tokens)."""
    jcfg, jparams, cfg, params = models
    kw = dict(BASE, **CASES[request.param])
    jeng = JaxEngine(jcfg, jparams, JaxServeConfig(**kw))
    jtok = _drain(jeng, _traffic(JaxRequest, jcfg.vocab_size))
    eng = EdgeServingEngine(cfg, params, ServeConfig(**kw), device="cpu")
    tok = _drain(eng, _traffic(Request, cfg.vocab_size))
    return request.param, jeng, jtok, eng, tok


def test_greedy_tokens_match_jax_engine(replay):
    case, _, jtok, _, tok = replay
    assert len(tok) == 7
    assert tok == jtok, f"token drift vs the JAX paged engine ({case})"


def test_stats_match_jax_engine(replay):
    """Same keys, same values: steps, peaks, preemptions, reclaims,
    mixed waves and pool gauges all agree with the JAX engine."""
    case, jeng, _, eng, _ = replay
    assert eng.stats() == jeng.stats(), case
    if case == "tight_pool":
        assert eng.stats()["exhaust_preempts"] > 0
    if case == "chunked":
        assert eng.stats()["wave_admitted"] >= 1


def test_pool_consistent_and_no_leak(replay):
    _, _, _, eng, _ = replay
    eng.pool.assert_consistent()
    assert eng.pool.num_free == eng.pool.num_blocks
    assert not eng.active.any() and not eng.queue
    assert (eng.block_tables == -1).all()
    assert eng.decode_waves + eng.extend_waves == eng.steps


def test_cancel_in_every_phase_leaks_nothing(models):
    """Cancel a queued request, a slot mid-catch-up and a decoding slot;
    the rest still finish and every page returns to the pool."""
    _, _, cfg, params = models
    eng = EdgeServingEngine(cfg, params, ServeConfig(**BASE, policy="fifo"),
                            device="cpu")
    reqs = _traffic(Request, cfg.vocab_size)
    for r in reqs:
        eng.submit(r)
    eng.drain_step()
    assert eng.cancel(eng.queue[0].uid)
    for _ in range(60):
        eng.drain_step()
        live = [(s, eng.slot_req[s].uid) for s in range(3) if eng.active[s]]
        catching = [u for s, u in live if eng.pending[s] is not None
                    and eng.pending[s].size]
        decoding = [u for _, u in live if u not in catching]
        if catching and decoding:
            break
    else:
        pytest.fail("no wave had a catching and a decoding slot together")
    for uid in (catching[0], decoding[0]):
        assert eng.cancel(uid)
        eng.pool.assert_consistent()
    assert not eng.cancel(10_000)
    eng.run_until_drained()
    assert eng.cancels == len(eng.cancelled) >= 2
    assert all(r.cancelled and r.done for r in eng.cancelled)
    assert len(eng.completed) + len(eng.cancelled) == len(reqs)
    assert eng.pool.num_free == eng.pool.num_blocks


def test_cancel_preempted_request_frees_detached_pages(models):
    _, _, cfg, params = models
    eng = EdgeServingEngine(cfg, params, ServeConfig(**BASE, policy="fifo"),
                            device="cpu")
    for r in _traffic(Request, cfg.vocab_size)[:3]:
        eng.submit(r)
    eng.drain_step()
    slot = int(np.flatnonzero(eng.active)[0])
    req = eng.preempt(slot)
    assert req.saved_state["blocks"]
    eng.queue.append(req)
    assert eng.pool.num_used > 0
    assert eng.cancel(req.uid)
    eng.run_until_drained()
    assert eng.pool.num_free == eng.pool.num_blocks


def test_preempt_resume_is_exact(models):
    """A slot preempted mid-decode and resumed (pages detached, no
    re-prefill) emits the same tokens as an undisturbed run."""
    _, _, cfg, params = models
    kw = dict(BASE, policy="fifo")
    ref = _drain(EdgeServingEngine(cfg, params, ServeConfig(**kw),
                                   device="cpu"),
                 _traffic(Request, cfg.vocab_size))
    eng = EdgeServingEngine(cfg, params, ServeConfig(**kw), device="cpu")
    for r in _traffic(Request, cfg.vocab_size):
        eng.submit(r)
    for _ in range(3):
        eng.drain_step()
    for slot in np.flatnonzero(eng.active):
        eng.queue.append(eng.preempt(int(slot)))
    eng.run_until_drained()
    assert {r.uid: tuple(r.generated) for r in eng.completed} == ref


def test_sampling_is_seeded_and_in_vocab(models):
    _, _, cfg, params = models
    kw = dict(BASE, policy="fifo", temperature=0.9, top_k=7)
    runs = [_drain(EdgeServingEngine(cfg, params, ServeConfig(**kw),
                                     device="cpu"),
                   _traffic(Request, cfg.vocab_size)) for _ in range(2)]
    assert runs[0] == runs[1]
    assert all(0 <= t < cfg.vocab_size and len(v) == 6
               for v in runs[0].values() for t in v)


def test_reset_rng_replays_a_fresh_engines_sampling(models):
    """``reset_rng()`` re-seeds the device generator and the host rng:
    after a warm-up drain, a sampled run draws a fresh engine's tokens."""
    _, _, cfg, params = models
    kw = dict(BASE, policy="fifo", temperature=0.9, top_k=7)
    fresh = _drain(EdgeServingEngine(cfg, params, ServeConfig(**kw),
                                     device="cpu"),
                   _traffic(Request, cfg.vocab_size))
    eng = EdgeServingEngine(cfg, params, ServeConfig(**kw), device="cpu")
    _drain(eng, _traffic(Request, cfg.vocab_size)[:3])
    eng.completed.clear()
    eng.reset_rng()
    assert _drain(eng, _traffic(Request, cfg.vocab_size)) == fresh


def test_default_device_engine_raises_without_cuda(models):
    if torch.cuda.is_available():
        pytest.skip("this host has CUDA: the default device is valid")
    _, _, cfg, params = models
    with pytest.raises(RuntimeError, match="device='cpu'"):
        EdgeServingEngine(cfg, params, ServeConfig(prefix_cache=False))


def test_params_on_another_device_raise(models):
    _, _, cfg, params = models
    with pytest.raises(ValueError, match="params lie on"):
        EdgeServingEngine(cfg, params, ServeConfig(prefix_cache=False),
                          device="meta")


_ON = {"paged": False, "prefix_cache": True, "prefix_persist_path": "x.npz",
       "min_match_tokens": 20, "trace": True, "trace_clock": lambda: 0.0}
# the fields this test has covered since the engine was first ported:
# the tracer's still raise, the others are ported and must work
_FIELDS = ("min_match_tokens", "paged", "prefix_cache",
           "prefix_persist_path", "trace", "trace_clock")


@pytest.mark.parametrize("field", _FIELDS)
def test_unported_serve_config_fields_raise(field, models, tmp_path):
    """A field still in ``_NOT_PORTED`` (the tracer, A.8) raises in
    ``ServeConfig``; a field ported since works on the paged phi3
    engine: ``paged=False`` serves the dense twin, ``prefix_cache`` arms
    the radix cache (a hit on the matrix traffic), ``min_match_tokens``
    turns a match shorter than it into a miss, and
    ``prefix_persist_path`` writes a store on ``close()`` that a new
    engine reads back."""
    if field in _NOT_PORTED:
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            ServeConfig(**{"prefix_cache": False, field: _ON[field]})
        return
    _, _, cfg, params = models
    value = (str(tmp_path / "store.npz") if field == "prefix_persist_path"
             else _ON[field])
    kw = dict(BASE, policy="fifo", **{"prefix_cache": True, field: value})
    eng = EdgeServingEngine(cfg, params, ServeConfig(**kw), device="cpu")
    assert len(_drain(eng, _traffic(Request, cfg.vocab_size))) == 7
    st = eng.stats()
    if field == "paged":
        assert not eng.paged and eng.prefix_cache is None
        return
    assert eng.sharable
    if field == "min_match_tokens":
        # the traffic's one hit is 16 tokens long: below the floor of 20
        assert st["prefix_short_matches"] == 1 and st["prefix_hits"] == 0
        return
    assert st["prefix_hits"] >= 1
    if field == "prefix_persist_path":
        assert eng.close()["persist_saved_chains"] >= 1
        again = EdgeServingEngine(cfg, params, ServeConfig(**kw),
                                  device="cpu")
        assert again.persist_rejected == ""
        assert again.persist_loaded_chains >= 1


def test_serve_config_keeps_every_jax_field_and_default():
    import dataclasses
    ours = {f.name: f.default for f in dataclasses.fields(ServeConfig)}
    theirs = {f.name: f.default for f in dataclasses.fields(JaxServeConfig)}
    assert ours == theirs


# ---------------------------------------------------------------------------
# int8 KV pools
# ---------------------------------------------------------------------------

# every policy, both reads (gather, and the kernels' plain versions) and
# the chunked axis on the card's read, in five replays
QUANT_CASES = {
    "fifo": dict(policy="fifo"),
    "priority": dict(policy="priority"),
    "fifo-kernel": dict(policy="fifo", use_pallas_paged=True),
    "edf-kernel": dict(policy="edf", use_pallas_paged=True),
    "chunked-kernel": dict(policy="fifo", use_pallas_paged=True,
                           **CHUNK_WAVE),
}


@pytest.fixture(scope="module", params=list(QUANT_CASES))
def quant_replay(request, models):
    """(case, JAX int8 engine, JAX tokens, port int8 engine, port tokens);
    with ``use_pallas_paged`` the JAX side reads through its Pallas
    kernels (interpret mode), the port through the kernels' plain
    versions (CPU tensors)."""
    jcfg, jparams, cfg, params = models
    kw = dict(BASE, quant_kv="int8", **QUANT_CASES[request.param])
    jeng = JaxEngine(jcfg, jparams, JaxServeConfig(**kw))
    assert jeng.quant
    jtok = _drain(jeng, _traffic(JaxRequest, jcfg.vocab_size))
    eng = EdgeServingEngine(cfg, params, ServeConfig(**kw), device="cpu")
    tok = _drain(eng, _traffic(Request, cfg.vocab_size))
    return request.param, jeng, jtok, eng, tok


def test_int8_greedy_tokens_match_jax_engine(quant_replay):
    case, _, jtok, _, tok = quant_replay
    assert len(tok) == 7
    assert tok == jtok, f"token drift vs the JAX int8 engine ({case})"


def test_int8_stats_match_jax_engine(quant_replay):
    case, jeng, _, eng, _ = quant_replay
    stats = eng.stats()
    assert stats == jeng.stats(), case
    assert stats["quant_kv"] == "int8" and stats["quant_draft"] is False
    assert stats["quant_page_bytes"] < stats["quant_f32_page_bytes"]


def test_int8_pool_consistent_and_no_leak(quant_replay):
    _, _, _, eng, _ = quant_replay
    layers = eng.cache["layers"]
    assert layers["k"].dtype == torch.int8
    assert layers["k_scale"].shape == layers["k"].shape[:-1]
    eng.pool.assert_consistent()
    assert eng.pool.num_free == eng.pool.num_blocks
    assert (eng.block_tables == -1).all()
    assert eng.decode_waves + eng.extend_waves == eng.steps


def test_int8_preempt_resume_is_exact(models):
    """Scale leaves live in the same pages as the bytes: a slot preempted
    and resumed on an int8 pool emits an undisturbed run's tokens."""
    _, _, cfg, params = models
    kw = dict(BASE, policy="fifo", quant_kv="int8")
    ref = _drain(EdgeServingEngine(cfg, params, ServeConfig(**kw),
                                   device="cpu"),
                 _traffic(Request, cfg.vocab_size))
    eng = EdgeServingEngine(cfg, params, ServeConfig(**kw), device="cpu")
    for r in _traffic(Request, cfg.vocab_size):
        eng.submit(r)
    for _ in range(3):
        eng.drain_step()
    for slot in np.flatnonzero(eng.active):
        eng.queue.append(eng.preempt(int(slot)))
    eng.run_until_drained()
    assert {r.uid: tuple(r.generated) for r in eng.completed} == ref


def _baseline():
    path = (pathlib.Path(__file__).resolve().parents[1] / "benchmarks"
            / "serving_baseline.json")
    return json.loads(path.read_text())


def test_int8_capacity_matches_serving_baseline():
    """``serving_throughput._capacity_demo`` on the port: at a pool
    budget of exactly 12 float32 pages the int8 layout holds 45 pages,
    and 16 requests run 16 at once instead of 6."""
    from repro_torch.serving.kv_pool import page_bytes, \
        pool_blocks_for_budget
    base = _baseline()
    cfg = get_smoke_config(ARCH)
    params = M.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    bs, n = 16, base["capacity_requests"]
    budget = 12 * page_bytes(cfg, bs, None)
    assert budget == base["capacity_budget_bytes"]

    def traffic():
        rng = np.random.default_rng(5)
        return [Request(uid=uid,
                        prompt=rng.integers(0, cfg.vocab_size,
                                            int(rng.integers(18, 30)),
                                            dtype=np.int32),
                        max_new_tokens=8)
                for uid in range(n)]

    got = {}
    for name, kv_dtype in (("f32", None), ("int8", "int8")):
        blocks = pool_blocks_for_budget(cfg, bs, budget, kv_dtype)
        eng = EdgeServingEngine(cfg, params, ServeConfig(
            max_slots=n, max_len=64, prefill_buckets=(16, 32),
            kv_block_size=bs, kv_pool_blocks=blocks, seed=9,
            prefix_cache=False, quant_kv=kv_dtype), device="cpu")
        _drain(eng, traffic())
        eng.pool.assert_consistent()
        assert eng.pool.num_free == eng.pool.num_blocks
        assert len(eng.completed) == n
        got[f"capacity_{name}_blocks"] = blocks
        got[f"capacity_{name}_concurrent"] = eng.peak_active
    assert got == {k: base[k] for k in got}


def test_quant_kv_config_errors(models):
    _, _, cfg, params = models
    with pytest.raises(ValueError, match="quant_kv"):
        EdgeServingEngine(cfg, params, ServeConfig(**BASE, quant_kv="int4"),
                          device="cpu")
    # quant_draft is ported: without spec_decode there is no draft to
    # quantize, which the engine refuses as the JAX engine does
    with pytest.raises(ValueError, match="quant_draft"):
        EdgeServingEngine(cfg, params, ServeConfig(**BASE, quant_kv="int8",
                                                   quant_draft=True),
                          device="cpu")
