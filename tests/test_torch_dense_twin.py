"""The dense ``paged=False`` twin of the port's engine against the JAX
package.

Model level: ``transformer.extend`` / ``model.extend`` and the dense
admission ``prefill_paged(write_tables=None)`` (max_len strips scattered
at the slots, rings for gemma's local layers) against JAX's jitted entry
points on identical inputs, at rtol 1e-5 and atol 1e-5 x max|ref|, on
the phi3 smoke config and on an 8-layer gemma3-1b variant (two
super-blocks and two ``rem_local`` layers), both at float32 with the JAX
weights bridged in.

Engine level: ``tests/test_engine_matrix.py``'s traffic through the
port's dense twin and the JAX dense engine (phi3 fifo and chunked,
gemma3-1b priority): greedy tokens and every ``stats()`` counter equal.
The phi3 fifo run is the anchor the other cases here (and
``tests/test_torch_engine_matrix.py``) compare port engines with:
speculation on the dense twin, preempt / resume, cancel, ``quant_kv``
disarmed, and ``use_pallas_paged`` launching nothing, as in JAX.
"""
import jax
import jax.numpy as jnp
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
from repro_torch.kernels import ops
from repro_torch.models import model as M
from repro_torch.models import transformer as T
from repro_torch.serving import EdgeServingEngine, Request, ServeConfig

BASE = dict(max_slots=3, max_len=96, prefill_buckets=(8, 16, 32), seed=3,
            paged=False, prefix_cache=False)
CHUNK_WAVE = dict(chunked_prefill=True, catch_chunk=6, wave_tokens=14)
B, MAX_LEN = 3, 64


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


def _bridge(arch, seed, **replace):
    jcfg = jax_smoke_config(arch).replace(dtype="float32", **replace)
    jparams = jax.jit(lambda key: JM.init_params(jcfg, key))(
        jax.random.PRNGKey(seed))
    cfg = get_smoke_config(arch).replace(dtype="float32", **replace)
    return jcfg, jparams, cfg, params_from_numpy(
        jax.tree.map(np.asarray, jparams), device="cpu")


@pytest.fixture(scope="module")
def phi3():
    return _bridge("phi3-medium-14b", 0)


@pytest.fixture(scope="module")
def gemma_deep():
    """gemma3-1b smoke at 8 layers: 2 super-blocks and 2 ``rem_local``."""
    out = _bridge("gemma3-1b", 1, num_layers=8)
    assert out[2].pattern_blocks() == (2, 2)
    return out


@pytest.fixture(scope="module")
def anchor(phi3):
    """The JAX dense fifo engine and the port's twin on the matrix's
    traffic: (JAX engine, JAX tokens, port engine, port tokens)."""
    jcfg, jparams, cfg, params = phi3
    jeng = JaxEngine(jcfg, jparams, JaxServeConfig(**BASE, policy="fifo"))
    jtok = _drain(jeng, _traffic(JaxRequest, jcfg.vocab_size))
    eng = EdgeServingEngine(cfg, params, ServeConfig(**BASE, policy="fifo"),
                            device="cpu")
    return jeng, jtok, eng, _drain(eng, _traffic(Request, cfg.vocab_size))


def _close(mine, theirs):
    """Nested dicts of tensors against JAX arrays: integer leaves equal,
    float leaves within rtol 1e-5, atol 1e-5 x max|ref|."""
    assert set(mine) == set(theirs)
    for key, leaf in mine.items():
        if isinstance(leaf, dict):
            _close(leaf, theirs[key])
            continue
        a, b = leaf.numpy(), np.asarray(theirs[key])
        assert a.shape == b.shape and a.dtype == b.dtype, key
        if a.dtype.kind in "iu":
            assert np.array_equal(a, b), key
        else:
            np.testing.assert_allclose(
                a, b, rtol=1e-5, atol=1e-5 * max(np.abs(b).max(), 1e-30))


def _logits_close(mine, theirs):
    b = np.asarray(theirs)
    np.testing.assert_allclose(mine.numpy(), b, rtol=1e-5,
                               atol=1e-5 * np.abs(b).max())


# ---------------------------------------------------------------------------
# model level
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("which", ["phi3", "gemma_deep"])
def test_dense_prefill_decode_extend_match_jax(which, request):
    """``prefill_paged(write_tables=None)`` of three ragged rows (true
    lengths 24, 17, 6) into slots 2, 0, 1 of the dense cache, one
    ``decode_step``, then ``model.extend`` of S=4 (valid_len 4, 2, 4):
    logits on the valid rows, every strip, ring and slot."""
    jcfg, jparams, cfg, params = request.getfixturevalue(which)
    rng = np.random.default_rng(6)
    tokens = rng.integers(0, cfg.vocab_size, (B, 24)).astype(np.int32)
    true_len = np.array([24, 17, 6], np.int32)
    slots = np.array([2, 0, 1], np.int32)
    jc = JM.init_cache(jcfg, B, MAX_LEN)
    c = M.init_cache(cfg, B, MAX_LEN, device="cpu")
    jlog, jc = jax.jit(lambda p_, t_, c_, s_, n_: JM.prefill_paged(
        jcfg, p_, {"tokens": t_}, MAX_LEN, c_, slots=s_, true_len=n_))(
            jparams, jnp.asarray(tokens), jc, jnp.asarray(slots),
            jnp.asarray(true_len))
    log, c = M.prefill_paged(cfg, params, {"tokens": torch.from_numpy(tokens)},
                             MAX_LEN, c, slots=torch.from_numpy(slots),
                             true_len=torch.from_numpy(true_len))
    _logits_close(log, jlog)
    _close(c, jc)

    pos = np.zeros((B,), np.int32)
    pos[slots] = true_len
    tok = rng.integers(0, cfg.vocab_size, (B, 1)).astype(np.int32)
    jlog, jc = jax.jit(lambda *a: JM.decode_step(jcfg, *a))(
        jparams, jc, jnp.asarray(tok), jnp.asarray(pos))
    log, c = M.decode_step(cfg, params, c, torch.from_numpy(tok),
                           torch.from_numpy(pos))
    _logits_close(log, jlog)

    toks = rng.integers(0, cfg.vocab_size, (B, 4)).astype(np.int32)
    valid = np.array([4, 2, 4], np.int32)
    jlog, jc = jax.jit(lambda *a: JM.extend(jcfg, *a))(
        jparams, jc, jnp.asarray(toks), jnp.asarray(pos + 1),
        jnp.asarray(valid))
    log, c = M.extend(cfg, params, c, torch.from_numpy(toks),
                      torch.from_numpy(pos + 1), torch.from_numpy(valid))
    for b in range(B):
        _logits_close(log[b, :valid[b]], np.asarray(jlog)[b, :valid[b]])
    _close(c, jc)


def test_transformer_extend_is_model_extend_and_refused_off_family(phi3):
    """``model.extend`` dispatches to ``transformer.extend`` (the same
    logits from the same cache); the recurrent families raise, as in
    JAX, where they are not ``extendable``."""
    _, _, cfg, params = phi3
    rng = np.random.default_rng(2)
    toks = torch.from_numpy(rng.integers(0, cfg.vocab_size, (2, 3))
                            .astype(np.int32))
    pos = torch.tensor([0, 5], dtype=torch.int32)
    a, _ = M.extend(cfg, params, M.init_cache(cfg, 2, 32, device="cpu"),
                    toks, pos)
    b, _ = T.extend(cfg, params, M.init_cache(cfg, 2, 32, device="cpu"),
                    toks, pos)
    assert torch.equal(a, b)
    for arch in ("mamba2-370m", "zamba2-7b"):
        with pytest.raises(NotImplementedError, match="extend"):
            M.extend(get_smoke_config(arch), {}, {}, toks, pos)


# ---------------------------------------------------------------------------
# engine level
# ---------------------------------------------------------------------------

def test_dense_twin_matches_jax_dense_engine(anchor):
    jeng, jtok, eng, tok = anchor
    assert not eng.paged and eng.pool is None and eng.prefix_cache is None
    assert len(tok) == 7 and tok == jtok
    assert eng.stats() == jeng.stats()
    assert eng.extend_waves > 0 and eng.decode_waves > 0


@pytest.mark.parametrize("case", ["phi3-chunked", "gemma-priority"])
def test_dense_twin_cases_match_jax(case, phi3, gemma_deep):
    """Chunked prompts as wave spans on phi3, and gemma's local rings
    beside dense global strips under the priority policy."""
    jcfg, jparams, cfg, params = phi3 if case.startswith("phi3") \
        else gemma_deep
    kw = dict(BASE, **(dict(policy="fifo", **CHUNK_WAVE)
                       if case == "phi3-chunked" else dict(policy="priority")))
    jeng = JaxEngine(jcfg, jparams, JaxServeConfig(**kw))
    jtok = _drain(jeng, _traffic(JaxRequest, jcfg.vocab_size))
    eng = EdgeServingEngine(cfg, params, ServeConfig(**kw), device="cpu")
    tok = _drain(eng, _traffic(Request, cfg.vocab_size))
    assert not eng.paged
    assert len(tok) == 7 and tok == jtok
    assert eng.stats() == jeng.stats()


def test_spec_on_the_dense_twin_is_vanilla(phi3, anchor):
    """Speculative verify waves on the dense strips: rejected writes
    above the frontier are masked by their slots, so greedy tokens are
    the vanilla twin's."""
    _, _, cfg, params = phi3
    eng = EdgeServingEngine(cfg, params, ServeConfig(
        **BASE, policy="edf", spec_decode=True, draft_arch="self"),
        device="cpu")
    assert _drain(eng, _traffic(Request, cfg.vocab_size)) == anchor[3]
    assert eng.spec is not None and eng.stats()["spec_rounds"] >= 1


def test_dense_twin_preempt_resume_is_exact(phi3, anchor):
    """Slots preempted after three steps take their strips with them
    (``extract_slot``) and resume (``insert_slot``) to the undisturbed
    run's tokens, their rows scribbled over meanwhile."""
    _, _, cfg, params = phi3
    eng = EdgeServingEngine(cfg, params, ServeConfig(**BASE, policy="fifo"),
                            device="cpu")
    for r in _traffic(Request, cfg.vocab_size):
        eng.submit(r)
    for _ in range(3):
        eng.drain_step()
    for slot in np.flatnonzero(eng.active):
        req = eng.preempt(int(slot))
        assert req.saved_state["cache"]["layers"]["k"].shape[1] == 1
        eng.cache["layers"]["k"][:, int(slot)] = 7.0
        eng.queue.append(req)
    eng.run_until_drained()
    assert {r.uid: tuple(r.generated) for r in eng.completed} == anchor[3]


def test_dense_twin_cancel_in_every_phase(phi3):
    """Cancel a queued request, a slot mid catch-up and a decoding slot;
    the rest finish."""
    _, _, cfg, params = phi3
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
    eng.run_until_drained()
    assert eng.cancels == len(eng.cancelled) == 3
    assert len(eng.completed) + len(eng.cancelled) == len(reqs)
    assert all(len(r.generated) == 6 for r in eng.completed)


def test_dense_twin_disarms_quant_and_launches_no_kernel(phi3, anchor,
                                                         monkeypatch):
    """``quant_kv="int8"`` is disarmed without pages, and
    ``use_pallas_paged`` routes nothing through a kernel entry point on
    the dense twin (not even a plain version), as in JAX."""
    _, _, cfg, params = phi3
    calls = []
    for name in ("paged_attention", "paged_extend_attention",
                 "flash_attention", "ssd_scan", "quant_matmul"):
        monkeypatch.setattr(ops, name,
                            lambda *a, _n=name, **k: calls.append(_n))
    for kw in (dict(quant_kv="int8"), dict(use_pallas_paged=True)):
        eng = EdgeServingEngine(cfg, params, ServeConfig(
            **BASE, policy="fifo", **kw), device="cpu")
        assert not eng.paged and not eng.quant
        assert _drain(eng, _traffic(Request, cfg.vocab_size)) == anchor[3]
        assert "quant_kv" not in eng.stats()
    assert calls == []
