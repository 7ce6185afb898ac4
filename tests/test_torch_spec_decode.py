"""Speculative decoding in the port (``repro_torch.serving.spec_decode``
and the engine's ``spec`` waves) against the JAX package.

The traffic of ``tests/test_engine_matrix.py::_traffic`` replays through
the port's engine and the JAX paged engine on the phi3 smoke config at
float32 with bridged weights (``max_slots=3``, ``max_len=96``, buckets
8/16/32, seed 3, no prefix cache on either side).  Greedy speculative
tokens must equal the JAX dense vanilla engine's token for token (the
verify model alone decides them), and the spec counters must equal the
JAX spec engine's: the draft proposes the same tokens on both sides.
An int8 pool is held to the JAX int8 gate (every first token but at
most one equal, longest common prefix >= 60% of the tokens) and to the
JAX int8 spec engine's tokens and counters.  With ``quant_draft`` the
explicit draft is the verify model itself, quantized to int8 by the
engine, so proposals are mostly accepted and the counters say
something; on CPU tensors its projections run the float32 dequant
product, the JAX package's branch off the TPU.
"""
import dataclasses
import json
import sys

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
from repro_torch.serving import EdgeServingEngine, Request, ServeConfig
from repro_torch.serving.spec_decode import (accept_proposals,
                                             make_self_draft,
                                             processed_dist, validate_spec)

ARCH = "phi3-medium-14b"
BASE = dict(max_slots=3, max_len=96, prefill_buckets=(8, 16, 32), seed=3,
            prefix_cache=False)
SPEC = dict(BASE, spec_decode=True)
# name -> (ServeConfig fields, explicit draft: None or "verify")
CASES = {
    "self-fifo": (dict(policy="fifo", draft_arch="self"), None),
    "self-edf": (dict(policy="edf", draft_arch="self"), None),
    "self-fifo-kernel": (dict(policy="fifo", draft_arch="self",
                              use_pallas_paged=True), None),
    "self-edf-kernel": (dict(policy="edf", draft_arch="self",
                             use_pallas_paged=True), None),
    "quant-draft": (dict(policy="fifo", quant_draft=True), "verify"),
    "int8-quant-draft-kernel": (dict(policy="priority", quant_kv="int8",
                                     quant_draft=True,
                                     use_pallas_paged=True), "verify"),
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


@pytest.fixture(scope="module")
def reference(models):
    """The JAX dense vanilla engine's greedy tokens on the traffic."""
    jcfg, jparams, _, _ = models
    ref = JaxEngine(jcfg, jparams, JaxServeConfig(
        **dict(BASE, paged=False, policy="fifo")))
    tokens = _drain(ref, _traffic(JaxRequest, jcfg.vocab_size))
    assert len(tokens) == 7
    return tokens


@pytest.fixture(scope="module", params=list(CASES))
def replay(request, models):
    """(case, JAX spec engine, JAX tokens, port spec engine, tokens)."""
    jcfg, jparams, cfg, params = models
    kw, draft = CASES[request.param]
    kw = dict(SPEC, **kw)
    jeng = JaxEngine(jcfg, jparams, JaxServeConfig(**kw),
                     draft=(jcfg, jparams) if draft else None)
    jtok = _drain(jeng, _traffic(JaxRequest, jcfg.vocab_size))
    eng = EdgeServingEngine(cfg, params, ServeConfig(**kw), device="cpu",
                            draft=(cfg, params) if draft else None)
    tok = _drain(eng, _traffic(Request, cfg.vocab_size))
    return request.param, jeng, jtok, eng, tok


def test_spec_greedy_tokens_match_dense_vanilla(replay, reference):
    case, _, _, eng, tok = replay
    assert eng.spec is not None
    if not eng.quant:
        assert tok == reference, f"token drift vs dense vanilla ({case})"
        return
    # the JAX package's int8 gate (tests/test_engine_matrix.py)
    assert set(tok) == set(reference)
    first = sum(tok[u][0] == reference[u][0] for u in reference)
    lcp = total = 0
    for u in reference:
        assert len(tok[u]) == len(reference[u])
        total += len(reference[u])
        for a, b in zip(tok[u], reference[u]):
            if a != b:
                break
            lcp += 1
    assert first >= len(reference) - 1, (first, tok)
    assert lcp >= 0.6 * total, (lcp, total)


def test_spec_tokens_and_stats_match_jax_engine(replay):
    """Same tokens and the same ``stats()``: spec rounds, proposed and
    accepted counts, peaks and pool gauges."""
    case, jeng, jtok, eng, tok = replay
    assert tok == jtok, case
    stats = eng.stats()
    assert stats == jeng.stats(), case
    assert stats["spec_active"] is True and stats["spec_rounds"] >= 1
    assert stats["spec_proposed"] >= stats["spec_rounds"]
    if CASES[case][1] == "verify":
        assert stats["quant_draft"] is True
        assert stats["spec_accepted"] > stats["spec_proposed"] // 2, stats


def test_spec_pool_consistent_and_no_leak(replay):
    _, _, _, eng, _ = replay
    eng.pool.assert_consistent()
    assert eng.pool.num_free == eng.pool.num_blocks
    assert not eng.active.any() and not eng.queue
    assert (eng.block_tables == -1).all()
    assert eng.extend_waves == eng.steps and eng.decode_waves == 0


def test_quant_draft_greedy_is_bit_exact(models, reference):
    """``test_engine_matrix.test_quant_draft_greedy_is_bit_exact`` on the
    port: a gemma3-1b registry draft (local rings beside global strips,
    its dense cache through ``init_cache`` / ``prefill`` /
    ``decode_step``) with int8 projection weights changes proposals
    only; the phi3 verify model decides every token, so the tokens are
    the dense vanilla engine's."""
    _, _, cfg, params = models
    eng = EdgeServingEngine(cfg, params, ServeConfig(**dict(
        SPEC, policy="fifo", draft_arch="gemma3-1b", quant_draft=True)),
        device="cpu")
    assert eng.spec.cfg.pattern_period > 1
    assert set(eng.spec.cache) == {"super"}
    got = _drain(eng, _traffic(Request, cfg.vocab_size))
    assert got == reference, "quantized draft leaked into verify output"
    stats = eng.stats()
    assert stats["quant_draft"] is True and stats["spec_rounds"] >= 1


# ---------------------------------------------------------------------------
# draft construction and validation
# ---------------------------------------------------------------------------

def test_self_draft_shares_the_trunk_storage(models):
    _, _, cfg, params = models
    dcfg, dparams = make_self_draft(cfg, params)
    assert dcfg.num_layers == cfg.num_layers // 2
    assert dcfg.name == f"{cfg.name}-selfdraft@{dcfg.num_layers}"

    def leaves(tree):
        for v in tree.values():
            yield from (leaves(v) if isinstance(v, dict) else [v])
    for key in ("trunk", "embed", "unembed"):
        for a, b in zip(leaves(dparams[key]), leaves(params[key])):
            assert a.data_ptr() == b.data_ptr(), key
    assert torch.equal(dparams["final_norm"]["scale"],
                       torch.zeros(cfg.d_model))
    eng = EdgeServingEngine(cfg, params, ServeConfig(**SPEC), device="cpu")
    assert eng.spec.params["trunk"]["layers"]["attn"]["wq"].data_ptr() == \
        params["trunk"]["layers"]["attn"]["wq"].data_ptr()
    with pytest.raises(ValueError, match="self-draft"):
        make_self_draft(get_smoke_config("gemma3-1b"), params)
    with pytest.raises(ValueError, match="exit_layers"):
        make_self_draft(cfg, params, exit_layers=cfg.num_layers)


def test_validate_spec_findings(models):
    jcfg, _, cfg, _ = models
    assert validate_spec(cfg, cfg, 4, 96) == []
    other = cfg.replace(vocab_size=256)
    found = validate_spec(cfg, other, 4, 96)
    assert len(found) == 1 and "vocab mismatch" in found[0]
    assert any("spec_gamma" in p for p in validate_spec(cfg, cfg, 1, 96))
    assert any("spec_gamma" in p for p in validate_spec(cfg, cfg, 25, 96))
    ring = get_smoke_config("gemma3-1b")
    assert any("spec_decodable" in p
               for p in validate_spec(ring, ring, 4, 96))
    from repro.serving.spec_decode import validate_spec as jax_validate
    for d, g in ((cfg, 4), (other, 4), (cfg, 1), (cfg, 25)):
        jd = jcfg.replace(vocab_size=d.vocab_size)
        assert validate_spec(cfg, d, g, 96) == jax_validate(jcfg, jd, g, 96)


def test_quant_draft_config_errors(models):
    """``tests/test_engine_matrix.py::test_quant_config_validation``'s
    draft cases, and the spec misconfigurations."""
    _, _, cfg, params = models
    with pytest.raises(ValueError, match="quant_draft"):
        EdgeServingEngine(cfg, params, ServeConfig(
            **SPEC, draft_arch="self", quant_draft=True), device="cpu")
    with pytest.raises(ValueError, match="quant_draft"):
        EdgeServingEngine(cfg, params, ServeConfig(**BASE, quant_draft=True),
                          device="cpu")
    with pytest.raises(ValueError, match="vocab mismatch"):
        EdgeServingEngine(cfg, params, ServeConfig(**SPEC), device="cpu",
                          draft=(cfg.replace(vocab_size=256), params))
    with pytest.raises(ValueError, match="spec_gamma"):
        EdgeServingEngine(cfg, params, ServeConfig(**dict(SPEC,
                                                          spec_gamma=1)),
                          device="cpu")


def test_quant_draft_quantizes_only_the_draft(models):
    _, _, cfg, params = models
    eng = EdgeServingEngine(cfg, params, ServeConfig(**SPEC,
                                                     quant_draft=True),
                            device="cpu", draft=(cfg, params))
    layers = eng.spec.params["trunk"]["layers"]
    for blk, name in (("attn", "wq"), ("attn", "wo"), ("mlp", "w_down")):
        leaf = layers[blk][name]
        assert leaf["q"].dtype == torch.int8
        assert leaf["q"].shape == params["trunk"]["layers"][blk][name].shape
    assert eng.spec.params["embed"]["table"] is params["embed"]["table"]
    assert not isinstance(params["trunk"]["layers"]["attn"]["wq"], dict)
    assert eng.params is params


def test_registry_draft_is_drawn_from_the_seed(models):
    _, _, cfg, params = models

    def draft_wq(seed):
        eng = EdgeServingEngine(cfg, params, ServeConfig(
            **dict(SPEC, seed=seed), draft_arch=ARCH), device="cpu")
        return eng.spec.params["trunk"]["layers"]["attn"]["wq"]
    a, b, c = draft_wq(3), draft_wq(3), draft_wq(4)
    assert torch.equal(a, b) and not torch.equal(a, c)
    assert not torch.equal(a, params["trunk"]["layers"]["attn"]["wq"])


# ---------------------------------------------------------------------------
# acceptance rules (ports of tests/test_spec_decode.py)
# ---------------------------------------------------------------------------

def test_accept_proposals_rules():
    """Greedy exact-match prefix + correction; rejection sampling emits
    from the residual and a clean sweep emits the bonus."""
    V = 8
    lg = np.full((3, V), -10.0, np.float32)
    lg[0, 2] = lg[1, 5] = lg[2, 1] = 10.0      # argmax: 2, 5, 1
    rng = np.random.default_rng(0)
    n, emitted = accept_proposals([2, 5], [None, None], lg, 0.0, 0, rng)
    assert (n, emitted) == (2, [2, 5, 1])
    n, emitted = accept_proposals([3, 5], [None, None], lg, 0.0, 0, rng)
    assert (n, emitted) == (0, [2])
    q_target = np.zeros(V)
    q_target[4] = 1.0
    p_draft = np.zeros(V)
    p_draft[0] = 1.0
    lg2 = np.log(np.maximum(q_target, 1e-9))[None, :].repeat(2, axis=0)
    n, emitted = accept_proposals([0], [p_draft], lg2, 1.0, 0, rng)
    assert (n, emitted) == (0, [4])
    n, emitted = accept_proposals([4], [q_target], lg2, 1.0, 0, rng)
    assert n == 1 and emitted[0] == 4 and len(emitted) == 2


def test_rejection_sampling_emits_target_distribution():
    """Whatever the draft proposes, the first emitted token is
    distributed as vanilla sampling from the verify distribution
    (Monte-Carlo with a deliberately mismatched draft)."""
    rng = np.random.default_rng(0)
    V, temp = 16, 1.0
    verify_logits = rng.normal(0, 2.0, (2, V)).astype(np.float32)
    q = processed_dist(verify_logits[0], temp, 0)
    p = processed_dist(rng.normal(0, 2.0, V).astype(np.float32), temp, 0)
    counts = np.zeros(V)
    n_trials = 20_000
    for _ in range(n_trials):
        d = int(rng.choice(V, p=p))
        _, emitted = accept_proposals([d], [p], verify_logits, temp, 0, rng)
        counts[emitted[0]] += 1
    tv = 0.5 * np.abs(counts / n_trials - q).sum()
    assert tv < 0.03, tv


# ---------------------------------------------------------------------------
# engine: preemption, rollback, sampling, CLI
# ---------------------------------------------------------------------------

def _reqs(cfg, lens, max_new=8, seed=7):
    rng = np.random.default_rng(seed)
    return [Request(uid=i, prompt=rng.integers(0, cfg.vocab_size, n,
                                               dtype=np.int32),
                    max_new_tokens=max_new)
            for i, n in enumerate(lens)]


def test_spec_preempt_resume_exact(models):
    """Preempting a speculating slot carries a copy of its draft row;
    resume continues token for token (the identity draft keeps
    acceptance high, so full sweeps cross the preemption)."""
    _, _, cfg, params = models
    scfg = ServeConfig(max_slots=1, max_len=96, prefill_buckets=(8, 16),
                       prefix_cache=False, spec_decode=True, spec_gamma=4)
    base = _drain(EdgeServingEngine(cfg, params, scfg, device="cpu",
                                    draft=(cfg, params)),
                  _reqs(cfg, (9,), max_new=12))[0]
    eng = EdgeServingEngine(cfg, params, scfg, device="cpu",
                            draft=(cfg, params))
    req = _reqs(cfg, (9,), max_new=12)[0]
    eng.submit(req)
    eng.step()
    eng.step()
    row = eng.spec.cache["layers"]["k"][:, 0].clone()
    r = eng.preempt(0)
    assert r.saved_state is not None and "draft" in r.saved_state
    saved = r.saved_state["draft"]
    assert torch.equal(saved["cache"]["layers"]["k"][:, 0], row)
    eng.spec.cache["layers"]["k"].zero_()     # the row is reused meanwhile
    eng.submit(r)
    done = eng.run_until_drained()
    assert tuple(done[-1].generated) == base
    assert eng.stats()["spec_accepted"] > 0


def test_spec_rejection_rollback_leaks_nothing(models):
    """A draft of unrelated random weights (the registry config drawn
    from the seed) rejects nearly every proposal: every round allocates
    verify-span pages and rolls them back.  Tokens stay the vanilla
    engine's and every page returns to the pool."""
    _, _, cfg, params = models
    scfg = dict(BASE, policy="fifo", spec_gamma=4)
    lens = (5, 9, 13, 21, 33, 7)
    vanilla = _drain(EdgeServingEngine(cfg, params, ServeConfig(**scfg),
                                       device="cpu"), _reqs(cfg, lens))
    eng = EdgeServingEngine(cfg, params, ServeConfig(
        **scfg, spec_decode=True, draft_arch=ARCH), device="cpu")
    assert _drain(eng, _reqs(cfg, lens)) == vanilla
    st = eng.stats()
    assert st["spec_rounds"] > 0
    assert st["spec_accepted"] < st["spec_proposed"] // 2
    assert eng.pool.num_free == eng.pool.num_blocks
    assert all(not b for b in eng.slot_blocks)


def test_spec_sampling_is_seeded_and_in_vocab(models):
    """At temperature > 0 the rejection-sampling rule runs (draft
    distributions and verify logits on the host): seeded, in vocabulary,
    every budget met."""
    _, _, cfg, params = models
    kw = dict(SPEC, policy="fifo", temperature=0.9, top_k=7)
    runs = []
    for _ in range(2):
        eng = EdgeServingEngine(cfg, params, ServeConfig(**kw), device="cpu")
        runs.append(_drain(eng, _traffic(Request, cfg.vocab_size)))
        assert eng.stats()["spec_rounds"] >= 1
    assert runs[0] == runs[1]
    assert all(0 <= t < cfg.vocab_size and len(v) == 6
               for v in runs[0].values() for t in v)


def test_serve_config_spec_fields_are_ported():
    fields = {f.name for f in dataclasses.fields(ServeConfig)}
    assert {"spec_decode", "draft_arch", "quant_draft"} <= fields
    ServeConfig(prefix_cache=False, spec_decode=True, draft_arch="self",
                quant_draft=True)            # the engine validates


def test_cli_spec_flags(monkeypatch, capsys):
    from repro_torch.launch import serve
    monkeypatch.setattr(sys, "argv", [
        "serve", "--arch", "phi3-medium-14b", "--device", "cpu",
        "--requests", "3", "--max-new", "5", "--max-prompt", "20", "--spec",
        "--draft", "self", "--gamma", "3"])
    serve.main()
    out = json.loads(capsys.readouterr().out.strip().splitlines()[0])
    assert out["requests"] == 3 and out["tokens"] == 15
    assert out["spec_active"] is True
    assert 0.0 <= out["spec_accept_rate"] <= 1.0
    assert out["spec_tokens_per_step"] >= 1.0
