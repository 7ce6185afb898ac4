"""The port's hybrid slice (zamba2: mamba blocks and one shared attention
block) against ``repro.models.hybrid`` and the JAX engine's pool-free
path, under bridged weights: the zamba2-7b smoke config (6 layers at
period 3: two super-blocks, no remainder) and its 7-layer variant (one
``rem_mamba`` block), both at float32.

Tolerances: the port and JAX run the same float32 math summed in
another order, so logits and states are held at rtol=1e-5 and atol=1e-5
x the largest |value| of the JAX side; ring slots are equal.  The
engine's greedy tokens and ``stats()`` must equal the JAX engine's
exactly (the same schedule; at float32 no argmax lands on a near-tie),
and its tokens must equal JAX's single-request reference decode on the
5/17/33-token prompts of ``tests/test_decode_consistency.py`` (which
holds the JAX engine to it in bfloat16).  The hand kernels' plain
versions run here; the kernels themselves are held on the card.
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
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import ssd_scan as ssd
from repro_torch.models import model as M
from repro_torch.serving import EdgeServingEngine, Request, ServeConfig
from repro_torch.serving.engine import cache_batch_axes, extract_slot, \
    insert_slot
import test_decode_consistency

ARCH = "zamba2-7b"
REL = 1e-5
MAX_LEN = 64
# the JAX model's entry points, compiled once each (config and max_len
# static) rather than dispatched op by op
J_APPLY = jax.jit(JM.apply, static_argnums=(0,))
J_PREFILL = jax.jit(JM.prefill, static_argnums=(0, 3))
J_DECODE = jax.jit(JM.decode_step, static_argnums=(0,))
J_PREFILL_PAGED = jax.jit(JM.prefill_paged, static_argnums=(0, 3))


def _t(a):
    return torch.from_numpy(np.asarray(a))


def _close(mine, theirs):
    """rtol 1e-5, atol 1e-5 x max |theirs| (ints: equal)."""
    theirs = np.asarray(theirs)
    mine = mine.detach().cpu()
    if not np.issubdtype(theirs.dtype, np.floating):
        np.testing.assert_array_equal(mine.numpy(), theirs)
        return
    theirs = theirs.astype(np.float32)
    scale = max(float(np.abs(theirs).max()), 1e-30)
    np.testing.assert_allclose(mine.float().numpy(), theirs, rtol=REL,
                               atol=REL * scale)


def _close_tree(mine, theirs):
    assert set(mine) == set(theirs)
    for k, v in mine.items():
        if isinstance(v, dict):
            _close_tree(v, theirs[k])
        else:
            assert tuple(v.shape) == tuple(theirs[k].shape), k
            _close(v, theirs[k])


@pytest.fixture(scope="module", params=[6, 7], ids=["6-layer", "7-layer"])
def models(request):
    """(jcfg, jparams, cfg, params): the smoke config (6 layers) or its
    7-layer variant, JAX weights bridged into the port."""
    n = request.param
    jcfg = jax_smoke_config(ARCH).replace(dtype="float32", num_layers=n)
    jparams = JM.init_params(jcfg, jax.random.PRNGKey(0))
    cfg = get_smoke_config(ARCH).replace(dtype="float32", num_layers=n)
    params = params_from_numpy(jax.tree.map(np.asarray, jparams),
                               device="cpu")
    return jcfg, jparams, cfg, params


def test_init_params_keep_the_jax_layout(models):
    jcfg, jparams, cfg, params = models
    mine = M.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    flat = jax.tree_util.tree_flatten_with_path(jparams)[0]
    want = {jax.tree_util.keystr(p): tuple(v.shape) for p, v in flat}

    def walk(tree, prefix=""):
        for k, v in tree.items():
            key = f"{prefix}['{k}']"
            if isinstance(v, dict):
                yield from walk(v, key)
            else:
                yield key, tuple(v.shape)
    assert dict(walk(mine)) == want
    assert ("rem_mamba" in mine) == (cfg.num_layers % 3 != 0)
    assert mine["mamba"]["A_log"].shape[:2] == (2, 2)


def test_bf16_weights_keep_the_float32_leaves(models):
    """Bridged at bfloat16 and drawn at bfloat16, the mamba blocks'
    ``A_log``, ``D``, ``dt_bias`` and every norm scale stay float32 (the
    JAX model keeps them so); projections take the weight dtype."""
    jcfg, jparams, cfg, _ = models
    bridged = params_from_numpy(jax.tree.map(np.asarray, jparams),
                                device="cpu", dtype=torch.bfloat16)
    drawn = M.init_params(cfg.replace(param_dtype="bfloat16"),
                          torch.Generator().manual_seed(0), "cpu")
    for p in (bridged, drawn):
        for part in ("mamba",) + (("rem_mamba",) if "rem_mamba" in p
                                  else ()):
            for k in ("A_log", "D", "dt_bias"):
                assert p[part][k].dtype == torch.float32, (part, k)
            for k in ("gate_norm", "ln"):
                assert p[part][k]["scale"].dtype == torch.float32
            assert p[part]["in_proj"].dtype == torch.bfloat16
        assert p["shared_attn"]["ln1"]["scale"].dtype == torch.float32
        assert p["final_norm"]["scale"].dtype == torch.float32
        assert p["shared_attn"]["attn"]["wq"].dtype == torch.bfloat16


@pytest.mark.parametrize("use_flash,use_kernel", [(False, False),
                                                  (True, True)],
                         ids=["plain", "kernels"])
def test_forward_and_apply_match_jax(models, use_flash, use_kernel):
    """Full-sequence logits of 20 tokens (past the 16-token window: the
    forward attends full-causal, as JAX's does)."""
    jcfg, jparams, cfg, params = models
    tok = np.random.default_rng(0).integers(
        0, cfg.vocab_size, (2, 20)).astype(np.int32)
    want, _ = J_APPLY(jcfg, jparams, {"tokens": jnp.asarray(tok)})
    got, aux = M.apply(cfg, params, {"tokens": _t(tok)},
                       use_flash=use_flash, use_kernel=use_kernel)
    _close(got, want)
    assert float(aux) == 0.0


@pytest.mark.parametrize("ragged", [False, True], ids=["full", "true_len"])
def test_prefill_logits_states_and_rings_match_jax(models, ragged):
    """A 24-token bucket (past the 16-entry ring, so it wraps) with and
    without ``true_len`` (24, 11, 1): last-true-token logits, every mamba
    state (conv, ssm) and every application's ring (k, v, slots)."""
    jcfg, jparams, cfg, params = models
    rng = np.random.default_rng(1)
    tok = rng.integers(0, cfg.vocab_size, (3, 24)).astype(np.int32)
    tl = np.array([24, 11, 1], np.int32) if ragged else None
    logits, cache = M.prefill(cfg, params, {"tokens": _t(tok)}, MAX_LEN,
                              true_len=None if tl is None else _t(tl))
    jlogits, jcache = J_PREFILL(jcfg, jparams, {"tokens": jnp.asarray(tok)},
                                MAX_LEN, true_len=None if tl is None
                                else jnp.asarray(tl))
    _close(logits, jlogits)
    _close_tree(cache, jcache)
    assert cache["attn"]["k"].shape[2] == min(MAX_LEN, cfg.local_window)


def test_three_decode_steps_match_jax(models):
    """Prefill 14 tokens, decode 3 (positions 14-16: the last wraps the
    ring): each step's logits and the final states and rings."""
    jcfg, jparams, cfg, params = models
    tok = np.random.default_rng(2).integers(
        0, cfg.vocab_size, (2, 17)).astype(np.int32)
    _, cache = M.prefill(cfg, params, {"tokens": _t(tok[:, :14])}, MAX_LEN)
    _, jcache = J_PREFILL(jcfg, jparams,
                          {"tokens": jnp.asarray(tok[:, :14])}, MAX_LEN)
    for i in range(14, 17):
        pos = np.full((2,), i, np.int32)
        logits, out = M.decode_step(cfg, params, cache, _t(tok[:, i:i + 1]),
                                    _t(pos))
        jlogits, jcache = J_DECODE(jcfg, jparams, jcache,
                                   jnp.asarray(tok[:, i:i + 1]),
                                   jnp.asarray(pos))
        assert out is cache
        _close(logits, jlogits)
    _close_tree(cache, jcache)


def test_prefill_paged_writes_rows_at_slots(models):
    """Two ragged rows into slots 3 and 1 of a 4-slot cache: the rows
    equal JAX's, the other slots stay empty, and tables are refused."""
    jcfg, jparams, cfg, params = models
    rng = np.random.default_rng(3)
    tok = rng.integers(0, cfg.vocab_size, (2, 24)).astype(np.int32)
    tl = np.array([24, 9], np.int32)
    slots = np.array([3, 1], np.int32)
    cache = M.init_paged_cache(cfg, 4, MAX_LEN, 8, 16, device="cpu")
    jcache = JM.init_paged_cache(jcfg, 4, MAX_LEN, 8, 16)
    logits, out = M.prefill_paged(cfg, params, {"tokens": _t(tok)}, MAX_LEN,
                                  cache, slots=_t(slots), true_len=_t(tl),
                                  use_flash=True, use_kernel=True)
    jlogits, jout = J_PREFILL_PAGED(jcfg, jparams,
                                    {"tokens": jnp.asarray(tok)}, MAX_LEN,
                                    jcache, slots=jnp.asarray(slots),
                                    true_len=jnp.asarray(tl))
    assert out is cache
    _close(logits, jlogits)
    _close_tree(out, jout)
    assert not out["mamba"]["ssm"][:, :, [0, 2]].any()
    assert bool((out["attn"]["slots"][:, [0, 2]] == -1).all())
    with pytest.raises(ValueError, match="no paged KV"):
        M.prefill_paged(cfg, params, {"tokens": _t(tok)}, MAX_LEN, cache,
                        slots=_t(slots), write_tables=_t(slots[:, None]))


def test_extend_raises_and_batch_axes_carry_a_row(models):
    """No multi-token extend (recurrent state), as in JAX; the engine's
    batch axes (mamba at 2, rings at 1, ``rem_mamba`` at 1) carry a row
    through an extract / insert round trip (preemption)."""
    _, _, cfg, params = models
    cache = M.init_paged_cache(cfg, 3, MAX_LEN, 8, 16, device="cpu")
    with pytest.raises(NotImplementedError, match="cannot roll back"):
        M.extend_paged(cfg, params, cache,
                       torch.zeros((3, 2), dtype=torch.int32),
                       torch.zeros(3, dtype=torch.int32), None)
    assert not (M.extendable(cfg) or M.spec_decodable(cfg)
                or M.prefix_sharable(cfg))
    axes = cache_batch_axes(cfg, MAX_LEN)
    want = {"mamba": dict(conv=2, ssm=2), "attn": dict(k=1, v=1, slots=1)}
    if cfg.num_layers % 3:
        want["rem_mamba"] = dict(conv=1, ssm=1)
    assert axes == want
    gen = torch.Generator().manual_seed(0)
    for leaf in (cache["mamba"]["ssm"], cache["attn"]["k"]):
        leaf.normal_(generator=gen)
    cache["attn"]["slots"].random_(0, 50, generator=gen)
    row = extract_slot(cache, 1, axes)
    other = M.init_paged_cache(cfg, 3, MAX_LEN, 8, 16, device="cpu")
    insert_slot(other, row, 2, axes)
    assert torch.equal(other["attn"]["k"][:, 2], cache["attn"]["k"][:, 1])
    assert torch.equal(other["mamba"]["ssm"][:, :, 2],
                       cache["mamba"]["ssm"][:, :, 1])


# ---------------------------------------------------------------------------
# the engine's pool-free path against the JAX engine
# ---------------------------------------------------------------------------

BASE = dict(max_slots=3, max_len=96, prefill_buckets=(16, 32), seed=3,
            prefix_cache=False)


def _prompts(vocab):
    """Prompt lengths around the 16/32 buckets, two past the largest
    (47 and 70 tokens catch up through decode waves and wrap the
    16-entry rings)."""
    rng = np.random.default_rng(42)
    return [rng.integers(0, vocab, n, dtype=np.int32)
            for n in (25, 5, 32, 47, 3, 70, 12)]


def _traffic(request_cls, vocab):
    return [request_cls(uid=uid, prompt=p, max_new_tokens=6,
                        priority=uid % 3, deadline=float(uid))
            for uid, p in enumerate(_prompts(vocab))]


def _drain(eng, reqs):
    for r in reqs:
        eng.submit(r)
    eng.run_until_drained()
    return {r.uid: tuple(r.generated) for r in eng.completed}


@pytest.fixture(scope="module", params=["fifo", "priority"])
def replay(request, models):
    """The JAX engine and the port's on one policy's traffic:
    (policy, jax engine, jax tokens, engine, tokens)."""
    jcfg, jparams, cfg, params = models
    policy = request.param
    jeng = JaxEngine(jcfg, jparams, JaxServeConfig(**BASE, policy=policy))
    jtok = _drain(jeng, _traffic(JaxRequest, jcfg.vocab_size))
    eng = EdgeServingEngine(cfg, params, ServeConfig(**BASE, policy=policy),
                            device="cpu")
    return policy, jeng, jtok, eng, _drain(eng, _traffic(Request,
                                                         cfg.vocab_size))


def test_hybrid_engine_tokens_match_jax(replay):
    policy, _, jtok, _, tok = replay
    assert len(tok) == 7 and all(len(v) == 6 for v in tok.values())
    assert tok == jtok, f"token drift vs the JAX pool-free engine ({policy})"


def test_hybrid_engine_stats_match_jax(replay):
    """Same keys (no pool gauges) and values; catch-up rode the decode
    waves."""
    policy, jeng, _, eng, _ = replay
    assert not jeng.paged and not eng.paged and eng.pool is None
    stats = eng.stats()
    assert stats == jeng.stats(), policy
    assert "pool_blocks" not in stats and stats["mixed_waves"] > 0
    assert eng.decode_waves == eng.steps and eng.extend_waves == 0


class _JittedModel:
    """``repro.models.model``'s prefill and decode_step, jitted."""
    prefill = staticmethod(J_PREFILL)
    decode_step = staticmethod(J_DECODE)


def test_hybrid_engine_matches_reference_decode(models, monkeypatch):
    """The red test's traffic (prompts of 5, 17 and 33 tokens, buckets 8
    and 16, so 17 and 33 catch up) at float32: every request's tokens
    equal JAX's single-request reference decode
    (``test_decode_consistency._reference_decode``, its model calls
    jitted)."""
    jcfg, jparams, cfg, params = models
    monkeypatch.setattr(test_decode_consistency, "M", _JittedModel())
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
        want = test_decode_consistency._reference_decode(
            jcfg, jparams, r.prompt, 6, {}, 96)
        assert list(r.generated) == want, len(r.prompt)


@pytest.fixture(scope="module")
def fifo_tokens(models):
    """The undisturbed fifo run's tokens, shared by the tests below."""
    _, _, cfg, params = models
    return _drain(EdgeServingEngine(cfg, params, ServeConfig(
        **BASE, policy="fifo"), device="cpu"),
        _traffic(Request, cfg.vocab_size))


def test_hybrid_engine_hand_kernel_switch_and_int8(models, fifo_tokens):
    """``use_pallas_paged=True`` on CPU tensors (the kernels' plain
    versions, no launch) serves the same tokens; ``quant_kv="int8"`` is
    disarmed (no pages) and ``spec_decode`` ignored, as for ssm."""
    _, _, cfg, params = models
    tok = fifo_tokens
    fa.launches = ssd.launches = 0
    for kw in (dict(use_pallas_paged=True), dict(quant_kv="int8"),
               dict(spec_decode=True)):
        eng = EdgeServingEngine(cfg, params, ServeConfig(
            **BASE, policy="fifo", **kw), device="cpu")
        assert not eng.paged and not eng.quant and eng.spec is None
        assert _drain(eng, _traffic(Request, cfg.vocab_size)) == tok, kw
    assert fa.launches == ssd.launches == 0


def test_hybrid_preempt_resume_is_exact(models, fifo_tokens):
    """Slots preempted after three steps (mid catch-up and mid decode)
    take their states and rings with them and resume to the undisturbed
    run's tokens."""
    _, _, cfg, params = models
    tok = fifo_tokens
    eng = EdgeServingEngine(cfg, params, ServeConfig(**BASE, policy="fifo"),
                            device="cpu")
    for r in _traffic(Request, cfg.vocab_size):
        eng.submit(r)
    for _ in range(3):
        eng.drain_step()
    for slot in np.flatnonzero(eng.active):
        req = eng.preempt(int(slot))
        assert req.saved_state["cache"]["attn"]["k"].shape[1] == 1
        eng.cache["attn"]["k"][:, int(slot)] = 7.0     # the slot is reused
        eng.cache["mamba"]["ssm"][:, :, int(slot)] = 7.0
        eng.queue.append(req)
    eng.run_until_drained()
    assert {r.uid: tuple(r.generated) for r in eng.completed} == tok


def test_serve_cli_serves_the_hybrid(capsys):
    """``launch.serve --arch zamba2-7b --scale smoke`` drains through the
    pool-free engine; prompts past the largest bucket (128) catch up."""
    from repro_torch.launch import serve
    _, eng = serve.build_engine(ARCH, "smoke", dict(max_slots=2),
                                device="cpu")
    assert not eng.paged and eng.cfg.family == "hybrid"
    serve.main(["--arch", ARCH, "--device", "cpu", "--requests", "3",
                "--max-new", "3", "--min-prompt", "100", "--max-prompt",
                "140", "--max-len", "192"])
    out = capsys.readouterr().out.strip().splitlines()[0]
    assert '"requests": 3' in out and '"tokens": 9' in out
