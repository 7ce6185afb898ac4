"""``tests/test_engine_matrix.py``'s cross product on the port.

The JAX matrix replays one mixed trace (shared-prefix families, one
ending mid-page, a bucket-aligned prompt, a long catch-up prompt)
through every ``paged x prefix_cache x spec_decode x use_pallas_paged x
policy`` combination and holds each to the dense vanilla engine token
for token.  Here the same combinations run on the port's engine on the
phi3 smoke config at float32 (random weights of the port's own; no JAX
engine runs) and are held to the port's dense vanilla engine — which
``tests/test_torch_dense_twin.py`` holds to the JAX dense engine, and
``tests/test_torch_prefix_cache.py`` the port's prefix engine to the
JAX prefix engine.  Every paged run drains with zero leaked pages
(every page free or held by the radix cache).  The chunked axis (prompts
as wave spans under a token budget) is held to the chunked dense
vanilla engine, and the int8 axis to the JAX file's LCP / first-token
gate.  On the CPU, ``use_pallas_paged`` runs the kernels' plain
versions and launches nothing.
"""
import numpy as np
import pytest
import torch

from repro_torch.configs import get_smoke_config
from repro_torch.kernels import ops
from repro_torch.kernels import paged_attention as pa
from repro_torch.kernels import paged_extend_attention as pea
from repro_torch.models import model as M
from repro_torch.serving import EdgeServingEngine, Request, ServeConfig

# The port's CPU tests run small tensors: one intra-op thread a process
# runs them fastest, and under the suite's parallel workers (one process
# each, every one of which imports this module while it collects) more
# threads a worker only contend for the cores.
torch.set_num_threads(1)

ARCH = "phi3-medium-14b"
BASE = dict(max_slots=3, max_len=96, prefill_buckets=(8, 16, 32), seed=3)
# (paged, prefix_cache, spec_decode, use_pallas_paged, policy), as in
# tests/test_engine_matrix.py
COMBOS = [
    (True,  False, False, False, "fifo"),
    (True,  True,  False, False, "priority"),
    (True,  True,  True,  False, "edf"),
    (True,  False, True,  True,  "fifo"),
    (True,  True,  True,  True,  "priority"),
    (True,  True,  False, True,  "edf"),
    (False, True,  True,  False, "edf"),      # dense twin: cache no-ops
    (False, False, False, False, "priority"),
]
CHUNK_WAVE = dict(chunked_prefill=True, catch_chunk=6, wave_tokens=14)
# (prefix, spec, pallas, policy) of the JAX file's int8 axis
QUANT_COMBOS = [
    (True, False, True, "edf"),
    (True, True, False, "priority"),
]


def _traffic(vocab):
    rng = np.random.default_rng(42)
    sys_a = rng.integers(0, vocab, 21, dtype=np.int32)   # mid-page prefix
    sys_b = rng.integers(0, vocab, 16, dtype=np.int32)   # page-aligned
    prompts = [
        np.concatenate([sys_a, rng.integers(0, vocab, 4, dtype=np.int32)]),
        np.concatenate([sys_a, rng.integers(0, vocab, 7, dtype=np.int32)]),
        np.concatenate([sys_b, rng.integers(0, vocab, 3, dtype=np.int32)]),
        np.concatenate([sys_b, rng.integers(0, vocab, 9, dtype=np.int32)]),
        rng.integers(0, vocab, 5, dtype=np.int32),       # tiny
        rng.integers(0, vocab, 32, dtype=np.int32),      # largest bucket
        rng.integers(0, vocab, 47, dtype=np.int32),      # chunked catch-up
    ]
    return [Request(uid=uid, prompt=p, max_new_tokens=6,
                    priority=uid % 3, deadline=float(uid))
            for uid, p in enumerate(prompts)]


def _run(cfg, params, **kw):
    eng = EdgeServingEngine(cfg, params, ServeConfig(**BASE, **kw),
                            device="cpu")
    for r in _traffic(cfg.vocab_size):
        eng.submit(r)
    eng.run_until_drained()   # drain_step checks the pool after each step
    return eng, {r.uid: tuple(r.generated) for r in eng.completed}


@pytest.fixture(scope="module")
def setup():
    cfg = get_smoke_config(ARCH).replace(dtype="float32")
    params = M.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    refs = {}
    for name, kw in (("plain", {}), ("chunked", CHUNK_WAVE)):
        eng, ref = _run(cfg, params, paged=False, prefix_cache=False,
                        policy="fifo", **kw)
        assert len(ref) == 7 and not eng.paged
        refs[name] = ref
    return cfg, params, refs


def _check(eng, paged, prefix, spec):
    stats = eng.stats()
    assert stats["steps"] > 0
    if paged:
        cached = eng.prefix_cache.num_blocks if eng.prefix_cache else 0
        assert eng.pool.num_free + cached == eng.pool.num_blocks
        if prefix:
            assert eng.sharable and stats["prefix_hits"] >= 1, stats
    else:
        assert eng.prefix_cache is None and eng.pool is None
    if spec:
        assert eng.spec is not None and stats["spec_rounds"] >= 1, stats
    return stats


@pytest.mark.parametrize("paged,prefix,spec,pallas,policy", COMBOS)
def test_feature_combo_matches_dense_vanilla(setup, paged, prefix, spec,
                                             pallas, policy):
    cfg, params, refs = setup
    eng, got = _run(cfg, params, paged=paged, prefix_cache=prefix,
                    spec_decode=spec, draft_arch="self",
                    use_pallas_paged=pallas, policy=policy)
    assert got == refs["plain"], (paged, prefix, spec, pallas, policy)
    _check(eng, paged, prefix, spec)


@pytest.mark.parametrize("paged,prefix,spec,pallas,policy", COMBOS)
def test_chunked_combo_matches_chunked_dense_vanilla(setup, paged, prefix,
                                                     spec, pallas, policy):
    """The same combinations with prompts admitted as wave spans beside
    decoding slots under a shared per-wave token budget."""
    cfg, params, refs = setup
    eng, got = _run(cfg, params, paged=paged, prefix_cache=prefix,
                    spec_decode=spec, draft_arch="self",
                    use_pallas_paged=pallas, policy=policy, **CHUNK_WAVE)
    assert got == refs["chunked"], (paged, prefix, spec, pallas, policy)
    stats = _check(eng, paged, prefix, spec)
    assert stats["wave_admitted"] >= 1 and stats["mixed_waves"] >= 1


@pytest.mark.parametrize("prefix,spec,pallas,policy", QUANT_COMBOS)
def test_int8_combo_tracks_dense_vanilla(setup, prefix, spec, pallas,
                                         policy):
    """int8 pages are not bit-exact against the float strips: every
    request's first token equal but at most one, and a longest common
    prefix of at least 60% of the tokens (the JAX file's gate)."""
    cfg, params, refs = setup
    eng, got = _run(cfg, params, quant_kv="int8", prefix_cache=prefix,
                    spec_decode=spec, draft_arch="self",
                    use_pallas_paged=pallas, policy=policy)
    ref = refs["plain"]
    assert eng.quant and set(got) == set(ref)
    first = sum(ref[u][0] == got[u][0] for u in ref)
    lcp = total = 0
    for u in ref:
        assert len(got[u]) == len(ref[u])
        total += len(ref[u])
        for a, b in zip(ref[u], got[u]):
            if a != b:
                break
            lcp += 1
    assert first >= len(ref) - 1 and lcp >= 0.6 * total, (first, lcp, total)
    stats = _check(eng, True, prefix, spec)
    assert stats["quant_kv"] == "int8"


def test_pallas_flag_runs_the_plain_versions_on_cpu(setup, monkeypatch):
    """``use_pallas_paged`` on CPU tensors: the decode read and (on an
    int8 pool) the extend read go through ``kernels.ops`` to the plain
    versions — called, and no kernel launched."""
    cfg, params, refs = setup
    calls = {"paged_attention": 0, "paged_extend_attention": 0}
    for name in calls:
        real = getattr(ops, name)

        def counted(*a, _n=name, _real=real, **k):
            calls[_n] += 1
            assert a[0].device.type == "cpu"
            return _real(*a, **k)
        monkeypatch.setattr(ops, name, counted)
    pa.launches = pea.launches = 0
    eng, got = _run(cfg, params, use_pallas_paged=True, quant_kv="int8",
                    policy="fifo")
    L = cfg.num_layers
    assert calls == {"paged_attention": L * eng.decode_waves,
                     "paged_extend_attention": L * eng.extend_waves}
    assert eng.decode_waves and eng.extend_waves
    assert pa.launches == pea.launches == 0
    assert set(got) == set(refs["plain"])
