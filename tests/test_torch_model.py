"""The port's dense model entry points against ``repro.models.model``
under bridged weights (phi3 smoke at float32).

``prefill_paged``, ``decode_step_paged`` (gather read, and kernel read —
the plain version on CPU tensors against the Pallas kernel in interpret
mode) and ``extend_paged`` must give the JAX logits and pools within
rtol=atol=1e-4 (the same float32 math over two layers, summed in
another order; 2e-3 against the Pallas kernel's online softmax, the
tolerance ``tests/test_kernels.py`` uses).  Decode must also reproduce
the port's own full-sequence forward over several steps.  On an int8
pool, prefill, decode and extend (gather read, and kernel read through
the plain versions) give the JAX logits within rtol=atol=1e-4 and the
same pool bytes, with scales within rtol 1e-5 (a scale is max|k| / 127,
and the two frameworks' K differ by float noise of ~1e-6 relative after
two layers).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as jax_smoke_config
from repro.models import model as JM
from repro_torch.bridge import params_from_numpy
from repro_torch.configs import get_smoke_config
from repro_torch.models import model as M

ARCH = "phi3-medium-14b"
B, T, NB, BS = 3, 64, 16, 8
N_BLK = T // BS
TOL = dict(rtol=1e-4, atol=1e-4)


@pytest.fixture(scope="module")
def models():
    jcfg = jax_smoke_config(ARCH).replace(dtype="float32")
    jparams = JM.init_params(jcfg, jax.random.PRNGKey(1))
    cfg = get_smoke_config(ARCH).replace(dtype="float32")
    params = params_from_numpy(jax.tree.map(np.asarray, jparams),
                               device="cpu")
    return jcfg, jparams, cfg, params


def _pool_close(cache, jcache, **tol):
    for key in ("k", "v"):
        np.testing.assert_allclose(cache["layers"][key].numpy(),
                                   np.asarray(jcache["layers"][key]),
                                   **(tol or TOL))


def _qpool_close(cache, jcache):
    mine, theirs = cache["layers"], jcache["layers"]
    assert set(mine) == set(theirs) == {"k", "v", "k_scale", "v_scale"}
    for key in ("k", "v"):
        assert mine[key].dtype == torch.int8
        assert np.array_equal(mine[key].numpy(), np.asarray(theirs[key]))
    for key in ("k_scale", "v_scale"):
        np.testing.assert_allclose(mine[key].numpy(), np.asarray(theirs[key]),
                                   rtol=1e-5, atol=0.0)


@pytest.fixture(scope="module")
def prefilled_int8(models):
    return _prefill(models, "int8")


@pytest.fixture(scope="module")
def prefilled(models):
    return _prefill(models, None)


def _prefill(models, kv_dtype):
    """Both models after one bucketed prefill of three ragged prompts
    (true lengths 11, 16, 5 in a 16-token bucket), into a pool of
    ``kv_dtype``."""
    jcfg, jparams, cfg, params = models
    rng = np.random.default_rng(0)
    tokens = rng.integers(0, cfg.vocab_size, (B, 16)).astype(np.int32)
    true_len = np.array([11, 16, 5], np.int32)
    tables = np.full((B, N_BLK), -1, np.int32)
    tables[0, :2], tables[1, :3], tables[2, :1] = [3, 9], [0, 12, 4], [7]
    wt = tables[:, :2].copy()
    jc = JM.init_paged_cache(jcfg, B, T, NB, BS, kv_dtype=kv_dtype)
    jlog, jc = JM.prefill_paged(jcfg, jparams, {"tokens": jnp.asarray(tokens)},
                                T, jc, slots=jnp.arange(B),
                                write_tables=jnp.asarray(wt),
                                true_len=jnp.asarray(true_len))
    c = M.init_paged_cache(cfg, B, T, NB, BS, kv_dtype=kv_dtype, device="cpu")
    log, c = M.prefill_paged(cfg, params, {"tokens": torch.from_numpy(tokens)},
                             T, c, slots=torch.arange(B),
                             write_tables=torch.from_numpy(wt),
                             true_len=torch.from_numpy(true_len))
    return dict(jlog=jlog, jc=jc, log=log, c=c, tables=tables,
                pos=true_len.copy(), rng=rng)


def _clone(cache):
    return {"layers": {k: v.clone() for k, v in cache["layers"].items()}}


def test_prefill_paged_logits_and_pool(prefilled):
    np.testing.assert_allclose(prefilled["log"].numpy(),
                               np.asarray(prefilled["jlog"]), **TOL)
    _pool_close(prefilled["c"], prefilled["jc"])


@pytest.mark.parametrize("use_pallas", [False, True])
def test_decode_step_paged(models, prefilled, use_pallas):
    jcfg, jparams, cfg, params = models
    tok = prefilled["rng"].integers(0, cfg.vocab_size, (B, 1)).astype(
        np.int32)
    pos, tables = prefilled["pos"], prefilled["tables"]
    jlog, jc = JM.decode_step_paged(jcfg, jparams, prefilled["jc"],
                                    jnp.asarray(tok), jnp.asarray(pos),
                                    jnp.asarray(tables), use_pallas)
    c = {"layers": {k: v.clone()
                    for k, v in prefilled["c"]["layers"].items()}}
    log, c2 = M.decode_step_paged(cfg, params, c, torch.from_numpy(tok),
                                  torch.from_numpy(pos),
                                  torch.from_numpy(tables), use_pallas)
    assert c2 is c                                   # updated in place
    tol = dict(rtol=2e-3, atol=2e-3) if use_pallas else TOL
    np.testing.assert_allclose(log.numpy(), np.asarray(jlog), **tol)
    _pool_close(c, jc)


def test_extend_paged(models, prefilled):
    jcfg, jparams, cfg, params = models
    S = 4
    tok = prefilled["rng"].integers(0, cfg.vocab_size, (B, S)).astype(
        np.int32)
    pos, tables = prefilled["pos"], prefilled["tables"]
    valid = np.array([4, 1, 3], np.int32)
    jlog, jc = JM.extend_paged(jcfg, jparams, prefilled["jc"],
                               jnp.asarray(tok), jnp.asarray(pos),
                               jnp.asarray(tables), jnp.asarray(valid))
    c = {"layers": {k: v.clone()
                    for k, v in prefilled["c"]["layers"].items()}}
    log, _ = M.extend_paged(cfg, params, c, torch.from_numpy(tok),
                            torch.from_numpy(pos), torch.from_numpy(tables),
                            torch.from_numpy(valid))
    for b in range(B):          # rows past valid_len are garbage on both
        np.testing.assert_allclose(log[b, :valid[b]].numpy(),
                                   np.asarray(jlog[b, :valid[b]]), **TOL)
    _pool_close(c, jc)


def test_int8_prefill_paged_logits_and_pool(prefilled_int8):
    """Cold prefill attends the float K/V and writes the int8 pool."""
    pf = prefilled_int8
    np.testing.assert_allclose(pf["log"].numpy(), np.asarray(pf["jlog"]),
                               **TOL)
    _qpool_close(pf["c"], pf["jc"])


@pytest.mark.parametrize("use_pallas", [False, True])
def test_int8_decode_step_paged(models, prefilled_int8, use_pallas):
    pf = prefilled_int8
    jcfg, jparams, cfg, params = models
    tok = np.random.default_rng(11).integers(0, cfg.vocab_size,
                                             (B, 1)).astype(np.int32)
    pos, tables = pf["pos"], pf["tables"]
    jlog, jc = JM.decode_step_paged(jcfg, jparams, pf["jc"],
                                    jnp.asarray(tok), jnp.asarray(pos),
                                    jnp.asarray(tables), use_pallas)
    c = _clone(pf["c"])
    log, _ = M.decode_step_paged(cfg, params, c, torch.from_numpy(tok),
                                 torch.from_numpy(pos),
                                 torch.from_numpy(tables), use_pallas)
    np.testing.assert_allclose(log.numpy(), np.asarray(jlog), **TOL)
    _qpool_close(c, jc)


@pytest.mark.parametrize("use_pallas", [False, True])
def test_int8_extend_paged(models, prefilled_int8, use_pallas):
    pf = prefilled_int8
    jcfg, jparams, cfg, params = models
    S = 4
    tok = np.random.default_rng(12).integers(0, cfg.vocab_size,
                                             (B, S)).astype(np.int32)
    pos, tables = pf["pos"], pf["tables"]
    valid = np.array([4, 1, 3], np.int32)
    jlog, jc = JM.extend_paged(jcfg, jparams, pf["jc"], jnp.asarray(tok),
                               jnp.asarray(pos), jnp.asarray(tables),
                               jnp.asarray(valid), use_pallas)
    c = _clone(pf["c"])
    log, _ = M.extend_paged(cfg, params, c, torch.from_numpy(tok),
                            torch.from_numpy(pos), torch.from_numpy(tables),
                            torch.from_numpy(valid), use_pallas)
    for b in range(B):          # rows past valid_len are garbage on both
        np.testing.assert_allclose(log[b, :valid[b]].numpy(),
                                   np.asarray(jlog[b, :valid[b]]), **TOL)
    _qpool_close(c, jc)


@pytest.mark.parametrize("use_pallas", [False, True])
def test_decode_matches_forward(models, use_pallas):
    """Prefill 6 tokens, then decode 5 more one at a time: every decode
    step's logits equal the full-sequence forward's at that position."""
    _, _, cfg, params = models
    rng = np.random.default_rng(3)
    seq = torch.from_numpy(rng.integers(0, cfg.vocab_size, (2, 11)).astype(
        np.int32))
    full = M.forward(cfg, params, seq)                   # (2, 11, V)
    tables = torch.tensor([[1, 4, -1, -1], [6, 2, -1, -1]], dtype=torch.int32)
    c = M.init_paged_cache(cfg, 2, 32, 8, 8, device="cpu")
    log, c = M.prefill_paged(cfg, params, {"tokens": seq[:, :6]}, 32, c,
                             slots=torch.arange(2), write_tables=tables[:, :1])
    torch.testing.assert_close(log[:, 0], full[:, 5], **TOL)
    for p in range(6, 11):
        pos = torch.full((2,), p, dtype=torch.int32)
        log, c = M.decode_step_paged(cfg, params, c, seq[:, p:p + 1], pos,
                                     tables, use_pallas)
        torch.testing.assert_close(log[:, 0], full[:, p], **TOL)


def test_init_params_matches_jax_layout(models):
    """The port's own seeded init has the JAX tree's keys and shapes, in
    ``cfg.weight_dtype``."""
    jcfg, jparams, cfg, _ = models
    mine = M.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    jflat = {jax.tree_util.keystr(k): v for k, v in
             jax.tree_util.tree_flatten_with_path(jparams)[0]}

    def flat(tree, prefix=""):
        for k, v in tree.items():
            path = f"{prefix}['{k}']"
            if isinstance(v, dict):
                yield from flat(v, path)
            else:
                yield path, v
    mflat = dict(flat(mine))
    assert mflat.keys() == jflat.keys()
    for k, v in mflat.items():
        assert tuple(v.shape) == jflat[k].shape, k
        assert v.dtype == torch.float32
    bf = M.init_params(cfg.replace(param_dtype="bfloat16"),
                       torch.Generator().manual_seed(0), "cpu")
    assert bf["trunk"]["layers"]["attn"]["wq"].dtype == torch.bfloat16
    w = mine["trunk"]["layers"]["mlp"]["w_up"]
    assert float(w.abs().max()) <= 2.0 * cfg.d_model ** -0.5 + 1e-6


@pytest.mark.parametrize("arch", ["gemma3-1b", "whisper-base",
                                  "granite-moe-1b-a400m"])
def test_unported_configs_raise(arch):
    """Unported families raise at ``init_params``; gemma's local:global
    pattern trains, evaluates and serves through the paged engine, and
    raises at the admission of the dense twin (``write_tables=None``,
    A.4)."""
    cfg = get_smoke_config(arch)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        if cfg.family == "dense":
            params = M.init_params(cfg, torch.Generator().manual_seed(0),
                                   "cpu")
            M.prefill_paged(cfg, params,
                            {"tokens": torch.zeros((1, 4), dtype=torch.int32)},
                            32, M.init_cache(cfg, 1, 32, "cpu"),
                            slots=torch.zeros((1,), dtype=torch.int32))
        else:
            M.init_params(cfg, torch.Generator().manual_seed(0), "cpu")


def test_capability_flags_match_jax():
    from repro.configs import ARCH_IDS
    for arch in ARCH_IDS:
        jcfg, cfg = jax_smoke_config(arch), get_smoke_config(arch)
        for name in ("extendable", "spec_decodable", "prefix_sharable"):
            assert getattr(M, name)(cfg) == getattr(JM, name)(jcfg), \
                (arch, name)


def test_default_device_raises_without_cuda():
    if torch.cuda.is_available():
        pytest.skip("this host has CUDA: the default device is valid")
    cfg = get_smoke_config(ARCH)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        M.init_params(cfg)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        M.init_paged_cache(cfg, 2, 32, 4, 8)


# ---------------------------------------------------------------------------
# dense decode cache (the speculative draft's)
# ---------------------------------------------------------------------------

DENSE_TOL = dict(rtol=1e-5, atol=1e-5)


def _dense_close(cache, jcache):
    assert cache.keys() == jcache.keys() == {"layers"}
    assert cache["layers"].keys() == jcache["layers"].keys()
    for key in ("k", "v"):
        np.testing.assert_allclose(cache["layers"][key].numpy(),
                                   np.asarray(jcache["layers"][key]),
                                   **DENSE_TOL)
    assert np.array_equal(cache["layers"]["slots"].numpy(),
                          np.asarray(jcache["layers"]["slots"]))


@pytest.fixture(scope="module")
def dense_prefilled(models):
    """Both models after a dense prefill of three ragged prompts (true
    lengths 11, 16, 5 right-padded to 16 tokens) into caches of T."""
    jcfg, jparams, cfg, params = models
    rng = np.random.default_rng(3)
    tokens = rng.integers(0, cfg.vocab_size, (B, 16)).astype(np.int32)
    true_len = np.array([11, 16, 5], np.int32)
    jlog, jc = JM.prefill(jcfg, jparams, {"tokens": jnp.asarray(tokens)}, T,
                          true_len=jnp.asarray(true_len))
    log, c = M.prefill(cfg, params, {"tokens": torch.from_numpy(tokens)}, T,
                       true_len=torch.from_numpy(true_len))
    return dict(tokens=tokens, true_len=true_len, jlog=jlog, jc=jc,
                log=log, c=c)


def test_init_cache_matches_jax(models):
    jcfg, _, cfg, _ = models
    mine, theirs = M.init_cache(cfg, B, T, "cpu"), JM.init_cache(jcfg, B, T)
    assert mine["layers"].keys() == theirs["layers"].keys()
    for key, leaf in mine["layers"].items():
        assert np.array_equal(leaf.numpy(), np.asarray(theirs["layers"][key]))


def test_dense_prefill_true_len_matches_jax(dense_prefilled):
    d = dense_prefilled
    assert d["log"].shape == (B, 1, d["log"].shape[-1])
    np.testing.assert_allclose(d["log"].numpy(), np.asarray(d["jlog"]),
                               **DENSE_TOL)
    _dense_close(d["c"], d["jc"])


def test_dense_decode_step_matches_jax(models, dense_prefilled):
    """Three decode steps from the prefilled caches, rows at their own
    positions (the ragged true lengths): logits and caches stay JAX's."""
    jcfg, jparams, cfg, params = models
    d = dense_prefilled
    c = {"layers": {k: v.clone() for k, v in d["c"]["layers"].items()}}
    jc = d["jc"]
    pos = d["true_len"].copy()
    rng = np.random.default_rng(4)
    for _ in range(3):
        tok = rng.integers(0, cfg.vocab_size, (B, 1)).astype(np.int32)
        jlog, jc = JM.decode_step(jcfg, jparams, jc, jnp.asarray(tok),
                                  jnp.asarray(pos))
        log, ret = M.decode_step(cfg, params, c, torch.from_numpy(tok),
                                 torch.from_numpy(pos))
        assert ret is c
        np.testing.assert_allclose(log.numpy(), np.asarray(jlog),
                                   **DENSE_TOL)
        pos += 1
    _dense_close(c, jc)


def test_dense_decode_after_prefill_equals_forward(models):
    """Prefill a 6-token prompt, then decode 4 tokens one at a time: each
    step's logits are the full-sequence forward's at that position."""
    _, _, cfg, params = models
    rng = np.random.default_rng(5)
    seq = torch.from_numpy(
        rng.integers(0, cfg.vocab_size, (2, 10)).astype(np.int32))
    full = M.forward(cfg, params, seq)
    log, c = M.prefill(cfg, params, {"tokens": seq[:, :6]}, T)
    np.testing.assert_allclose(log[:, 0].numpy(), full[:, 5].numpy(),
                               **DENSE_TOL)
    for i in range(6, 10):
        log, c = M.decode_step(cfg, params, c, seq[:, i:i + 1],
                               torch.full((2,), i, dtype=torch.int32))
        np.testing.assert_allclose(log[:, 0].numpy(), full[:, i].numpy(),
                                   **DENSE_TOL)


def test_dense_cache_of_a_local_ring_config_raises():
    """A ring config's dense cache is ported (the speculative draft's):
    rings of W = min(window, max_len) beside the global strips, as JAX
    lays them out.  The dense twin engine built on it (``paged=False``)
    still raises (ROADMAP A.4)."""
    cfg = get_smoke_config("gemma3-1b")
    jc = JM.init_cache(jax_smoke_config("gemma3-1b"), 2, 32)
    c = M.init_cache(cfg, 2, 32, "cpu")
    assert jax.tree.map(lambda a: a.shape, jc) == {
        k: {kk: {kkk: tuple(t.shape) for kkk, t in vv.items()}
            for kk, vv in v.items()} for k, v in c.items()}
    assert c["super"]["local"]["k"].shape[-3] == min(cfg.local_window, 32)
    from repro_torch.serving import EdgeServingEngine, ServeConfig
    params = M.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        EdgeServingEngine(cfg, params, ServeConfig(prefix_cache=False,
                                                   paged=False), device="cpu")


def test_scatter_cache_rows_matches_jax(models, dense_prefilled):
    """Prefilled rows scattered into a 4-slot dense cache at slots
    2, 0, 3 (in place on the port's side)."""
    from repro.models import transformer as JT
    from repro_torch.models import transformer as PT
    jcfg, _, cfg, _ = models
    d = dense_prefilled
    slots = np.array([2, 0, 3], np.int32)
    full = M.init_cache(cfg, 4, T, "cpu")
    ret = PT.scatter_cache_rows(full, d["c"], torch.from_numpy(slots), 1)
    theirs = JT.scatter_cache_rows(JM.init_cache(jcfg, 4, T), d["jc"],
                                   jnp.asarray(slots), 1)
    assert ret is full
    _dense_close(full, theirs)
    assert (full["layers"]["slots"][:, 1] == -1).all()
